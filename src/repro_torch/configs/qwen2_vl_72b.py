"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only: the vision tower is a stub — input_specs() provides
precomputed patch/text embeddings (B, S, d_model). M-RoPE uses equal
(t, h, w) position ids for the text-only stand-in.
"""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    layout=(("attn_dense", 80),),
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    pos="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    embed_input="frames",
    source="arXiv:2409.12191",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    mrope_sections=(6, 5, 5),
    layout=(("attn_dense", 2),),
)
