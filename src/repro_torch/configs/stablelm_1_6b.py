"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

Fidelity note: StableLM-2 applies RoPE to 25 % of head dims; we apply full
RoPE (backbone-level simplification recorded in DESIGN.md).
"""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    layout=(("attn_dense", 24),),
    norm="layernorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=320,
    vocab=512,
    layout=(("attn_dense", 2),),
)
