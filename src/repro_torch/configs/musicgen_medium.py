"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. Backbone only: the EnCodec frontend is a stub —
input_specs() provides precomputed frame embeddings (B, S, d_model); the
LM head predicts one 2048-way codebook (assignment spec vocab).
"""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    layout=(("attn_dense", 48),),
    norm="layernorm",
    mlp="gelu",
    pos="sinusoidal",
    embed_input="frames",
    source="arXiv:2306.05284",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=256,
    layout=(("attn_dense", 2),),
)
