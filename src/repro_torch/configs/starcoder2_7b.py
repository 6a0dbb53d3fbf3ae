"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173]."""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    layout=(("attn_dense", 32),),
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    pos="rope",
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab=512,
    layout=(("attn_dense", 2),),
)
