"""qwen1.5-32b [dense] — MHA with QKV bias [hf:Qwen/Qwen1.5-32B]."""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    layout=(("attn_dense", 64),),
    norm="rmsnorm",
    mlp="swiglu",
    qkv_bias=True,
    pos="rope",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-32B",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=384,
    vocab=512,
    layout=(("attn_dense", 2),),
)
