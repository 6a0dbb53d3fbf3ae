"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from ..models.config import ArchConfig

ARCH = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    layout=(("attn_dense", 30),),
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = ARCH.scaled(
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    layout=(("attn_dense", 3),),
)
