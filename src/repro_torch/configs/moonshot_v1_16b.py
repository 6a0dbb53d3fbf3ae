"""moonshot-v1-16b-a3b [moe] — 64 routed experts top-6
[hf:moonshotai/Moonlight-16B-A3B].
"""
from ..models.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert hidden dim (assignment spec)
    vocab=163840,
    layout=(("attn_moe", 48),),
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=50_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ARCH.scaled(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab=512,
    layout=(("attn_moe", 2),),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1),
)
