"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Layout: 3 global-attention layers (first / middle / last) with
sliding-window hybrid layers elsewhere, per the Hymba recipe. Meta-token
prefix is a frontend-level feature and is stubbed out (DESIGN.md).
sub_quadratic=True: SWA caches are O(window) and the SSM state is O(1), so
long_500k decode runs (the 3 global layers keep full KV).
"""
from ..models.config import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    layout=(
        ("hymba_g", 1),
        ("hymba_w", 14),
        ("hymba_g", 1),
        ("hymba_w", 15),
        ("hymba_g", 1),
    ),
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=10_000.0,
    window=1024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
    source="arXiv:2411.13676",
)

SMOKE = ARCH.scaled(
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    window=64,
    layout=(("hymba_g", 1), ("hymba_w", 2), ("hymba_g", 1)),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
)
