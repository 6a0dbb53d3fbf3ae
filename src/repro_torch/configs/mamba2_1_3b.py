"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]. d_inner = 2*d_model = 4096, 64 heads of dim 64,
state 128, conv 4. No FFN sublayer (d_ff = 0 per the assignment).
"""
from ..models.config import ArchConfig, SSMConfig

ARCH = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,  # SSD heads (d_inner / head_dim); no attention heads
    n_kv_heads=64,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    layout=(("ssd", 48),),
    norm="rmsnorm",
    pos="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
    source="arXiv:2405.21060",
)

SMOKE = ARCH.scaled(
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    head_dim=32,
    vocab=512,
    layout=(("ssd", 3),),
    ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=32, chunk=32),
)
