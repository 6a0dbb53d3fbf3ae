"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]. First layer dense (d_ff 12288), 59 MLA+MoE layers.
"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig

ARCH = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,  # routed-expert hidden dim (assignment spec)
    vocab=102400,
    layout=(("mla_dense", 1), ("mla_moe", 59)),
    norm="rmsnorm",
    mlp="swiglu",
    pos="rope",
    rope_theta=10_000.0,
    dense_d_ff=12288,
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    source="arXiv:2405.04434",
)

SMOKE = ARCH.scaled(
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab=512,
    layout=(("mla_dense", 1), ("mla_moe", 2)),
    dense_d_ff=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=64, n_shared=1),
    mla=MLAConfig(
        q_lora_rank=64,
        kv_lora_rank=32,
        qk_nope_head_dim=32,
        qk_rope_head_dim=16,
        v_head_dim=32,
    ),
)
