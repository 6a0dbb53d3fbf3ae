"""Architecture + shape configuration dataclasses. Twin of
``repro.models.config``, copied (pure Python).

One ``ArchConfig`` covers the 10 assigned architectures: dense llama-style,
MoE (DeepSeek-V2 MLA / Moonlight), SSM (Mamba-2 SSD), hybrid (Hymba), audio
(MusicGen backbone) and VLM (Qwen2-VL backbone). Layer stacks are described
as ``layout`` groups of (block_kind, count); each group's weights are
stacked on a leading "layers" dim, as in the reference. The port serves
every kind; ``use_pallas`` is not read (the kernels are chosen by the
tensors' device).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer stack: ordered groups of (block_kind, count); kinds:
    #   attn_dense  — GQA attention + dense MLP
    #   attn_moe    — GQA attention + MoE FFN
    #   mla_dense   — MLA attention + dense MLP
    #   mla_moe     — MLA attention + MoE FFN
    #   ssd         — Mamba-2 SSD block (attention-free)
    #   hymba_g     — parallel (global attention || SSM heads) + MLP
    #   hymba_w     — parallel (sliding-window attention || SSM heads) + MLP
    layout: tuple[tuple[str, int], ...] = ()
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    pos: str = "rope"  # rope | mrope | sinusoidal | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    window: int = 1024  # sliding-window size for *_w blocks
    embed_input: str = "tokens"  # tokens | frames (precomputed embeddings stub)
    tie_embeddings: bool = False
    dense_d_ff: int | None = None  # d_ff of dense layers in mostly-MoE stacks
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # notes for DESIGN.md §Arch-applicability
    source: str = ""
    sub_quadratic: bool = False  # can run long_500k decode

    def __post_init__(self):
        total = sum(c for _, c in self.layout)
        if total != self.n_layers:
            raise ValueError(f"{self.name}: layout sums to {total} != {self.n_layers}")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def scaled(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    """Execution-level knobs (independent of the architecture)."""

    params_dtype: str = "bfloat16"
    activations_dtype: str = "bfloat16"
    remat: str = "block"  # none | block | full
    attn_chunk_q: int = 512  # chunked-attention block sizes (jnp path)
    attn_chunk_k: int = 1024
    use_pallas: bool = False  # TPU target only; CPU dry-run uses jnp path
    attn_stream_bf16: bool = False  # bf16 HBM<->MXU tiles, f32 accumulate
    ssd_stream_bf16: bool = False  # same for the SSD dual-form matrices
    norm_stats_only_f32: bool = False  # fused-norm style: f32 stats, bf16 ops
    ssd_chunk: int | None = None  # override SSMConfig.chunk (intra-chunk L)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8
    seq_shard: bool = False  # sequence-parallel residual stream (SP)
    zero1: bool = True  # shard optimizer state over the data axis
    grad_compress: str = "none"  # none | int8
    moe_impl: str = "dense"  # dense | ep (dist.ep under a shardctx mesh)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    z_loss: float = 1e-4
    vocab_round: int = 128  # pad vocab to a multiple (MXU alignment / TP)
