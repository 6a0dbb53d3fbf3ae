"""Model substrate for serving: layers, GQA and MLA attention, SSD, MoE,
blocks, LM. Twin of ``repro.models`` (the serving path; training comes with
a later slice)."""
from .config import (
    SHAPES,
    ArchConfig,
    MLAConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
)
from .convert import params_from_jax
from .layers import count_params
from .model import (
    decode_step,
    init_caches,
    model_init,
    padded_vocab,
    prefill,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "MLAConfig",
    "MoEConfig",
    "RunConfig",
    "SSMConfig",
    "ShapeConfig",
    "count_params",
    "decode_step",
    "init_caches",
    "model_init",
    "padded_vocab",
    "params_from_jax",
    "prefill",
]
