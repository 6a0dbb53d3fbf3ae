"""Model substrate for training and serving: layers, GQA and MLA
attention, SSD, MoE, blocks, LM. Twin of ``repro.models``."""
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
    abstract_init,
    decode_step,
    forward,
    init_caches,
    loss_fn,
    make_train_step,
    model_init,
    padded_vocab,
    prefill,
    value_and_grad,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "MLAConfig",
    "MoEConfig",
    "RunConfig",
    "SSMConfig",
    "ShapeConfig",
    "abstract_init",
    "count_params",
    "decode_step",
    "forward",
    "init_caches",
    "loss_fn",
    "make_train_step",
    "model_init",
    "padded_vocab",
    "params_from_jax",
    "prefill",
    "value_and_grad",
]
