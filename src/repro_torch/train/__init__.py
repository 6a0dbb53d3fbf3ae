"""Training substrate: optimizer, train step, data pipeline, loop. Twin
of ``repro.train``."""
from .data import DataConfig, FileCorpus, Prefetcher, synthetic_batch
from .loop import LoopConfig, LoopResult, train
from .optim import (
    TrainState, adamw_update, clip_by_global_norm, cosine_lr, global_norm,
    init_state,
)
from .step import build_train_step, cast_params

__all__ = [
    "DataConfig", "FileCorpus", "LoopConfig", "LoopResult", "Prefetcher",
    "TrainState", "adamw_update", "build_train_step", "cast_params",
    "clip_by_global_norm", "cosine_lr", "global_norm",
    "init_state", "synthetic_batch", "train",
]
