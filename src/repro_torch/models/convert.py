"""Carry the reference's parameters into the port.

``params_from_jax`` takes ``repro``'s parameter tree with numpy arrays as
leaves (``jax.tree.map(np.asarray, params)``) and returns the port's tree
on ``device``. The two trees have the same keys, shapes and layouts (dense
weights ``(in, out)``, each group ``g{i}`` stacked on a leading layer dim),
so the conversion is a checked copy; a key or shape that differs raises.
The copy keeps the reference's f32 leaves for any ``run``: every run
computes on them, and an f32 run on them is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ArchConfig, RunConfig
from .layers import Params
from .model import model_init


def _convert(np_tree, like, device, path: str):
    if isinstance(like, dict):
        if not isinstance(np_tree, dict) or set(np_tree) != set(like):
            got = sorted(np_tree) if isinstance(np_tree, dict) else np_tree
            raise ValueError(f"{path or 'params'}: keys {got}, the port's "
                             f"{sorted(like)}")
        return {k: _convert(np_tree[k], like[k], device, f"{path}/{k}")
                for k in like}
    a = np.asarray(np_tree)
    if a.shape != tuple(like.shape):
        raise ValueError(f"{path}: shape {a.shape}, the port's "
                         f"{tuple(like.shape)}")
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_params: dict, cfg: ArchConfig, run: RunConfig,
                    device: torch.device | str = "cuda") -> Params:
    """The port's parameters, equal to ``np_params`` leaf by leaf."""
    dev = resolve_device(device)
    like, _ = model_init(0, cfg, run, device="meta")
    return _convert(np_params, like, dev, "")
