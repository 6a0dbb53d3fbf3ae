"""Architecture registry of the port. Twin of ``repro.configs``.

The port serves all ten of the reference's configurations: ``hymba-1.5b``
(every layer runs attention and SSD heads in parallel), ``mamba2-1.3b``
(SSD only), the dense attention models ``smollm-135m``, ``stablelm-1.6b``,
``starcoder2-7b`` and ``qwen1.5-32b``, the Mixture-of-Experts models
``moonshot-v1-16b-a3b`` and ``deepseek-v2-236b`` (multi-head latent
attention, MLA), and the frame-input backbones ``musicgen-medium``
(sinusoidal positions) and ``qwen2-vl-72b`` (M-RoPE positions).
"""
from ..models.config import SHAPES, ArchConfig, ShapeConfig
from . import (
    deepseek_v2_236b,
    hymba_1_5b,
    mamba2_1_3b,
    moonshot_v1_16b,
    musicgen_medium,
    qwen1_5_32b,
    qwen2_vl_72b,
    smollm_135m,
    stablelm_1_6b,
    starcoder2_7b,
)

_MODULES = [
    hymba_1_5b,
    deepseek_v2_236b,
    moonshot_v1_16b,
    smollm_135m,
    stablelm_1_6b,
    starcoder2_7b,
    qwen1_5_32b,
    mamba2_1_3b,
    musicgen_medium,
    qwen2_vl_72b,
]

ARCHS: dict[str, ArchConfig] = {m.ARCH.name: m.ARCH for m in _MODULES}
SMOKES: dict[str, ArchConfig] = {m.ARCH.name: m.SMOKE for m in _MODULES}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str | None = None) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, with long_500k restricted to
    sub-quadratic archs (full-attention skips recorded by the caller)."""
    out = []
    for a, cfg in ARCHS.items():
        if arch and a != arch:
            continue
        for s in SHAPES:
            if s == "long_500k" and not cfg.sub_quadratic:
                continue
            out.append((a, s))
    return out


__all__ = ["ARCHS", "SHAPES", "SMOKES", "cells", "get_arch", "get_shape"]
