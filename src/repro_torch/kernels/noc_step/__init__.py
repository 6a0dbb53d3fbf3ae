"""Segmented-min arbitration: the per-resource minimum age key.

Three-file pattern, as in ``repro.kernels.noc_step``: ``ref.py`` holds the
plain PyTorch scatter-min (the CPU path and the kernel's oracle),
``noc_step.py`` loads and launches the CUDA kernel in ``csrc/noc_step.cu``,
``ops.py`` dispatches by device and derives winner masks.
"""
from .noc_step import KERNEL, NOC_INF, segmented_min
from .ops import arbitrate, segmin
from .ref import segmented_min_ref

__all__ = ["KERNEL", "NOC_INF", "arbitrate", "segmented_min",
           "segmented_min_ref", "segmin"]
