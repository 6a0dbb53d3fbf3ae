"""Segmented-min arbitration: the per-resource minimum age key.

Three-file pattern, as in ``repro.kernels.noc_step``: ``ref.py`` holds the
plain PyTorch scatter-min (the CPU path and the kernel's oracle),
``noc_step.py`` loads and launches the CUDA kernels in ``csrc/noc_step.cu``
(routes ``grid``, the default, and ``atomic``, the first kernel pair; the
fused winner test ``arbitrate_kernel``), ``ops.py`` dispatches by device.
"""
from .noc_step import (
    KERNEL,
    NOC_INF,
    VARIANTS,
    arbitrate_kernel,
    segmented_min,
)
from .ops import arbitrate, segmin
from .ref import segmented_min_ref

__all__ = ["KERNEL", "NOC_INF", "VARIANTS", "arbitrate", "arbitrate_kernel",
           "segmented_min", "segmented_min_ref", "segmin"]
