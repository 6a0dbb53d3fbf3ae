"""Fused wormhole-cycle kernel: the whole xsim step as one CUDA launch.

Three-file pattern, as in ``repro.kernels.noc_cycle``: ``ref.py`` is the
plain PyTorch cycle over packed router-centric planes (the CPU path and the
kernel's oracle), ``noc_cycle.py`` loads and launches the CUDA kernel in
``csrc/noc_cycle.cu``, ``ops.py`` dispatches by the device of the tensors.
"""
from .noc_cycle import KERNEL, VARIANTS, run_cycles_cuda
from .ops import run_cycles
from .ref import (
    CTR,
    NOC_INF,
    TABLE_FIELDS,
    CycleState,
    cycle_core,
    geometry_tensors,
    init_planes,
    run_cycles_ref,
)

__all__ = [
    "CTR", "CycleState", "KERNEL", "NOC_INF", "TABLE_FIELDS", "VARIANTS",
    "cycle_core",
    "geometry_tensors", "init_planes", "run_cycles", "run_cycles_cuda",
    "run_cycles_ref",
]
