"""xsim's per-cycle engine — the fused ``kernels.noc_cycle`` cycle.

Twin of ``repro.noc.xsim.step``. State lives in packed router-centric
planes (per-(link, VC) FIFO ownership plus NI lane fronts); see
``kernels/noc_cycle/ref.py`` for the layout. The engine is chosen by the
device of the traffic tensors: the plain PyTorch cycle on the CPU, the CUDA
kernel on the card.

This module keeps the xsim-side surface: ``CTR`` counter names and the
``run_cycles`` entry point the batch runner calls.
"""
from __future__ import annotations

from ...kernels.noc_cycle import (  # noqa: F401  (re-exports)
    CTR,
    CycleState,
    cycle_core,
    init_planes,
    run_cycles,
)

__all__ = ["CTR", "CycleState", "cycle_core", "init_planes", "run_cycles"]
