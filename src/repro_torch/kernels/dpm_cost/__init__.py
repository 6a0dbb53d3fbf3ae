"""DPM candidate cost tables and batched Algorithm 1 planning.

Three-file pattern, as in ``repro.kernels.dpm_cost``: ``ref.py`` holds the
plain PyTorch cost tables (the CPU path and the kernels' oracle),
``dpm_cost.py`` loads and launches the CUDA kernels in ``csrc/dpm_cost.cu``,
``ops.py`` dispatches by the device of the tensors and adds the greedy merge
and the batched planner's full-objective ``dpm_plan_exact``.
"""
from .dpm_cost import (
    CANDS, KERNEL, VARIANTS, dpm_cost_table, dpm_cost_table_weighted,
)
from .ops import (
    NO_ORDER,
    dpm_plan,
    dpm_plan_exact,
    dpm_plan_topo,
    dpm_plan_weighted,
    partition_membership,
    snake_labels,
    total_plan_cost,
)
from .ref import dpm_cost_table_ref, dpm_cost_table_weighted_ref

__all__ = [
    "CANDS", "KERNEL", "NO_ORDER", "VARIANTS", "dpm_cost_table",
    "dpm_cost_table_ref",
    "dpm_cost_table_weighted", "dpm_cost_table_weighted_ref", "dpm_plan",
    "dpm_plan_exact", "dpm_plan_topo", "dpm_plan_weighted",
    "partition_membership", "snake_labels", "total_plan_cost",
]
