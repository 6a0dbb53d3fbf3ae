"""Distribution layer: collective scheduling on accelerator interconnects.
Twin of ``repro.dist`` on ``torch.distributed``.

``multicast`` turns the paper's DPM partitioning into a round-based
store-and-forward scheduler for torus/ring collectives, and its executors
run a schedule's rounds as ``batch_isend_irecv`` on one axis of a
``DeviceMesh``; the remaining submodules are the model-side consumers:

* ``sharding``  — logical-axis -> mesh-axis rule tables and the
  spec/tree/param/ZeRO-1 spec builders, with DTensor placements;
* ``ep``        — expert-parallel MoE whose all-to-all dispatch and
  combine ride DPM-planned rounds;
* ``pipeline``  — GPipe microbatch pipeline over a ``pipe`` mesh axis with
  shift-round stage handoffs;
* ``compress``  — int8 reduce-scatter + all-gather gradient all-reduce
  with error feedback.

The functions take rank-local tensors, a ``DeviceMesh`` and an axis name
where the reference runs inside ``shard_map`` over a named axis; rank
``i`` of a schedule is coordinate ``i`` along that axis. The spec trees
come from the models' ``*_init`` (``models.model.abstract_init``); their
consumers are ``launch.specs``, ZeRO-1 training
(``train.optim.DataParallel``) and the elastic re-shard of
``ckpt.restore``.
"""
from .compress import compressed_psum
from .ep import moe_apply_ep
from .multicast import (
    Schedule,
    Torus,
    alltoall_schedule,
    apply_alltoall_schedule,
    apply_schedule,
    dp_broadcast_schedule,
    plan_torus_multicast,
    ring_alltoall_schedule,
    ring_broadcast_schedule,
    schedule_multicasts,
)
from .pipeline import pipeline_apply
from .sharding import (
    CACHE_RULES,
    DEFAULT_RULES,
    SEQ_RULES,
    abstract_mesh,
    param_shardings,
    spec_for_shape,
    to_placements,
    tree_shardings,
    zero1_shardings,
)

__all__ = [
    "CACHE_RULES",
    "DEFAULT_RULES",
    "SEQ_RULES",
    "Schedule",
    "Torus",
    "abstract_mesh",
    "alltoall_schedule",
    "apply_alltoall_schedule",
    "apply_schedule",
    "compressed_psum",
    "dp_broadcast_schedule",
    "moe_apply_ep",
    "param_shardings",
    "pipeline_apply",
    "plan_torus_multicast",
    "ring_alltoall_schedule",
    "ring_broadcast_schedule",
    "schedule_multicasts",
    "spec_for_shape",
    "to_placements",
    "tree_shardings",
    "zero1_shardings",
]
