"""Distribution layer: collective scheduling on accelerator interconnects.

Twin of ``repro.dist``, as far as the port goes: ``multicast`` turns the
paper's DPM partitioning into a round-based store-and-forward scheduler
for torus/ring collectives (``Schedule``, ``schedule_multicasts``, the
broadcast and all-to-all schedules). The reference's ppermute executors
(``apply_schedule``, ``apply_alltoall_schedule``) and its model-side
consumers (``sharding``, ``ep``, ``pipeline``, ``compress``) wait for
ROADMAP.md queue 1 item 5, where they become ``torch.distributed`` rounds.
"""
from .multicast import (
    Schedule,
    Torus,
    alltoall_schedule,
    dp_broadcast_schedule,
    plan_torus_multicast,
    ring_alltoall_schedule,
    ring_broadcast_schedule,
    schedule_multicasts,
)

__all__ = [
    "Schedule",
    "Torus",
    "alltoall_schedule",
    "dp_broadcast_schedule",
    "plan_torus_multicast",
    "ring_alltoall_schedule",
    "ring_broadcast_schedule",
    "schedule_multicasts",
]
