"""ML-workload trace capture and replay through both NoC simulators.

Twin of ``repro.noc.trace``. ``ir`` defines the phase-barrier trace IR
(JSON round-trippable); ``lower`` captures traces from the system's
communication shapes (collective schedules, GPipe handoffs, int8
all-reduce, HLO collective mixes) plus coherence/serving generators;
``replay`` drives both engines with barrier semantics and cross-validates
them.
"""
from .ir import Trace, TraceEvent, TracePhase, phase, trace
from .lower import (
    coherence_trace,
    compressed_allreduce_trace,
    ep_dispatch_trace,
    from_hlo,
    from_schedule,
    model_collective_mix,
    pipeline_trace,
    serving_trace,
    zero1_gather_trace,
)
from .replay import (
    DEFAULT_FLIT_BYTES,
    DEFAULT_MAX_FLITS,
    ReplayResult,
    cross_validate,
    export_timeline,
    flits_for_bytes,
    replay_host,
    replay_xsim,
)

__all__ = [
    "DEFAULT_FLIT_BYTES",
    "DEFAULT_MAX_FLITS",
    "ReplayResult",
    "Trace",
    "TraceEvent",
    "TracePhase",
    "coherence_trace",
    "compressed_allreduce_trace",
    "cross_validate",
    "ep_dispatch_trace",
    "export_timeline",
    "flits_for_bytes",
    "from_hlo",
    "from_schedule",
    "model_collective_mix",
    "phase",
    "pipeline_trace",
    "replay_host",
    "replay_xsim",
    "serving_trace",
    "trace",
    "zero1_gather_trace",
]
