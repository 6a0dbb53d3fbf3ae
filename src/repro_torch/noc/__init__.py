"""Network-on-chip simulation for the DPM port: configuration, workloads,
the host event-ordered simulator (``WormholeSim``) with its telemetry and
the closed calibration loop, the batched xsim engine, and ML-workload
trace replay through both engines. Twin of ``repro.noc``.
"""
from .config import DEST_RANGES, EnergyModel, NoCConfig
from .simulator import SimStats, WormholeSim
from .telemetry import (
    CalibrationResult,
    LatencyHistogram,
    MeasuredContentionCost,
    MeasuredEnergyCost,
    Telemetry,
    calibrate_cost_model,
    fit_energy_cost,
    link_coords,
    link_index,
)
from .traffic import (
    PARSEC_PROFILES,
    Request,
    Workload,
    latency_vs_rate,
    parsec_workload,
    simulate,
    synthetic_workload,
)
from .trace import (
    ReplayResult,
    Trace,
    TraceEvent,
    TracePhase,
    cross_validate,
    export_timeline,
    replay_host,
    replay_xsim,
)
from .xsim import XSimResults, latency_vs_rate_batched, xsimulate

__all__ = [
    "CalibrationResult",
    "DEST_RANGES",
    "EnergyModel",
    "LatencyHistogram",
    "MeasuredContentionCost",
    "MeasuredEnergyCost",
    "NoCConfig",
    "PARSEC_PROFILES",
    "ReplayResult",
    "Request",
    "SimStats",
    "Telemetry",
    "Trace",
    "TraceEvent",
    "TracePhase",
    "WormholeSim",
    "Workload",
    "XSimResults",
    "calibrate_cost_model",
    "cross_validate",
    "export_timeline",
    "fit_energy_cost",
    "latency_vs_rate",
    "latency_vs_rate_batched",
    "link_coords",
    "link_index",
    "parsec_workload",
    "replay_host",
    "replay_xsim",
    "simulate",
    "synthetic_workload",
    "xsimulate",
]
