"""Network-on-chip simulation for the DPM port: configuration, workloads,
the host event-ordered simulator (``WormholeSim``) with its telemetry, and
the batched xsim engine. Twin of ``repro.noc``; trace replay and the
telemetry calibration loop come with a later slice.
"""
from .config import DEST_RANGES, EnergyModel, NoCConfig
from .simulator import SimStats, WormholeSim
from .telemetry import (
    LatencyHistogram,
    MeasuredContentionCost,
    MeasuredEnergyCost,
    Telemetry,
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
from .xsim import XSimResults, latency_vs_rate_batched, xsimulate

__all__ = [
    "DEST_RANGES",
    "EnergyModel",
    "LatencyHistogram",
    "MeasuredContentionCost",
    "MeasuredEnergyCost",
    "NoCConfig",
    "PARSEC_PROFILES",
    "Request",
    "SimStats",
    "Telemetry",
    "WormholeSim",
    "Workload",
    "XSimResults",
    "fit_energy_cost",
    "latency_vs_rate",
    "latency_vs_rate_batched",
    "link_coords",
    "link_index",
    "parsec_workload",
    "simulate",
    "synthetic_workload",
    "xsimulate",
]
