"""Network-on-chip simulation for the DPM port: configuration, workloads
and the batched xsim engine. Twin of ``repro.noc``; the host simulator
(``WormholeSim``), telemetry and trace replay come with later slices.
"""
from .config import DEST_RANGES, EnergyModel, NoCConfig
from .simulator import SimStats
from .traffic import (
    PARSEC_PROFILES,
    Request,
    Workload,
    parsec_workload,
    synthetic_workload,
)
from .xsim import XSimResults, latency_vs_rate_batched, xsimulate

__all__ = [
    "DEST_RANGES",
    "EnergyModel",
    "NoCConfig",
    "PARSEC_PROFILES",
    "Request",
    "SimStats",
    "Workload",
    "XSimResults",
    "latency_vs_rate_batched",
    "parsec_workload",
    "synthetic_workload",
    "xsimulate",
]
