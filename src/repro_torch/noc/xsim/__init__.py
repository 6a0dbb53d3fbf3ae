"""xsim — fixed-shape, array-based NoC simulator for batched DPM sweeps
(compiler -> fused cycle engine -> batch runner). Twin of ``repro.noc.xsim``.
"""
from .compile import (
    CompiledTraffic,
    compile_workload,
    geometry_tables,
    planes_from_numpy,
    stack_traffic,
    traffic_from_numpy,
)
from .run import XSimResults, latency_vs_rate_batched, xsimulate

__all__ = [
    "CompiledTraffic",
    "XSimResults",
    "compile_workload",
    "geometry_tables",
    "latency_vs_rate_batched",
    "planes_from_numpy",
    "stack_traffic",
    "traffic_from_numpy",
    "xsimulate",
]
