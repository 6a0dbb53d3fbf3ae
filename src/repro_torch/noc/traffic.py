"""Workload generators + simulation runner for the NoC benchmarks.

Synthetic traffic reproduces the paper's setup: uniform-random sources and
destinations, Bernoulli injection per node per cycle, 10 % of packets are
multicast with a destination-set size drawn uniformly from the configured
range. PARSEC-like traces are synthesized per-benchmark (Netrace is not
available offline — see DESIGN.md §2): each benchmark keys a (relative load,
multicast %, destination-size distribution, burstiness) tuple chosen to match
the published workload characteristics.

Twin of ``repro.noc.traffic``: the generators copy the reference's
``random.Random(seed)`` draws exactly, so both packages build identical
workloads. ``simulate``/``latency_vs_rate`` drive the host ``WormholeSim``
and come with the host-NoC slice of the port.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass

from ..core.grid import Coord
from ..core.topology import make_topology
from .config import NoCConfig


@dataclass
class Request:
    time: int
    src: Coord
    dests: list[Coord]
    # per-packet worm length; None = cfg.flits_per_packet. Trace replays
    # (noc.trace) carry heterogeneous payloads; synthetic traffic leaves it
    # unset, so existing workloads stay bit-identical.
    flits: int | None = None


@dataclass
class Workload:
    name: str
    requests: list[Request]
    horizon: int  # last injection cycle


def synthetic_workload(
    cfg: NoCConfig,
    injection_rate: float,  # packets / node / cycle
    cycles: int,
    seed: int = 0,
    multicast_fraction: float | None = None,
    dest_range: tuple[int, int] | None = None,
) -> Workload:
    mc = cfg.multicast_fraction if multicast_fraction is None else multicast_fraction
    lo, hi = cfg.dest_range if dest_range is None else dest_range
    rng = random.Random(seed)
    g = make_topology(cfg.topology, cfg.n, cfg.m)
    nodes = g.nodes()  # idx order == the legacy 2-D row-major enumeration
    reqs: list[Request] = []
    for t in range(cycles):
        for src in nodes:
            if rng.random() >= injection_rate:
                continue
            if rng.random() < mc:
                k = rng.randint(lo, hi)
                dests = rng.sample([d for d in nodes if d != src], k)
            else:
                dests = [rng.choice([d for d in nodes if d != src])]
            reqs.append(Request(t, src, dests))
    return Workload(f"uniform-{injection_rate:.4f}", reqs, cycles)


# ---------------------------------------------------------------------------
# PARSEC-like synthesized traces.
# Tuples: (rel_load, multicast_pct, dest_size_range, burst_on_prob, burst_len)
# chosen to match the published characteristics of each workload's coherence
# traffic (multicast % within 5-15 % per [4]; fluidanimate is the most
# multicast-heavy, canneal the most memory-bound / bursty).
# ---------------------------------------------------------------------------
PARSEC_PROFILES: dict[str, tuple[float, float, tuple[int, int], float, int]] = {
    "blackscholes": (0.30, 0.05, (2, 4), 0.05, 8),
    "bodytrack": (0.45, 0.07, (2, 6), 0.10, 10),
    "canneal": (0.70, 0.08, (2, 8), 0.25, 16),
    "dedup": (0.50, 0.06, (2, 6), 0.15, 12),
    "ferret": (0.55, 0.08, (3, 8), 0.15, 12),
    "fluidanimate": (0.60, 0.15, (6, 16), 0.20, 14),
    "freqmine": (0.40, 0.06, (2, 5), 0.10, 8),
    "swaptions": (0.35, 0.05, (2, 4), 0.05, 6),
    "vips": (0.50, 0.09, (3, 8), 0.12, 10),
    "x264": (0.55, 0.10, (4, 10), 0.18, 12),
}


def parsec_workload(
    cfg: NoCConfig,
    benchmark: str,
    cycles: int,
    base_rate: float = 0.05,
    seed: int = 0,
) -> Workload:
    rel_load, mc, dr, burst_p, burst_len = PARSEC_PROFILES[benchmark]
    # stable digest, NOT hash(): str hashing is salted per process
    # (PYTHONHASHSEED), which made fig8 traces irreproducible across runs.
    rng = random.Random(seed ^ zlib.crc32(benchmark.encode()) & 0xFFFF)
    g = make_topology(cfg.topology, cfg.n, cfg.m)
    nodes = g.nodes()  # idx order == the legacy 2-D row-major enumeration
    rate = base_rate * rel_load
    reqs: list[Request] = []
    burst_remaining = {n: 0 for n in nodes}
    for t in range(cycles):
        for src in nodes:
            if burst_remaining[src] > 0:
                burst_remaining[src] -= 1
                eff = min(1.0, rate * 6.0)  # ON phase
            else:
                if rng.random() < burst_p * rate:
                    burst_remaining[src] = burst_len
                eff = rate
            if rng.random() >= eff:
                continue
            if rng.random() < mc:
                k = rng.randint(*dr)
                dests = rng.sample([d for d in nodes if d != src], k)
            else:
                dests = [rng.choice([d for d in nodes if d != src])]
            reqs.append(Request(t, src, dests))
    return Workload(benchmark, reqs, cycles)
