"""Dependency-aware trace replay through both NoC simulators.

Twin of ``repro.noc.trace.replay``. Phases replay under barrier semantics:
phase ``k + 1`` injects only after every delivery of phase ``k`` has
completed. The host driver realizes the barrier literally — one fresh
``WormholeSim`` per phase, run to drain; the xsim driver maps phases onto
the *workloads* axis of a single ``xsimulate`` batch (one launch of the
cycle kernel for the whole trace, one instance per phase), which encodes
the same semantics because batch instances share nothing.

Payload bytes become per-packet worm lengths here:
``ceil(bytes / flit_bytes)`` flits, clamped to ``[1, max_flits]`` — the
clamp keeps a multi-KB collective worm from monopolizing every VC on its
path while preserving the relative cost of control vs payload traffic.

``cross_validate`` runs both drivers and enforces the simulators' parity
contract on real workload traffic: identical per-packet delivery sets per
phase, end-to-end completion within the documented 10% latency band.

Every driver takes ``device``: where DPM plans in batches (``bulk_plan``)
and, for ``replay_xsim``, where the cycle engine runs — the CUDA kernel on
the card by default (a missing card raises), the plain PyTorch cycle for
``device="cpu"``. The reference's ``backend=`` has no twin.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import NoCConfig
from ..simulator import WormholeSim
from ..traffic import Request, Workload
from ...core.topology import make_topology
from .ir import Trace

DEFAULT_FLIT_BYTES = 16  # link phit width: one flit moves 16 payload bytes
DEFAULT_MAX_FLITS = 64  # worm-length clamp (int8 xsim planes cap at 127)
STRAGGLER_TOP_K = 5  # slowest deliveries reported per phase timeline


def flits_for_bytes(
    nbytes: int,
    flit_bytes: int = DEFAULT_FLIT_BYTES,
    max_flits: int = DEFAULT_MAX_FLITS,
) -> int:
    """Payload bytes -> worm length in flits, clamped to [1, max_flits]."""
    if max_flits > 127:
        raise ValueError(f"max_flits {max_flits} exceeds xsim plane cap 127")
    return max(1, min(int(max_flits), -(-int(nbytes) // int(flit_bytes))))


@dataclass
class ReplayResult:
    """Per-phase and end-to-end stats of one trace replay."""

    trace_name: str
    engine: str  # "host" | "xsim"
    algo: str
    phase_names: list[str]
    phase_cycles: list[int]  # per-phase completion (cycles to last tail)
    phase_deliveries: list[dict[int, set[int]]]  # pid -> delivered node idxs
    # telemetry timeline (DESIGN.md §10): per-phase (L,) directed-link flit
    # counts, top-K slowest deliveries, and the fault set each phase ran
    # under (None = the config's own set)
    fabric: tuple[int, int] | None = None  # (n, rows) for heatmap reshape
    phase_link_util: list[np.ndarray] = field(default_factory=list)
    phase_stragglers: list[list[dict]] = field(default_factory=list)
    phase_faults: list[tuple | None] = field(default_factory=list)
    # the xsim driver's one ``xsimulate`` call (its inputs, planes and
    # compile/device/wall split); None for the host driver
    xsim_results: object | None = None

    @property
    def total_cycles(self) -> int:
        """End-to-end completion under barrier semantics: phases are
        serialized, so the trace takes the sum of phase durations."""
        return sum(self.phase_cycles)

    def summary(self) -> dict:
        return {
            "trace": self.trace_name,
            "engine": self.engine,
            "algo": self.algo,
            "phases": len(self.phase_names),
            "total_cycles": self.total_cycles,
            "phase_cycles": list(self.phase_cycles),
        }

    def timeline(self) -> dict:
        """JSON-ready per-phase telemetry timeline: phase cycles, per-node
        link heatmaps, peak-link pressure, stragglers, and the fault set in
        force (the reference's ``summarize_repro.py`` renders it).
        """
        n, rows = self.fabric if self.fabric else (0, 0)
        phases = []
        for i, name in enumerate(self.phase_names):
            util = (
                self.phase_link_util[i]
                if i < len(self.phase_link_util) else None
            )
            entry = {
                "name": name,
                "cycles": int(self.phase_cycles[i]),
                "deliveries": int(
                    sum(len(s) for s in self.phase_deliveries[i].values())
                ),
                "broken_links": (
                    None if i >= len(self.phase_faults)
                    or self.phase_faults[i] is None
                    else [list(map(list, l)) for l in self.phase_faults[i]]
                ),
                "stragglers": (
                    self.phase_stragglers[i]
                    if i < len(self.phase_stragglers) else []
                ),
            }
            if util is not None and n:
                node_flits = util.reshape(rows * n, 4).sum(axis=1)
                entry["max_link_flits"] = int(util.max(initial=0))
                entry["total_flits"] = int(util.sum())
                entry["link_heatmap"] = (
                    node_flits.reshape(rows, n).tolist()
                )
            phases.append(entry)
        return {
            "trace": self.trace_name,
            "engine": self.engine,
            "algo": self.algo,
            "fabric": {"n": n, "rows": rows},
            "total_cycles": self.total_cycles,
            "phases": phases,
        }


def export_timeline(result: ReplayResult, path) -> dict:
    """Write ``result.timeline()`` as JSON; returns the dict written."""
    tl = result.timeline()
    with open(path, "w") as f:
        json.dump(tl, f, indent=2, sort_keys=True)
        f.write("\n")
    return tl


def _resolve_phase_faults(
    tr: Trace, phase_broken_links
) -> list[tuple | None]:
    """Normalize a per-phase broken-links override into one entry per phase.

    Keys may be phase indices or names; an override stays in force for
    every later phase until the next override (a link that dies mid-trace
    stays dead — pass ``()`` at a later phase to model a repair). ``None``
    entries mean "the config's own fault set"."""
    per_phase: list[tuple | None] = [None] * len(tr.phases)
    if not phase_broken_links:
        return per_phase
    names = [ph.name for ph in tr.phases]
    by_idx: dict[int, tuple] = {}
    for k, v in phase_broken_links.items():
        if isinstance(k, str):
            if k not in names:
                raise KeyError(
                    f"unknown phase {k!r} in phase_broken_links; trace "
                    f"{tr.name!r} has phases: {', '.join(names)}"
                )
            i = names.index(k)
        else:
            i = int(k)
            if not 0 <= i < len(names):
                raise IndexError(
                    f"phase index {i} out of range for trace {tr.name!r} "
                    f"({len(names)} phases)"
                )
        by_idx[i] = tuple(tuple(map(tuple, link)) for link in v)
    current: tuple | None = None
    for i in range(len(names)):
        if i in by_idx:
            current = by_idx[i]
        per_phase[i] = current
    return per_phase


def _check_fits(tr: Trace, topo) -> None:
    if tr.num_ranks > topo.num_nodes:
        raise ValueError(
            f"trace {tr.name!r} has {tr.num_ranks} ranks but the "
            f"{topo.num_nodes}-node fabric cannot embed them"
        )


def _phase_requests(ph, topo, flit_bytes: int, max_flits: int):
    """Lower one phase's events to simulator requests (ranks embedded in
    boustrophedon label order, bytes converted to worm lengths)."""
    return [
        Request(
            time=e.time,
            src=topo.unlabel(e.src),
            dests=[topo.unlabel(d) for d in e.dests],
            flits=flits_for_bytes(e.payload_bytes, flit_bytes, max_flits),
        )
        for e in ph.events
    ]


def replay_host(
    tr: Trace,
    cfg: NoCConfig,
    algo: str = "DPM",
    *,
    cost_model=None,
    flit_bytes: int = DEFAULT_FLIT_BYTES,
    max_flits: int = DEFAULT_MAX_FLITS,
    phase_broken_links: dict | None = None,
    device: torch.device | str = "cuda",
) -> ReplayResult:
    """Replay through the flit-level host simulator, one drained
    ``WormholeSim`` per phase (the literal barrier); each phase's requests
    plan through ``add_requests`` (DPM in batches on ``device``).

    ``phase_broken_links`` injects mid-run link failures: a mapping from
    phase index/name to a broken-link set that overrides
    ``cfg.broken_links`` from that phase onward (``_resolve_phase_faults``)
    — each affected phase plans and runs on its own degraded topology, and
    the telemetry timeline shows the degradation step."""
    topo = make_topology(
        cfg.topology, cfg.n, cfg.m, cfg.broken_links, cfg.topology_params
    )
    _check_fits(tr, topo)
    faults = _resolve_phase_faults(tr, phase_broken_links)
    cycles, deliveries = [], []
    link_util, stragglers = [], []
    for ph, flt in zip(tr.phases, faults):
        pcfg = (
            cfg if flt is None
            else dataclasses.replace(cfg, broken_links=flt)
        )
        ptopo = make_topology(
            pcfg.topology, pcfg.n, pcfg.m, pcfg.broken_links,
            pcfg.topology_params,
        )
        sim = WormholeSim(pcfg)
        # bulk admission: the whole phase plans through the shared plan
        # arena in batches on the device where the fabric supports it
        sim.add_requests(
            algo, _phase_requests(ph, topo, flit_bytes, max_flits),
            cost_model=cost_model, device=device,
        )
        st = sim.run(ph.span + cfg.drain_grace, drain=True)
        if st.packets_finished != st.packets_created:
            raise RuntimeError(
                f"phase {ph.name!r} did not drain within "
                f"{ph.span + cfg.drain_grace} cycles "
                f"({st.packets_finished}/{st.packets_created} finished)"
            )
        last = max(
            (t for p in sim.packets for t in p.delivery_times.values()),
            default=0,
        )
        cycles.append(last + 1)
        deliveries.append(
            {p.pid: {ptopo.idx(c) for c in p.delivery_times}
             for p in sim.packets}
        )
        link_util.append(st.telemetry.link_flits.copy())
        lats = sorted(
            (
                (t - p.enqueue_time, p.pid, ptopo.idx(c))
                for p in sim.packets
                for c, t in p.delivery_times.items()
            ),
            reverse=True,
        )[:STRAGGLER_TOP_K]
        stragglers.append(
            [{"pid": pid, "node": node, "latency": int(lat)}
             for lat, pid, node in lats]
        )
    return ReplayResult(
        trace_name=tr.name,
        engine="host",
        algo=algo,
        phase_names=[ph.name for ph in tr.phases],
        phase_cycles=cycles,
        phase_deliveries=deliveries,
        fabric=(cfg.n, cfg.rows),
        phase_link_util=link_util,
        phase_stragglers=stragglers,
        phase_faults=faults,
    )


def replay_xsim(
    tr: Trace,
    cfg: NoCConfig,
    algo: str = "DPM",
    *,
    cost_model=None,
    flit_bytes: int = DEFAULT_FLIT_BYTES,
    max_flits: int = DEFAULT_MAX_FLITS,
    phase_broken_links: dict | None = None,
    device: torch.device | str = "cuda",
) -> ReplayResult:
    """Replay through the batched xsim engine: every phase is one workload
    of one ``xsimulate`` call (``warmup=0``), so the whole trace runs as a
    single launch of the cycle engine with one instance per phase —
    barrier semantics for free, since batch instances are disjoint
    simulations. ``phase_broken_links`` (same semantics as
    ``replay_host``) rides ``xsimulate``'s per-workload fault override, so
    a mid-trace link failure still runs in the one batched launch.
    ``result.xsim_results`` is that call's ``XSimResults``."""
    from ..xsim import xsimulate

    topo = make_topology(
        cfg.topology, cfg.n, cfg.m, cfg.broken_links, cfg.topology_params
    )
    _check_fits(tr, topo)
    faults = _resolve_phase_faults(tr, phase_broken_links)
    workloads = [
        Workload(
            name=ph.name,
            requests=_phase_requests(ph, topo, flit_bytes, max_flits),
            horizon=ph.span + 1,
        )
        for ph in tr.phases
    ]
    res = xsimulate(
        cfg, workloads, (algo,), cost_model=cost_model, warmup=0,
        broken_links_per_workload=(
            None if phase_broken_links is None else faults
        ),
        device=device,
    )

    cycles, deliveries = [], []
    link_util, stragglers = [], []
    for w, ph in enumerate(tr.phases):
        if not res.all_drained(w, 0):
            raise RuntimeError(
                f"phase {ph.name!r} did not drain within {res.cycles} cycles"
            )
        b = res._b(w, 0)
        hit = res.traffic["deliver"][b] & (res.dtime[b] >= 0)
        last = int(res.dtime[b][hit].max(initial=-1))
        cycles.append(last + 1)
        deliveries.append(res.delivered_sets(w, 0))
        link_util.append(res.link_utilization(w, 0))
        enq = res.traffic["enqueue"][b]
        lat = res.dtime[b] - enq[:, None]
        pidx, sidx = np.nonzero(hit)
        order = np.argsort(lat[pidx, sidx])[::-1][:STRAGGLER_TOP_K]
        stragglers.append(
            [
                {
                    "pid": int(pidx[i]),
                    "node": int(res.traffic["node"][b][pidx[i], sidx[i]]),
                    "latency": int(lat[pidx[i], sidx[i]]),
                }
                for i in order
            ]
        )
    return ReplayResult(
        trace_name=tr.name,
        engine="xsim",
        algo=algo,
        phase_names=[ph.name for ph in tr.phases],
        phase_cycles=cycles,
        phase_deliveries=deliveries,
        fabric=(cfg.n, cfg.rows),
        phase_link_util=link_util,
        phase_stragglers=stragglers,
        phase_faults=faults,
        xsim_results=res,
    )


def cross_validate(
    tr: Trace,
    cfg: NoCConfig,
    algo: str = "DPM",
    *,
    cost_model=None,
    latency_rel: float = 0.10,
    phase_broken_links: dict | None = None,
    device: torch.device | str = "cuda",
) -> tuple[ReplayResult, ReplayResult]:
    """Replay through both engines and enforce the parity contract.

    Per phase: identical per-packet delivery sets (the hard contract).
    End-to-end: completion times within ``latency_rel`` (the engines
    resolve switch-allocation ties differently, so exact cycle equality
    is not promised — same band the fig6 parity tests use).
    """
    h = replay_host(
        tr, cfg, algo, cost_model=cost_model,
        phase_broken_links=phase_broken_links, device=device,
    )
    x = replay_xsim(
        tr, cfg, algo, cost_model=cost_model,
        phase_broken_links=phase_broken_links, device=device,
    )
    for name, hd, xd in zip(h.phase_names, h.phase_deliveries,
                            x.phase_deliveries):
        if hd != xd:
            diff = {
                p for p in set(hd) | set(xd)
                if hd.get(p) != xd.get(p)
            }
            raise AssertionError(
                f"delivery sets diverge in phase {name!r} "
                f"of {tr.name!r}: packets {sorted(diff)}"
            )
    ht, xt = h.total_cycles, x.total_cycles
    if abs(ht - xt) > latency_rel * max(ht, xt):
        raise AssertionError(
            f"end-to-end completion diverges on {tr.name!r}: "
            f"host {ht} vs xsim {xt} cycles (> {latency_rel:.0%})"
        )
    return h, x
