"""Batch runner: compile -> one batched fused-cycle run -> SimStats.

Twin of ``repro.noc.xsim.run``. ``xsimulate(cfg, workloads, algos)`` lowers
every (workload, algorithm) pair with the compiler, pads the batch to one
common (P, S) shape, and runs the whole grid through one call of the fused
cycle engine (``kernels.noc_cycle``): seeds, injection rates and routing
algorithms all ride the batch axis, which on the card is the kernel's grid
(one cluster or thread block per instance) where the reference ``vmap``s.
As the reference ``pmap``s the batch over its local devices,
``_run_sharded`` splits it over the visible cards: D, the largest count up
to their number that divides B, takes B / D instances each, one kernel
launch a card, and the results are concatenated.

The cycle count is fixed (``max horizon + drain_grace``): the engine does
not exit early, so unlike the host sim there is no drain-and-stop —
saturation points cost the same as idle ones.

There is no slot pool anymore: the packed router-centric state is sized by
the network itself (every in-flight worm holds a VC FIFO or an NI lane
front), so per-cycle cost is bounded by ``L * 2V + 2 * NN`` regardless of
injection rate or backlog, and the old overflow/regrow loop is gone.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import NoCConfig
from ..simulator import SimStats
from ..traffic import Workload
from ...core.algo import available_algorithms, get_algorithm
from ...core.topology import make_topology
from ...device import resolve_device
from ...kernels.noc_cycle import KERNEL
from .compile import (
    CompiledTraffic,
    compile_workload,
    geometry_tables,
    stack_traffic,
    traffic_from_numpy,
)
from .step import CTR, run_cycles


def _shard_count(B: int, n_devices: int) -> int:
    """The reference's D: the largest count up to ``n_devices`` that
    divides ``B``."""
    D = n_devices
    while D > 1 and B % D:
        D -= 1
    return max(D, 1)


def _run_sharded(tr: dict, geom: dict, devices: list, **kw) -> dict:
    """``run_cycles`` over the batch split into ``_shard_count(B,
    len(devices))`` equal parts, part ``i`` on ``devices[i]`` (one launch
    each; a device may be listed more than once), the outputs concatenated
    in batch order on ``devices[0]``."""
    B = tr["link"].shape[0]
    D = _shard_count(B, len(devices))
    if D == 1:
        dev = torch.device(devices[0])
        return run_cycles({k: v.to(dev) for k, v in tr.items()}, geom, **kw)
    per = B // D
    outs = [run_cycles({k: v[i * per:(i + 1) * per].to(devices[i])
                        for k, v in tr.items()}, geom, **kw)
            for i in range(D)]
    first = torch.device(devices[0])
    cat = lambda parts: torch.cat([p.to(first) for p in parts])
    out = {k: cat([o[k] for o in outs])
           for k in ("dtime", "ctr", "crel", "lutil", "rconf")}
    out["planes"] = type(outs[0]["planes"])(*(
        cat(parts) for parts in zip(*(o["planes"] for o in outs))))
    return out


def _devices(dev: torch.device) -> list:
    """The devices ``xsimulate`` splits its batch over: every visible card
    for ``"cuda"`` (the current one first), the one named by ``"cuda:i"``
    or ``"cpu"``."""
    if dev.type == "cuda" and dev.index is None:
        cur = torch.cuda.current_device()
        return [torch.device("cuda", i) for i in
                [cur] + [i for i in range(torch.cuda.device_count())
                         if i != cur]]
    return [dev]


@dataclass
class XSimResults:
    """Batched results over a (workloads x algos) grid.

    ``b = w * len(algos) + a`` indexes the flat batch axis. ``stats(w, a)``
    adapts one cell to the host simulator's ``SimStats`` (same counter
    semantics; ``cycles`` is the fixed scan length, so compare dynamic
    *energy* across simulators, not per-cycle power).
    """

    cfg: NoCConfig
    algos: tuple[str, ...]
    horizons: np.ndarray  # (W,) int
    warmup: int
    cycles: int  # scan length T
    slots: int  # structural worm capacity 2*V*L + 2*NN (informational)
    traffic: dict  # stacked compile tensors, numpy, leading axis B
    dtime: np.ndarray  # (B, P, S) int32
    ctr: np.ndarray  # (B, len(CTR)) int32
    crel: np.ndarray  # (B, C) bool
    wall_s: float  # host compile + device execute, seconds
    compile_s: float = 0.0  # host planning + lowering + stacking, seconds
    device_s: float = 0.0  # engine run: CUDA events on the card, else host clock
    device: str = "cpu"  # the engine's device
    epoch_len: int = 0  # telemetry bucket width (cycles)
    lutil: np.ndarray | None = None  # (B, E, L) per-epoch link flits
    rconf: np.ndarray | None = None  # (B, E, NN) per-epoch router conflicts

    def _b(self, w: int, a: int) -> int:
        return w * len(self.algos) + a

    def latencies(self, w: int, a: int) -> list[int]:
        """Per-delivery latencies of measured packets (warmup window)."""
        b = self._b(w, a)
        enq = self.traffic["enqueue"][b]
        measured = (
            self.traffic["valid"][b]
            & (enq >= self.warmup)
            & (enq < self.horizons[w])
        )
        hit = (
            self.traffic["deliver"][b]
            & (self.dtime[b] >= 0)
            & measured[:, None]
        )
        return (self.dtime[b] - enq[:, None])[hit].tolist()

    def avg_latency(self, w: int, a: int) -> float:
        lats = self.latencies(w, a)
        return sum(lats) / max(1, len(lats))

    def avg_latency_matrix(self) -> np.ndarray:
        W = len(self.horizons)
        return np.array(
            [[self.avg_latency(w, a) for a in range(len(self.algos))]
             for w in range(W)]
        )

    def delivered_sets(self, w: int, a: int) -> dict[int, set[int]]:
        """pid -> set of delivered node indices (for host-sim parity)."""
        b = self._b(w, a)
        hit = self.traffic["deliver"][b] & (self.dtime[b] >= 0)
        node = self.traffic["node"][b]
        out: dict[int, set[int]] = {}
        for p in np.flatnonzero(self.traffic["valid"][b]):
            out[int(p)] = {int(n) for n in node[p][hit[p]]}
        return out

    def packets_created(self, w: int, a: int) -> int:
        """Packets that entered an NI lane queue (host-sim semantics: every
        root whose enqueue time fell inside the run, plus released children).
        """
        b = self._b(w, a)
        tr = self.traffic
        roots = (
            tr["valid"][b] & (tr["parent"][b] < 0)
            & (tr["enqueue"][b] < self.cycles)
        )
        return int(roots.sum()) + int(self.crel[b].sum())

    def all_drained(self, w: int, a: int) -> bool:
        st = self.stats(w, a)
        return st.packets_finished == st.packets_created

    def slots_hwm(self) -> int:
        """Max in-flight worms across the batch (diagnostic: how much of the
        structural ``slots`` capacity the sweep actually used)."""
        return int(self.ctr[:, CTR.index("slots_hwm")].max())

    def link_utilization(self, w: int, a: int,
                         epoch: int | None = None) -> np.ndarray:
        """(L,) per-directed-link flit traversals for one grid cell — the
        conserved-event decomposition of ``flit_link_traversals``, exactly
        matching the host sim's ``Telemetry.link_flits`` when delivery sets
        match. ``epoch`` selects one ``epoch_len``-cycle bucket; default
        sums the run."""
        planes = self.lutil[self._b(w, a)]
        return planes.sum(axis=0) if epoch is None else planes[epoch]

    def router_conflicts(self, w: int, a: int,
                         epoch: int | None = None) -> np.ndarray:
        """(NN,) per-router losing arbitration requests (see ``lutil``
        semantics for the ``epoch`` argument)."""
        planes = self.rconf[self._b(w, a)]
        return planes.sum(axis=0) if epoch is None else planes[epoch]

    def link_heatmap(self, w: int, a: int) -> np.ndarray:
        """(rows, n, ports) per-node outgoing-link flit counts (rendering)."""
        util = self.link_utilization(w, a)
        rows = self.cfg.rows
        ports = util.shape[-1] // (rows * self.cfg.n)
        return util.reshape(rows, self.cfg.n, ports)

    def stats(self, w: int, a: int) -> SimStats:
        b = self._b(w, a)
        st = SimStats(latencies=sorted(self.latencies(w, a)))
        for i, name in enumerate(CTR):
            if hasattr(st, name):  # slots_hwm is xsim-only
                setattr(st, name, int(self.ctr[b, i]))
        st.packets_created = self.packets_created(w, a)
        st.cycles = self.cycles
        return st


def _capacity(cfg: NoCConfig, num_nodes: int, num_links: int) -> int:
    """Structural in-flight worm bound: every in-network worm holds >= 1 VC
    FIFO, plus one possible lane front per lane."""
    return 2 * cfg.vcs_per_class * num_links + 2 * num_nodes


def xsimulate(
    cfg: NoCConfig,
    workloads: list[Workload],
    algos: tuple | None = None,
    *,
    cost_model=None,
    warmup: int | None = None,
    drain_grace: int | None = None,
    pad_packets: int | None = None,
    pad_stages: int | None = None,
    epoch_len: int | None = None,
    broken_links_per_workload: list | None = None,
    device: torch.device | str = "cuda",
) -> XSimResults:
    """Simulate every (workload, algo) pair in one batched engine run.

    ``algos`` entries resolve through the routing-algorithm registry (names
    or ``RoutingAlgorithm`` instances); the default is every registered
    algorithm that supports the configured topology. ``cost_model``
    optionally overrides the planning objective for the whole grid.
    ``warmup``, ``drain_grace`` and ``epoch_len`` (the telemetry bucket
    width) default to the config's own values; ``pad_packets`` /
    ``pad_stages`` fix each compiled table's (P, S) (``compile_workload``).
    ``broken_links_per_workload`` overrides ``cfg.broken_links`` per
    workload (entries may be None = use the config's set): routes are
    planned on each workload's degraded topology at compile time while the
    whole grid still runs as one batch (the engine itself is
    fault-agnostic; trace replay uses this for mid-run link failures).
    ``device`` selects where DPM plans in batches (``core.batch_planner``)
    and the cycle engine: the CUDA kernel on the card (the default;
    ``"cuda"`` splits the batch over every visible card, ``"cuda:i"`` runs
    it on card ``i``), the plain PyTorch cycle for ``device="cpu"``; a
    missing card raises. The reference's ``backend=`` has no twin: the
    device picks the engine.
    """
    topo = make_topology(
        cfg.topology, cfg.n, cfg.m, cfg.broken_links, cfg.topology_params
    )
    if algos is None:
        algos = tuple(available_algorithms(topo))
    resolved = [get_algorithm(a) for a in algos]
    warmup = cfg.warmup if warmup is None else warmup
    drain_grace = cfg.drain_grace if drain_grace is None else drain_grace
    epoch_len = cfg.epoch_len if epoch_len is None else int(epoch_len)
    if broken_links_per_workload is not None and len(
        broken_links_per_workload
    ) != len(workloads):
        raise ValueError(
            "broken_links_per_workload needs one entry per workload "
            f"({len(broken_links_per_workload)} != {len(workloads)})"
        )
    dev = resolve_device(device)
    t0 = time.monotonic()
    traffics: list[CompiledTraffic] = []
    for wi, wl in enumerate(workloads):
        wcfg = cfg
        if broken_links_per_workload is not None:
            faults = broken_links_per_workload[wi]
            if faults is not None:
                wcfg = dataclasses.replace(cfg, broken_links=tuple(faults))
        for algo in resolved:
            traffics.append(compile_workload(
                wcfg, wl, algo, pad_packets=pad_packets,
                pad_stages=pad_stages, cost_model=cost_model, device=dev,
            ))
    ref, stacked = stack_traffic(traffics)
    T = max(wl.horizon for wl in workloads) + drain_grace
    ND = int(stacked["dslot"].max()) + 1  # flat delivery-slot space
    # the engine's static F is the largest worm in the batch: it sizes the
    # age-key multiplier and the BD>=F credit shortcut; per-packet lengths
    # ride the compiled ``flits`` table
    F = max(cfg.flits_per_packet, int(stacked["flits"].max()))
    geom = geometry_tables(ref.kind, ref.n, ref.m, ref.params,
                           cfg.vcs_per_class)
    tr = traffic_from_numpy(stacked, dev)
    t1 = time.monotonic()
    kw = dict(T=T, F=F, V=cfg.vcs_per_class, BD=cfg.buffer_depth,
              L=ref.num_links, NN=ref.num_nodes, ND=ND,
              epoch_len=epoch_len)
    devices = _devices(dev)
    if dev.type == "cuda":
        KERNEL.build()  # at first use; kept out of the device timing
        cards = sorted({d.index for d in devices})
        marks = {}
        for c in cards:
            marks[c] = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            marks[c][0].record(torch.cuda.current_stream(c))
        out = _run_sharded(tr, geom, devices, **kw)
        for c in cards:
            marks[c][1].record(torch.cuda.current_stream(c))
        for c in cards:
            marks[c][1].synchronize()
        # the cards run side by side: the slowest one's span
        device_s = max(a.elapsed_time(b) for a, b in marks.values()) / 1e3
    else:
        out = _run_sharded(tr, geom, devices, **kw)
        device_s = time.monotonic() - t1
    out = {
        k: out[k].cpu().numpy()
        for k in ("dtime", "ctr", "crel", "lutil", "rconf")
    }
    # scatter-compact flat delivery times -> the (B, P, S) view the results
    # object (and the parity tests) consume
    ds = stacked["dslot"]
    B = ds.shape[0]
    dtime = np.where(
        ds >= 0,
        out["dtime"][np.arange(B)[:, None, None], np.clip(ds, 0, ND)],
        -1,
    ).astype(np.int32)
    wall = time.monotonic() - t0
    return XSimResults(
        cfg=cfg,
        algos=tuple(a.name for a in resolved),
        horizons=np.array([wl.horizon for wl in workloads]),
        warmup=warmup,
        cycles=T,
        slots=_capacity(cfg, ref.num_nodes, ref.num_links),
        traffic=stacked,
        dtime=dtime,
        ctr=out["ctr"],
        crel=out["crel"],
        wall_s=wall,
        compile_s=t1 - t0,
        device_s=device_s,
        device=str(dev),
        epoch_len=epoch_len,
        lutil=out["lutil"],
        rconf=out["rconf"],
    )


def latency_vs_rate_batched(
    cfg: NoCConfig,
    rates: list[float],
    algos: tuple | None = None,
    cycles: int = 1500,
    seed: int = 0,
    **kw,
) -> tuple[dict[str, list[tuple[float, float]]], XSimResults]:
    """The fig6 latency-vs-injection-rate sweep as one batched call.

    Returns ``({algo: [(rate, avg_latency), ...]}, results)``. ``algos``
    defaults to every registered algorithm supporting the topology; ``kw``
    goes to ``xsimulate`` (``device=`` among them). There is no early
    saturation cut-off: every (rate, algo) point costs the same.
    """
    from ..traffic import synthetic_workload

    wls = [synthetic_workload(cfg, r, cycles, seed=seed) for r in rates]
    res = xsimulate(cfg, wls, algos, **kw)
    curves = {
        algo: [(rates[w], res.avg_latency(w, a)) for w in range(len(rates))]
        for a, algo in enumerate(res.algos)
    }
    return curves, res
