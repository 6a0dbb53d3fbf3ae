"""Lower host-side MulticastPlans into the dense tensors xsim steps over.

The compiler mirrors ``WormholeSim.add_plan`` exactly: one row per wormhole
packet (degenerate single-node paths are skipped, DPM child packets keep
their parent linkage), in workload-request order, so packet ids line up 1:1
between the two simulators — the cross-validation tests compare per-pid
delivery sets directly.

Per-packet scalars and per-stage tables (stage ``s`` is the input FIFO at
``hops[s+1]`` fed by directed link ``(hops[s], hops[s+1])``):

* ``link[P, S]``    directed-link id ``idx(u) * ports + direction(u -> v)``
                    (direction order and port count from the topology: the
                    2-D kinds use (+x, -x, +y, -y), the 3-D ones append
                    (+z, -z); torus wrap hops resolve through
                    ``Topology.delta``'s signed shortest step).
* ``vcls[P, S]``    VC class of the hop — HIGH(0) iff the boustrophedon
                    label increases along it (core.grid labeling, the
                    paper's dual-path deadlock rule, same as the host sim).
* ``deliver[P, S]`` tail-flit delivery points (first occurrence per node).
* ``node[P, S]``    row-major index of ``hops[s+1]`` (delivery reporting).
* ``release_stage`` for child packets: the parent stage whose header entry
                    at the representative releases the child (cut-through
                    relay, as in the host sim's ``header_times`` rule).
* ``lane``          NI injection lane ``idx(source) * 2 + is_child`` — child
                    packets use the multicast relay port, fresh traffic the
                    normal injection queue (two lanes per node, as in the
                    host sim's ``src_queues``).

Padding rows have ``enqueue = NEVER`` and are never released; padded stage
entries hold link 0 and are unreachable (``fpos < num_stages`` gating).

Twin of ``repro.noc.xsim.compile``: the lowering is numpy and identical;
``traffic_from_numpy``/``planes_from_numpy`` carry the stacked arrays (from
either package) onto a torch device with their dtypes kept.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...core.grid import Coord
from ...core.batch_planner import bulk_plan
from ...core.planner import MulticastPlan
from ...core.topology import make_topology
from ...device import resolve_device
from ...kernels.noc_cycle.ref import CycleState
from ..config import NoCConfig
from ..traffic import Workload

# Enqueue sentinel for padding rows: far beyond any horizon, small enough
# that key arithmetic (enqueue * P * F) stays well inside int32.
NEVER = np.int32(2**20)


@dataclass(frozen=True)
class CompiledTraffic:
    """One workload under one algorithm, lowered to fixed-shape arrays."""

    # static geometry / config
    n: int
    m: int  # the topology factory's m argument (y extent; == rows in 2-D)
    kind: str
    params: tuple  # extra make_topology args (Topology.params)
    ports: int  # output ports per router (4 in 2-D, 6 in 3-D)
    num_nodes: int
    num_links: int  # directed-link id space: num_nodes * ports
    horizon: int
    # per-packet (P,)
    enqueue: np.ndarray  # int32; NEVER on padding rows
    parent: np.ndarray  # int32; -1 = root packet
    release_stage: np.ndarray  # int32; -1 for roots
    lane: np.ndarray  # int32; node * 2 + is_child
    num_stages: np.ndarray  # int32
    flits: np.ndarray  # int32; per-packet worm length (cfg default if unset)
    eject_node: np.ndarray  # int32; row-major index of hops[-1]
    valid: np.ndarray  # bool
    # per-stage (P, S)
    link: np.ndarray  # int32
    vcls: np.ndarray  # int32; 0 HIGH / 1 LOW
    deliver: np.ndarray  # bool
    # compact delivery-slot index: -1 where not a delivery point, else a
    # dense 0..nd-1 id. The engine scatters arrival times into an (nd,)-flat
    # array instead of carrying the full (P, S) dtime plane through the scan
    # (most of which is never written — delivery points are sparse).
    dslot: np.ndarray  # int32
    node: np.ndarray  # int32
    # per-lane static injection order for ROOT lanes (2NN, Q): pids by
    # (enqueue, pid), -1 pad. Child lanes are all -1: children inject in
    # dynamic release order through the per-node ``chl`` table instead.
    lane_seq: np.ndarray
    # child (DPM re-injection) table: (C,) rows + (P,) pid -> row map
    child_ix: np.ndarray  # (P,) int32; -1 = root
    child_pid: np.ndarray  # (C,) int32 — row -> packet id
    child_parent: np.ndarray  # (C,) int32
    child_rs: np.ndarray  # (C,) int32 — parent stage releasing the child
    child_enq: np.ndarray  # (C,) int32
    # (C,) directed link whose header arrival releases the child: the link
    # feeding the parent's ``release_stage`` FIFO (the representative node)
    watch_link: np.ndarray
    # children grouped by injection node (NN, QC) int32 child rows, -1 pad —
    # the relay lane's dynamic-order candidate set
    chl: np.ndarray

    @property
    def num_packets(self) -> int:
        return int(self.valid.sum())

    @property
    def max_stages(self) -> int:
        return self.link.shape[1]


def compile_workload(
    cfg: NoCConfig,
    workload: Workload,
    algo,
    pad_packets: int | None = None,
    pad_stages: int | None = None,
    cost_model=None,
    *,
    device: torch.device | str = "cuda",
) -> CompiledTraffic:
    """Plan every request and lower the packet set to dense arrays.

    ``algo`` is resolved through the routing-algorithm registry (name or
    ``RoutingAlgorithm`` instance); ``cost_model`` optionally overrides the
    objective cost-sensitive algorithms plan under (default: the
    algorithm's own). Planning goes through ``core.batch_planner.bulk_plan``
    on ``device`` (DPM and DPM-E on healthy fabrics batch there wherever
    ``batch_support`` admits the model; the other algorithms plan on the
    host into the same arena). ``pad_packets``/``pad_stages`` fix the
    (P, S) table sizes (default: the workload's own); a pad smaller than
    the workload raises. With ``cfg.broken_links`` set, plans come from
    the fault-aware route provider on the degraded topology, and every
    lowered hop is re-checked: a route crossing a broken link is refused
    before any tensor is built (the same contract as
    ``WormholeSim.add_plan``).
    """
    g = make_topology(
        cfg.topology, cfg.n, cfg.m, cfg.broken_links, cfg.topology_params
    )
    rows: list[tuple] = []  # (hops, deliveries, enqueue, parent_pid, flits)
    # bulk-plan the whole workload through the shared plan arena: one
    # device dispatch per chunk of arena misses where supported (plans are
    # bit-identical to per-request plan() calls)
    plans = bulk_plan(
        g, [(r.src, r.dests) for r in workload.requests], algo,
        cost_model=cost_model, device=device,
    )
    for r, pl_ in zip(workload.requests, plans):
        nf = cfg.flits_per_packet if r.flits is None else int(r.flits)
        if not 1 <= nf <= 127:  # int8 fhead/fcount/lsent planes
            raise ValueError(f"per-packet flits must be in [1, 127] (got {nf})")
        _lower_plan(pl_, r.time, rows, nf)
    if cfg.broken_links:
        for hops, *_ in rows:
            for u, v in zip(hops, hops[1:]):
                if g.is_broken(u, v):
                    raise ValueError(
                        f"compiled route traverses broken link ({u}, {v}); "
                        f"replan on the degraded topology"
                    )
    P = len(rows)
    S = max((len(h) - 1 for h, *_ in rows), default=1)
    Pp = max(P, 1) if pad_packets is None else pad_packets
    Sp = S if pad_stages is None else pad_stages
    if Pp < P or Sp < S:
        raise ValueError(f"pad ({Pp},{Sp}) smaller than workload ({P},{S})")

    enqueue = np.full(Pp, NEVER, np.int32)
    parent = np.full(Pp, -1, np.int32)
    release_stage = np.full(Pp, -1, np.int32)
    lane = np.zeros(Pp, np.int32)
    num_stages = np.ones(Pp, np.int32)
    flits = np.full(Pp, cfg.flits_per_packet, np.int32)
    eject_node = np.zeros(Pp, np.int32)
    valid = np.zeros(Pp, bool)
    link = np.zeros((Pp, Sp), np.int32)
    vcls = np.zeros((Pp, Sp), np.int32)
    deliver = np.zeros((Pp, Sp), bool)
    node = np.zeros((Pp, Sp), np.int32)

    # per-stage tables, vectorized over one flat hop-pair array; per-packet
    # scalars accumulate in python lists and assign once (scalar numpy
    # writes dominated lowering time on big sweeps)
    n, m = g.n, g.rows
    flat_uv: list[Coord] = []
    lens = np.zeros(P, np.int64)
    enq_l, par_l, lane_l, ej_l, fl_l = [], [], [], [], []
    del_p: list[int] = []
    del_s: list[int] = []
    for pid, (hops, deliveries, t, par, nf) in enumerate(rows):
        ns = len(hops) - 1
        lens[pid] = ns
        flat_uv.extend(hops)
        enq_l.append(t)
        par_l.append(-1 if par is None else par)
        fl_l.append(nf)
        lane_l.append(g.idx(hops[0]) * 2 + (0 if par is None else 1))
        ej_l.append(g.idx(hops[-1]))
        for d in deliveries:
            del_p.append(pid)
            del_s.append(hops.index(d, 1) - 1)
        if par is not None:
            release_stage[pid] = rows[par][0].index(hops[0], 1) - 1
    if P:
        enqueue[:P] = enq_l
        parent[:P] = par_l
        lane[:P] = lane_l
        num_stages[:P] = lens
        flits[:P] = fl_l
        eject_node[:P] = ej_l
        valid[:P] = True
        deliver[del_p, del_s] = True
        if g.kind in ("mesh", "torus"):
            # vectorized 2-D lowering, bit-identical to the closed-form
            # snake/direction math of ``core.grid``
            hv = np.fromiter(
                (c for xy in flat_uv for c in xy), np.int64, 2 * len(flat_uv)
            ).reshape(-1, 2)  # all hops, path-concatenated
            starts = np.cumsum(lens + 1) - (lens + 1)  # offsets incl. hop 0
            total = int(lens.sum())
            pidx = np.repeat(np.arange(P), lens)
            sidx = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            flat = np.repeat(starts, lens) + sidx  # index of hop u of (pid, s)
            ux, uy = hv[flat, 0], hv[flat, 1]
            vx, vy = hv[flat + 1, 0], hv[flat + 1, 1]
            dx, dy = vx - ux, vy - uy
            if g.wrap:  # signed shortest step (matches Topology.delta)
                dx = (dx + n // 2) % n - n // 2
                dy = (dy + m // 2) % m - m // 2
            dir_ = np.select(
                [dx == 1, dx == -1, dy == 1], [0, 1, 2], default=3
            )
            labu = np.where(uy % 2 == 0, uy * n + ux, uy * n + n - 1 - ux)
            labv = np.where(vy % 2 == 0, vy * n + vx, vy * n + n - 1 - vx)
            link[pidx, sidx] = (uy * n + ux) * 4 + dir_
            vcls[pidx, sidx] = labv < labu  # 0 HIGH (label up), 1 LOW
            node[pidx, sidx] = vy * n + vx
        else:
            # generic lowering through the Topology protocol (3-D, chiplet,
            # any future registered kind): per-hop loops, same semantics
            D = g.ports
            for pid, (hops, _dv, _t, _par, _nf) in enumerate(rows):
                for s, (u, v) in enumerate(zip(hops, hops[1:])):
                    link[pid, s] = g.idx(u) * D + g.direction(u, v)
                    vcls[pid, s] = g.label(*v) < g.label(*u)
                    node[pid, s] = g.idx(v)

    # static per-lane injection order for roots: (enqueue, pid) — the host
    # sim's FIFO arrival order (roots enter their queue at enqueue time).
    # Children are NOT in lane_seq: their queue order is dynamic (parent
    # header arrival), modeled through the per-node ``chl`` table below.
    by_lane: dict[int, list[int]] = {}
    order = sorted(
        (p for p in range(P) if parent[p] < 0),
        key=lambda p: (int(enqueue[p]), p),
    )
    for pid in order:
        by_lane.setdefault(int(lane[pid]), []).append(pid)
    Qn = max((len(v) for v in by_lane.values()), default=1)
    lane_seq = np.full((2 * g.num_nodes, Qn), -1, np.int32)
    for ln, pids in by_lane.items():
        lane_seq[ln, : len(pids)] = pids

    child_rows = np.flatnonzero(parent >= 0)
    C = max(1, len(child_rows))
    child_ix = np.full(Pp, -1, np.int32)
    child_pid = np.zeros(C, np.int32)
    child_parent = np.zeros(C, np.int32)
    child_rs = np.full(C, NEVER, np.int32)
    child_enq = np.full(C, NEVER, np.int32)
    watch_link = np.zeros(C, np.int32)
    by_node: dict[int, list[int]] = {}
    for row, pid in enumerate(child_rows):
        child_ix[pid] = row
        child_pid[row] = pid
        child_parent[row] = parent[pid]
        child_rs[row] = release_stage[pid]
        child_enq[row] = enqueue[pid]
        # the parent's header enters stage ``release_stage`` through this
        # link; its arrival event is what releases the child (row order is
        # pid order — the host sim's same-cycle append tie-break)
        watch_link[row] = link[parent[pid], release_stage[pid]]
        by_node.setdefault(int(lane[pid]) // 2, []).append(row)
    QCn = max((len(v) for v in by_node.values()), default=1)
    chl = np.full((g.num_nodes, QCn), -1, np.int32)
    for nd, rws in by_node.items():
        chl[nd, : len(rws)] = rws

    dslot = np.full((Pp, Sp), -1, np.int32)
    dslot.ravel()[np.flatnonzero(deliver.ravel())] = np.arange(
        int(deliver.sum()), dtype=np.int32
    )

    # the (enqueue, pid, fid) age keys must stay strictly below the NOC_INF
    # sentinel (2**30) so a real candidate always beats the no-candidate pad;
    # the key multiplier is the engine's static F = the largest worm length
    max_f = max(cfg.flits_per_packet, int(flits[valid].max(initial=1)))
    max_key = (int(enqueue[valid].max(initial=0)) + 1) * Pp * max_f
    if max_key >= 2**30:  # the CUDA kernel relies on it: no bounds checks
        raise ValueError(f"workload too large for int32 age keys ({max_key})")
    return CompiledTraffic(
        n=g.n, m=g.m or g.rows, kind=g.kind, params=g.params, ports=g.ports,
        num_nodes=g.num_nodes, num_links=g.num_nodes * g.ports,
        horizon=workload.horizon,
        enqueue=enqueue, parent=parent, release_stage=release_stage,
        lane=lane, num_stages=num_stages, flits=flits,
        eject_node=eject_node, valid=valid,
        link=link, vcls=vcls, deliver=deliver, dslot=dslot, node=node,
        lane_seq=lane_seq, child_ix=child_ix, child_pid=child_pid,
        child_parent=child_parent, child_rs=child_rs, child_enq=child_enq,
        watch_link=watch_link, chl=chl,
    )


@functools.lru_cache(maxsize=64)
def geometry_tables(
    kind: str, n: int, m: int, params: tuple, V: int
) -> dict[str, np.ndarray]:
    """Static router geometry for the fused cycle kernel (numpy, topology-only).

    The fused engine's candidate space is every VC FIFO plus every NI lane,
    flattened: FIFO ``(l, v)`` is candidate ``l * W + v`` (``W = 2V`` VCs per
    directed link), lane ``q`` is candidate ``L * W + q``, and one trailing
    dummy candidate ``L * W + 2 * NN`` absorbs padding. Arbitration is a
    dense masked min over ``node_ports[v]`` — the FIFOs of the ``D`` links
    *into* node ``v`` (a flit can only request ``v``'s output links from
    there; ``D = Topology.ports``) plus ``v``'s two NI lanes — so each
    candidate appears in exactly one node's port list and winner masks map
    back through the static ``cand_node``/``cand_port`` inverse with a
    gather, never a scatter.

    Tables enumerate the *healthy* topology (``params`` but no faults): the
    cycle engine is fault-agnostic — broken links are excluded at plan time,
    so no compiled route ever requests them.
    """
    g = make_topology(kind, n, m, params=params)
    NN = g.num_nodes
    D = g.ports
    L = NN * D
    W = 2 * V
    PORTS = D * W + 2
    CAND = L * W + 2 * NN
    node_ports = np.full((NN, PORTS), CAND, np.int32)  # CAND = dummy pad
    cand_node = np.zeros(CAND + 1, np.int32)
    cand_port = np.zeros(CAND + 1, np.int32)
    for vc in g.nodes():
        v = g.idx(vc)
        for uc in g.neighbors(*vc):
            d = g.direction(uc, vc)  # incoming link u -> v enters on port d
            link = g.idx(uc) * D + d
            for w in range(W):
                cand = link * W + w
                node_ports[v, d * W + w] = cand
                cand_node[cand] = v
                cand_port[cand] = d * W + w
        for q in range(2):
            cand = L * W + 2 * v + q
            node_ports[v, D * W + q] = cand
            cand_node[cand] = v
            cand_port[cand] = D * W + q
    return {
        "node_ports": node_ports,
        "cand_node": cand_node,
        "cand_port": cand_port,
    }


def _lower_plan(pl_: MulticastPlan, t: int, rows: list, flits: int) -> None:
    """Append one row per packet, matching WormholeSim.add_plan semantics."""
    idx_map: list[int | None] = []  # plan-local path index -> global pid
    for path in pl_.paths:
        if len(path.hops) == 1:
            # degenerate source-only path: delivered instantly, no packet
            # (none of the shipped planners emit one as a parent).
            idx_map.append(None)
            continue
        par = None
        if path.parent is not None:
            par = idx_map[path.parent]
            assert par is not None, "parent path must carry flits"
        # deliveries may be empty: transit segments of a degraded-topology
        # monotone-segmented plan relay the worm without absorbing a copy
        assert path.hops[0] not in path.deliveries
        idx_map.append(len(rows))
        rows.append((path.hops, list(path.deliveries), t, par, flits))


def stack_traffic(
    traffics: list[CompiledTraffic],
) -> tuple[CompiledTraffic, dict[str, np.ndarray]]:
    """Pad a batch to common (P, S) and stack every array on a new axis 0.

    Returns the first (re-padded) element as the shared-static reference plus
    the dict of stacked arrays ``{field: (B, ...)}`` that feeds the vmapped
    runner. All elements must share geometry and id spaces.
    """
    t0 = traffics[0]
    for t in traffics[1:]:
        if (t.n, t.m, t.kind, t.params) != (t0.n, t0.m, t0.kind, t0.params):
            raise ValueError("cannot batch traffic across different topologies")
    Pp = max(t.enqueue.shape[0] for t in traffics)
    Sp = max(t.max_stages for t in traffics)
    Qp = max(t.lane_seq.shape[1] for t in traffics)
    Cp = max(t.child_parent.shape[0] for t in traffics)
    QCp = max(t.chl.shape[1] for t in traffics)

    def pad(t: CompiledTraffic) -> CompiledTraffic:
        dp = Pp - t.enqueue.shape[0]
        ds = Sp - t.max_stages
        pad1 = lambda a, fill: np.pad(a, (0, dp), constant_values=fill)
        pad2 = lambda a, fill=0: np.pad(
            a, ((0, dp), (0, ds)), constant_values=fill
        )
        dc = Cp - t.child_parent.shape[0]
        padc = lambda a, fill: np.pad(a, (0, dc), constant_values=fill)
        return CompiledTraffic(
            n=t.n, m=t.m, kind=t.kind, params=t.params, ports=t.ports,
            num_nodes=t.num_nodes,
            num_links=t.num_links, horizon=t.horizon,
            enqueue=pad1(t.enqueue, NEVER), parent=pad1(t.parent, -1),
            release_stage=pad1(t.release_stage, -1), lane=pad1(t.lane, 0),
            num_stages=pad1(t.num_stages, 1), flits=pad1(t.flits, 1),
            eject_node=pad1(t.eject_node, 0),
            valid=pad1(t.valid, False),
            link=pad2(t.link), vcls=pad2(t.vcls),
            deliver=pad2(t.deliver), dslot=pad2(t.dslot, -1),
            node=pad2(t.node),
            lane_seq=np.pad(
                t.lane_seq, ((0, 0), (0, Qp - t.lane_seq.shape[1])),
                constant_values=-1,
            ),
            child_ix=pad1(t.child_ix, -1),
            child_pid=padc(t.child_pid, 0),
            child_parent=padc(t.child_parent, 0),
            child_rs=padc(t.child_rs, NEVER),
            child_enq=padc(t.child_enq, NEVER),
            watch_link=padc(t.watch_link, 0),
            chl=np.pad(
                t.chl, ((0, 0), (0, QCp - t.chl.shape[1])),
                constant_values=-1,
            ),
        )

    padded = [pad(t) for t in traffics]
    fields = (
        "enqueue", "parent", "release_stage", "lane", "num_stages", "flits",
        "eject_node", "valid", "link", "vcls", "deliver", "dslot", "node",
        "lane_seq", "child_ix", "child_pid", "child_parent", "child_rs",
        "child_enq", "watch_link", "chl",
    )
    stacked = {f: np.stack([getattr(t, f) for t in padded]) for f in fields}
    return padded[0], stacked


def traffic_from_numpy(
    stacked: dict[str, np.ndarray], device: torch.device | str = "cuda",
) -> dict[str, torch.Tensor]:
    """The stacked compile arrays of ``stack_traffic`` (this package's or the
    reference's) as tensors on ``device``, with the same dtypes."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in stacked.items()
    }


def planes_from_numpy(
    planes, device: torch.device | str = "cuda",
) -> CycleState:
    """A ``CycleState`` whose planes are numpy arrays (or any array the
    reference returns) as tensors on ``device``, dtypes kept. Planes carry
    the batch axis first, as the port's engine expects."""
    dev = resolve_device(device)
    return CycleState(*(
        torch.from_numpy(np.array(p, copy=True, order="C")).to(dev)
        for p in planes
    ))
