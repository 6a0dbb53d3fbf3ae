"""Multicast scheduling on the accelerator torus: the planning half.

Twin of the scheduling half of ``repro.dist.multicast`` (pure Python and
numpy there; a copy adapted to the port, not an import). The paper's DPM
is a NoC routing optimization; this module lifts it one level up: given a
batch of concurrent multicast requests on a wraparound torus (an
accelerator interconnect, or a 1-D rank ring for a data-parallel axis),
produce a round-based store-and-forward schedule in which every round is a
partial permutation — one point-to-point exchange per round.

Pipeline:

1. plan each request with any ``repro_torch.core`` planner (default DPM)
   on the torus geometry, through the shared plan arena
   (``core.batch_planner.bulk_plan`` on ``device``: batched on the card
   where ``batch_support`` admits the fabric, host ``plan()`` otherwise,
   bit-identical either way);
2. decompose each wormhole packet path into *relay edges* ``holder ->
   next delivery`` — the path-order chain of a path-based multicast, with
   DPM's MU-mode children chained behind the representative's delivery;
3. greedily pack ready edges (sender already holds the payload) into rounds
   under the unique-sender / unique-receiver constraint.

``dp_broadcast_schedule`` specializes to a 1-D rank ring, and
``alltoall_schedule`` builds the all-to-all that expert-parallel dispatch
uses. ``Schedule.cost`` prices a schedule with an alpha-beta-hop model for
benchmark comparisons. The executors (``apply_schedule``,
``apply_alltoall_schedule``) run a schedule on rank-local tensors along
one axis of a ``DeviceMesh``: each round is one ``batch_isend_irecv`` on
the axis's group (the reference's one ``jax.lax.ppermute`` per round), and
both are differentiable (each round's transpose is the reversed pairs, run
in reverse round order).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from ..core.batch_planner import bulk_plan
from ..core.grid import Coord
from ..core.planner import MulticastPlan, plan
from ..core.routefn import faulty
from ..core.topology import Topology, Torus, torus  # Torus re-exported (dist)
from .comm import Axis, exchange

# Alpha-beta-hop calibration constants for Schedule.cost: per-round software/
# launch latency, per-hop fall-through, per-link bandwidth. Absolute values
# are ICI-ballpark; benchmarks compare algorithms *relatively*, exactly as
# the NoC EnergyModel does for power.
ALPHA_US = 1.0
HOP_US = 0.3
LINK_GBPS = 45.0


@dataclass
class Schedule:
    """Round-based store-and-forward multicast schedule.

    ``rounds[r]`` is a list of ``(sender_rank, receiver_rank)`` pairs and
    ``hops[r]`` the matching hop distances along the planned paths. Each
    round has unique senders and unique receivers, so it maps 1:1 onto one
    point-to-point permutation round; a sender only ever forwards a payload
    delivered to it in an earlier round (store-and-forward causality, per
    request).
    ``round_reqs[r]`` attributes each transfer to its request index.
    """

    num_ranks: int
    rounds: list[list[tuple[int, int]]]
    hops: list[list[int]] = field(default_factory=list)
    round_reqs: list[list[int]] = field(default_factory=list)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def total_hops(self) -> int:
        return sum(sum(h) for h in self.hops)

    def cost(
        self,
        payload_bytes: int,
        alpha_us: float = ALPHA_US,
        hop_us: float = HOP_US,
        link_gbps: float = LINK_GBPS,
        req_payload_bytes: dict[int, int] | None = None,
    ) -> dict:
        """Alpha-beta-hop price: per round one collective launch (alpha),
        payload serialization at link bandwidth, and the longest transfer's
        fall-through latency; ``link_bytes`` is total payload-hops moved.

        ``req_payload_bytes`` maps request index -> per-transfer bytes for
        schedules whose requests carry different payloads (an expert-
        parallel all-to-all moves one chunk per (src, dst) pair, not the
        full buffer); round serialization is then the round's largest
        transfer and unmapped requests fall back to ``payload_bytes``.
        """
        time_us = 0.0
        link_bytes = 0.0
        reqs = self.round_reqs or [[] for _ in self.hops]
        for rh, rr in zip(self.hops, reqs):
            if req_payload_bytes is None or len(rr) != len(rh):
                # no (usable) request attribution: uniform payload per
                # transfer, so a missing round_reqs can't drop transfers
                sizes = [payload_bytes] * len(rh)
            else:
                sizes = [req_payload_bytes.get(r, payload_bytes) for r in rr]
            ser_us = max(sizes, default=payload_bytes) / (link_gbps * 1e3)
            time_us += alpha_us + ser_us + hop_us * max(rh, default=0)
            link_bytes += sum(b * h for b, h in zip(sizes, rh))
        return {
            "rounds": self.num_rounds,
            "time_us": time_us,
            "link_bytes": link_bytes,
        }


def _relay_edges(p: MulticastPlan) -> list[tuple[Coord, Coord, int]]:
    """Decompose a plan into (holder, receiver, hops-along-path) edges.

    A path-based multicast delivers in path order, so each delivery can be
    served by the previous delivery point (or the injection node) relaying
    the payload — the store-and-forward rendering of one wormhole worm.
    Child paths start where their parent's header released them: at a
    *delivery* for DPM MU-mode re-injections, or at a transit boundary for
    the degraded-topology monotone segments (core.planner
    ``segment_plan_for_faults``). A transit boundary does not logically
    hold the payload at the collectives level, so each path's first edge
    is anchored at the nearest *delivered* point (or the root injection
    node) walking back through the ancestor chain, with hop counts
    accumulated along the way — segmentation leaves the edge set of the
    unsegmented plan unchanged.
    """
    edges: list[tuple[Coord, Coord, int]] = []

    def _entry(i: int) -> tuple[Coord, int]:
        """(nearest holder at/before path i's injection, hops back to it)."""
        node, back = p.paths[i].hops[0], 0
        j = p.paths[i].parent
        while j is not None:
            par = p.paths[j]
            pos = par.hops.index(node, 1)
            best = None  # latest delivery of par at/before pos
            for d in par.deliveries:
                dpos = par.hops.index(d, 1)
                if dpos <= pos and (best is None or dpos > best[1]):
                    best = (d, dpos)
            if best is not None:
                return best[0], back + (pos - best[1])
            back += pos
            node, j = par.hops[0], par.parent
        return node, back

    for i, path in enumerate(p.paths):
        if not path.deliveries:
            continue  # pure transit segment: no absorption to serve
        holder, back = _entry(i)
        hpos = 0
        for d in path.deliveries:
            pos = next(
                k for k in range(hpos, len(path.hops)) if path.hops[k] == d
            )
            if d != holder:
                edges.append((holder, d, pos - hpos + back))
            holder, hpos, back = d, pos, 0
    return edges


def plan_torus_multicast(
    t: Topology,
    src: Coord,
    dests: list[Coord],
    algo="DPM",
    cost_model=None,
    broken_links: tuple = (),
) -> MulticastPlan:
    """DPM partitioning (Algorithm 1) reused on interconnect geometry.

    ``t`` is any registered topology: a 2-D wraparound torus (the name's
    origin), a 3-D ``torus3d`` (a TPU-pod ICI is a 3-D torus — wedge
    partitions become the 26 sign patterns), or a ``chiplet`` package
    (multi-die ICI with interposer crossings priced by ``link_weight``).

    ``algo`` resolves through the routing-algorithm registry (name or
    ``RoutingAlgorithm`` instance; unknown names raise listing what is
    registered) and ``cost_model`` optionally overrides the objective.
    ``broken_links`` degrades the topology (``core.routefn.faulty``): plans
    then detour around the broken ICI links — the failed-link collective
    case — and an unreachable rank raises ``DisconnectedError``.
    Returns the same MulticastPlan structure the NoC simulator consumes;
    paths take shortest wraparound legs and partitions are the torus wedges.
    """
    if broken_links:
        t = faulty(t, tuple(broken_links))
    return plan(algo, t, src, list(dests), cost_model=cost_model)


def schedule_multicasts(
    topo: Topology,
    requests: list[tuple[Coord, list[Coord]]],
    algo="DPM",
    cost_model=None,
    broken_links: tuple = (),
    *,
    device: torch.device | str = "cuda",
) -> Schedule:
    """Schedule a batch of concurrent multicasts as permutation rounds.

    ``topo`` is any registered topology (2-D/3-D torus, mesh, chiplet
    package — ranks are ``topo.idx`` order). ``requests`` is a list of
    ``(src, dests)`` coordinate pairs on ``topo``;
    each is planned by any registered routing algorithm under ``cost_model``.
    ``broken_links`` (or passing an already-degraded ``FaultyTopology``)
    schedules on the degraded fabric: relay edges follow the detoured
    provider routes, so their hop counts — and ``Schedule.cost`` — price the
    fault set, while the round structure stays a valid set of permutations
    (rank-to-rank sends are link-agnostic at the collectives level).
    Payload identity is per-request: a node forwards request r only after an
    earlier round delivered r to it. Rounds are packed greedily in plan
    order, one send and one receive per rank per round. ``device`` is where
    ``bulk_plan`` plans DPM's batched misses (the card by default; a
    missing card raises; ``device="cpu"`` plans there).
    """
    if broken_links:
        topo = faulty(topo, tuple(broken_links))
    have: list[set[int]] = []
    pend: list[tuple[int, int, int, int]] = []  # (req, sender, receiver, hops)
    # bulk-plan the request batch through the shared plan arena (one device
    # dispatch for all arena misses on supported fabrics; bit-identical to
    # the per-request plan_torus_multicast calls it replaces)
    plans = bulk_plan(
        topo, [(src, dests) for src, dests in requests], algo,
        cost_model=cost_model, device=device,
    )
    for rid, ((src, dests), p) in enumerate(zip(requests, plans)):
        src_i = topo.idx(src)
        have.append({src_i})
        targeted: set[int] = set()
        for s, d, h in _relay_edges(p):
            si, di = topo.idx(s), topo.idx(d)
            if di in targeted or di == src_i:
                continue  # already served by an earlier edge of this request
            targeted.add(di)
            pend.append((rid, si, di, h))

    rounds: list[list[tuple[int, int]]] = []
    hops: list[list[int]] = []
    round_reqs: list[list[int]] = []
    while pend:
        used_s: set[int] = set()
        used_d: set[int] = set()
        rnd: list[tuple[int, int]] = []
        rh: list[int] = []
        rr: list[int] = []
        nxt: list[tuple[int, int, int, int]] = []
        for e in pend:
            rid, s, d, h = e
            if s in have[rid] and s not in used_s and d not in used_d:
                used_s.add(s)
                used_d.add(d)
                rnd.append((s, d))
                rh.append(h)
                rr.append(rid)
            else:
                nxt.append(e)
        if not rnd:  # cannot happen: every chain is rooted at a source
            raise RuntimeError("multicast schedule stalled")
        for rid, (_, d) in zip(rr, rnd):
            have[rid].add(d)
        rounds.append(rnd)
        hops.append(rh)
        round_reqs.append(rr)
        pend = nxt
    return Schedule(topo.num_nodes, rounds, hops, round_reqs)


def dp_broadcast_schedule(num_ranks: int, algo="DPM", cost_model=None, *,
                          device: torch.device | str = "cuda") -> Schedule:
    """Broadcast rank 0 -> all ranks on a 1-D ring (a data-parallel axis).

    The ring is ``Torus(num_ranks, 1)``; with DPM the destination set splits
    into the two ring directions and each side is a relay chain, roughly
    halving the rounds of MU's one-send-per-round direct scheme.
    """
    ring = torus(num_ranks, 1)
    dests = [(i, 0) for i in range(1, num_ranks)]
    return schedule_multicasts(ring, [((0, 0), dests)], algo, cost_model,
                               device=device)


def ring_broadcast_schedule(num_ranks: int) -> Schedule:
    """Baseline store-and-forward ring broadcast: rank 0's payload relays
    neighbor-to-neighbor, one 1-hop transfer per round, ``n - 1`` rounds."""
    rounds = [[(i, i + 1)] for i in range(num_ranks - 1)]
    hops = [[1] for _ in range(num_ranks - 1)]
    reqs = [[0] for _ in range(num_ranks - 1)]
    return Schedule(num_ranks, rounds, hops, reqs)


def _a2a_req(num_ranks: int, rid: int) -> tuple[int, int]:
    """Request index -> (src, dst) for the all-to-all request ordering."""
    src, k = divmod(rid, num_ranks - 1)
    dst = k if k < src else k + 1
    return src, dst


def a2a_req_id(num_ranks: int, src: int, dst: int) -> int:
    """(src, dst) -> request index (inverse of ``_a2a_req``)."""
    return src * (num_ranks - 1) + (dst if dst < src else dst - 1)


@functools.lru_cache(maxsize=None)
def alltoall_schedule(num_ranks: int, algo: str = "DPM", *,
                      device: torch.device | str = "cuda") -> Schedule:
    """All-to-all on a 1-D ring as registry-planned permutation rounds.

    Each of the ``n(n-1)`` (src, dst) chunks is its own unicast request (a
    chunk is a *distinct* payload, so relay chains cannot serve it); the
    planner contributes the wraparound shortest-path hop counts and the
    greedy packer fills rounds under the permutation constraint.  Request
    indices follow ``a2a_req_id`` so executors can recover (src, dst).

    Every transfer is asserted to originate at its request's source —
    the property expert-parallel dispatch relies on to ship each chunk
    directly. Cached per ``(num_ranks, algo, device)``: the greedy packer
    is pure Python (seconds at 256 ranks), a second call is free.
    """
    ring = torus(num_ranks, 1)
    requests = [
        ((src, 0), [(dst, 0)])
        for rid in range(num_ranks * (num_ranks - 1))
        for src, dst in [_a2a_req(num_ranks, rid)]
    ]
    sched = schedule_multicasts(ring, requests, algo, device=device)
    for rnd, rr in zip(sched.rounds, sched.round_reqs):
        for (s, d), rid in zip(rnd, rr):
            src, dst = _a2a_req(num_ranks, rid)
            assert (s, d) == (src, dst), (s, d, src, dst)
    return sched


def ring_alltoall_schedule(num_ranks: int) -> Schedule:
    """Baseline shift all-to-all: round ``r`` is the +r rotation, every
    transfer walking the full ``r`` hops one way around the ring (no
    wraparound shortcut — the classic ring-shift collective)."""
    rounds, hops, reqs = [], [], []
    for r in range(1, num_ranks):
        rounds.append([(i, (i + r) % num_ranks) for i in range(num_ranks)])
        hops.append([r] * num_ranks)
        reqs.append(
            [a2a_req_id(num_ranks, i, (i + r) % num_ranks) for i in range(num_ranks)]
        )
    return Schedule(num_ranks, rounds, hops, reqs)


def _check_ranks(sched: Schedule, ax: Axis) -> None:
    if sched.num_ranks != ax.n:
        raise ValueError(f"schedule of {sched.num_ranks} ranks on an axis of "
                         f"{ax.n}")


def _adopt_rounds(x: torch.Tensor, rounds, ax: Axis) -> torch.Tensor:
    """``apply_schedule``'s forward: per round the receiver adopts the
    sender's payload."""
    for rnd in rounds:
        src = next((s for s, d in rnd if d == ax.me), None)
        dst = next((d for s, d in rnd if s == ax.me), None)
        y = torch.empty_like(x) if src is not None else None
        exchange(ax, [] if dst is None else [(dst, x)],
                 [] if src is None else [(src, y)])
        if y is not None:
            x = y
    return x


def _adopt_rounds_transpose(ct: torch.Tensor, rounds, ax: Axis) -> torch.Tensor:
    """The transpose of ``_adopt_rounds``: rounds in reverse, each pair
    reversed; a receiver hands its cotangent back to its sender (and keeps
    none), a sender adds what its receiver hands back."""
    for rnd in reversed(rounds):
        src = next((s for s, d in rnd if d == ax.me), None)
        dst = next((d for s, d in rnd if s == ax.me), None)
        back = torch.empty_like(ct) if dst is not None else None
        exchange(ax, [] if src is None else [(src, ct)],
                 [] if dst is None else [(dst, back)])
        if src is not None:
            ct = torch.zeros_like(ct)
        if back is not None:
            ct = ct + back
    return ct


def _alltoall_rounds(chunks: torch.Tensor, rounds, ax: Axis) -> torch.Tensor:
    """``apply_alltoall_schedule``'s forward."""
    out = torch.zeros_like(chunks)
    out[ax.me] = chunks[ax.me]
    for rnd in rounds:
        src = next((s for s, d in rnd if d == ax.me), None)
        dst = next((d for s, d in rnd if s == ax.me), None)
        exchange(ax, [] if dst is None else [(dst, chunks[dst])],
                 [] if src is None else [(src, out[src])])
    return out


def _alltoall_rounds_transpose(ct: torch.Tensor, rounds,
                               ax: Axis) -> torch.Tensor:
    """The transpose of ``_alltoall_rounds``: a receiver hands slot
    ``src``'s cotangent back to ``src`` and clears the slot; a sender adds
    what comes back into the chunk it shipped; the own slot's cotangent
    goes to the own chunk."""
    ct = ct.clone()
    grad = torch.zeros_like(ct)
    for rnd in reversed(rounds):
        src = next((s for s, d in rnd if d == ax.me), None)
        dst = next((d for s, d in rnd if s == ax.me), None)
        back = torch.empty_like(ct[0]) if dst is not None else None
        exchange(ax, [] if src is None else [(src, ct[src].clone())],
                 [] if dst is None else [(dst, back)])
        if src is not None:
            ct[src] = 0
        if back is not None:
            grad[dst] += back
    grad[ax.me] += ct[ax.me]
    return grad


class _Rounds(torch.autograd.Function):
    """A schedule's rounds with their transpose as the backward: every rank
    posts its rounds in the same order both ways."""

    @staticmethod
    def forward(ctx, x, rounds, ax: Axis, fwd, bwd):
        ctx.rounds, ctx.ax, ctx.bwd = rounds, ax, bwd
        out = fwd(x, rounds, ax)
        return x.clone() if out is x else out

    @staticmethod
    def backward(ctx, ct):
        return ctx.bwd(ct.contiguous(), ctx.rounds, ctx.ax), None, None, None, None


def apply_schedule(x: torch.Tensor, sched: Schedule, mesh,
                   axis: str) -> torch.Tensor:
    """Execute a Schedule on a rank-local tensor along ``axis`` of
    ``mesh``: one ``batch_isend_irecv`` per round; receivers adopt the
    incoming payload, all other ranks keep theirs. Only meaningful for
    single-request (broadcast-like) schedules, where every transfer carries
    the same logical payload. Differentiable."""
    ax = Axis(mesh, axis)
    _check_ranks(sched, ax)
    return _Rounds.apply(x, [list(r) for r in sched.rounds], ax,
                         _adopt_rounds, _adopt_rounds_transpose)


def apply_alltoall_schedule(chunks: torch.Tensor, sched: Schedule, mesh,
                            axis: str) -> torch.Tensor:
    """Execute an ``alltoall_schedule`` on rank-local chunks along ``axis``
    of ``mesh``.

    ``chunks[j]`` is this rank's payload for rank ``j``; the result's row
    ``i`` is the chunk rank ``i`` addressed to this rank, the own row is
    ``chunks[me]`` and a row that receives nothing is zero. Each round is
    one ``batch_isend_irecv``: senders ship the chunk for their round
    receiver, receivers store the incoming chunk under the sender's slot
    (the schedule's transfers are direct src -> dst, so a sender always
    holds what it sends). Differentiable."""
    ax = Axis(mesh, axis)
    _check_ranks(sched, ax)
    if chunks.shape[0] != ax.n:
        raise ValueError(f"chunks leading dim {chunks.shape[0]} != {ax.n} "
                         "ranks")
    return _Rounds.apply(chunks.contiguous(), [list(r) for r in sched.rounds],
                         ax, _alltoall_rounds, _alltoall_rounds_transpose)
