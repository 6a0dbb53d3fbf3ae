"""Device-side batched planning + the canonical plan arena.

Twin of ``repro.core.batch_planner``. ``plan()`` is a host-side Python loop
behind an LRU — fine for one multicast at a time, not for serving-scale
request streams where planning itself is the hot path. This module plans
*batches*: pack B (src, dest-set) instances into ``(B, NN)`` destination
masks, run Algorithm 1 for all of them in one ``dpm_plan_exact`` dispatch of
PyTorch ops on the planner's device (``kernels.dpm_cost.ops`` — full
Definition 2, C_t and C_p, MU/DP modes, greedy pick order), and decode the
resulting partition tensors into ``MulticastPlan``s only for arena misses.

The correctness contract is **bit-identity with the host planner**: every
decoded plan equals ``plan(algo, topo, src, dests, cost_model=...)`` field
for field. Three things make that hold:

* the decode step rebuilds paths through the exact host construction code
  (``planner._emit_dpm_partition``) from the device-chosen partitions,
  representatives, modes, and pick order;
* a label-chain decomposition prices C_p exactly on device: a label-ordered
  chain is the concatenation of pairwise label routes between consecutive
  members (the dual-path rule never passes a pending member early), so C_p
  reduces to a prefix scan over dense pairwise price matrices;
* ``batch_support`` gates batching on *exactness*: every price must be a
  dyadic rational (multiple of 1/256) small enough that float32 sums stay
  exact in any order, the cost model must price routes edge-additively,
  and the fabric must be healthy (degraded topologies detour through BFS
  fallback hops that break the chain decomposition — those always take
  the host path).

Anything outside the gate — degraded fabrics, non-dyadic objectives
(energy), algorithms without a device twin (MU, MP, NMP), unregistered
algorithms/models, oversized fabrics — falls back to the host ``plan()``
transparently; the arena caches either way. ``BatchPlanner``,
``planner_for`` and ``bulk_plan`` take ``device=`` (default the card; a
missing card raises; ``device="cpu"`` runs the same PyTorch ops on the
host).
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .algo import (
    get_algorithm,
    get_cost_model,
    is_registered_algorithm,
    is_registered_cost_model,
    on_registry_change,
)
from .grid import Coord, MeshGrid
from .partition import candidate_ids_for, wedge_patterns
from .planner import (
    MulticastPlan,
    PacketPath,
    _emit_dpm_partition,
    canonical_dests,
    plan,
    plan_dpm,
    plan_dpm_e,
    segment_plan_for_faults,
)
from .routefn import provider_for, route_cost_matrices
from .routing import label_route, xy_route

# Dense lowering is O(NN^2) host work (once per topology/model, cached);
# cap it so a misconfigured huge fabric degrades to host planning instead
# of stalling on table construction.
MAX_ARENA_NODES = 1024
DEFAULT_ARENA_SIZE = 65_536
# Device dispatch granularity: misses are planned in fixed-size chunks
# (smaller batches pad to the next power of two, the reference's compiled
# shapes), so the decode of chunk k on the host overlaps the asynchronously
# launched device work of chunk k+1.
DISPATCH_CHUNK = 512

# Exactness gate: prices must be multiples of 1/SCALE and bounded so that
# any candidate-cost sum stays inside float32's exact-integer range (2^24
# in units of 1/SCALE). 1/256 covers every shipped dyadic model (hops,
# weighted with dyadic link weights, contention on power-of-two extents).
_SCALE = 256.0
_EXACT_LIMIT = float(2**24)


class _Support(NamedTuple):
    ok: bool
    reason: str


class ArenaInfo(NamedTuple):
    """Per-planner arena stats: lookup hits/misses, LRU bounds/evictions,
    and *planning attribution* — how many misses were planned on device
    (``batched_plans``, in ``dispatches`` device batches) vs on the host
    fallback path (``host_plans``)."""

    hits: int
    misses: int
    maxsize: int
    currsize: int
    evictions: int
    batched_plans: int
    host_plans: int
    dispatches: int


class ArenaCacheInfo(NamedTuple):
    """Aggregate arena stats across all live planners, mirroring
    ``planner.PlanCacheInfo``: ``by_key`` maps ``(algo, cost-model)`` to
    its hit/miss/eviction counters (cost-insensitive algorithms key with
    ``cm = ""``, as in the plan cache)."""

    hits: int
    misses: int
    maxsize: int
    currsize: int
    by_key: dict[tuple[str, str], dict[str, int]]


# ---------------------------------------------------------------------------
# Dense host tables (cached per topology / cost model)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def membership_table(topo: MeshGrid) -> np.ndarray:
    """(NN, NN) int32 wedge id of node ``v`` w.r.t. source ``u`` for every
    pair — the all-sources ``partition_membership`` table, built once per
    topology so batch packing is a row gather instead of per-request host
    geometry (-1 at the source)."""
    from ..kernels.dpm_cost.ops import partition_membership

    return partition_membership(topo, topo.nodes())


@functools.lru_cache(maxsize=256)
def _label_chain_matrices_cached(topo: MeshGrid, cm) -> tuple:
    NN = topo.num_nodes
    nodes = topo.nodes()
    provider = provider_for(topo)
    wh = np.zeros((NN, NN), np.float32)
    wl = np.zeros((NN, NN), np.float32)
    labels = {u: topo.label(*u) for u in nodes}
    # Per target, one label_step call per source plus memoized chain
    # resolution: cost[u] = link_cost(u, step(u)) + cost[step(u)] — O(NN)
    # per target instead of re-walking every route (shared suffixes).
    for v in nodes:
        iv = topo.idx(v)
        for high, w in ((True, wh), (False, wl)):
            srcs = [
                u for u in nodes
                if (labels[u] < labels[v]) == high and u != v
            ]
            nxt = {u: provider.label_step(topo, u, v, high) for u in srcs}
            cost: dict[Coord, float] = {v: 0.0}
            for u in srcs:
                stack = []
                cur = u
                while cur not in cost:
                    stack.append(cur)
                    cur = nxt[cur]
                c = cost[cur]
                for s in reversed(stack):
                    c = cm.link_cost(topo, s, nxt[s]) + c
                    cost[s] = c
                w[topo.idx(u), iv] = cost[u]
    return wh, wl


def label_chain_matrices(topo: MeshGrid, cost_model=None):
    """Dense pairwise label-route prices: ``wh[u, v]`` is the cost of the
    HIGH-subnetwork label route u -> v (defined for label(v) > label(u)),
    ``wl`` the LOW mirror — the tensors ``dpm_plan_exact``'s C_p chain
    scan gathers from. Cached per (topology, model) instance pair."""
    return _label_chain_matrices_cached(topo, get_cost_model(cost_model))


def _dyadic_exact(*arrays) -> bool:
    """True iff every value is a multiple of 1/_SCALE representable and
    summable exactly in float32 (see the exactness gate in batch_support)."""
    for a in arrays:
        q = np.asarray(a, np.float64) * _SCALE
        if not np.all(np.isfinite(q)) or np.any(q != np.round(q)):
            return False
    return True


def batch_support(topo: MeshGrid, algo="DPM", cost_model=None) -> _Support:
    """Can (topo, algo, cost_model) plan on the batched device path with
    the bit-identity guarantee? Returns (ok, reason) — the reason names the
    first failed gate, and callers fall back to host ``plan()`` on any."""
    a = get_algorithm(algo)
    if getattr(a, "_fn", None) not in (plan_dpm, plan_dpm_e):
        return _Support(False, f"algorithm {a.name!r} has no device twin")
    if not is_registered_algorithm(a):
        return _Support(False, f"algorithm {a.name!r} not registered")
    cm = get_cost_model(
        cost_model if cost_model is not None else a.default_cost_model
    )
    if not is_registered_cost_model(cm):
        return _Support(False, f"cost model {cm.name!r} not registered")
    if getattr(topo, "faults", ()):
        # BFS fallback hops on detoured label routes break the chain
        # decomposition; degraded fabrics always plan on the host.
        return _Support(False, "degraded topology (broken links)")
    if topo.num_nodes > MAX_ARENA_NODES:
        return _Support(
            False,
            f"{topo.num_nodes} nodes > MAX_ARENA_NODES ({MAX_ARENA_NODES})",
        )
    dist, w_uni, overhead = route_cost_matrices(topo, cm)
    from ..kernels.dpm_cost.dpm_cost import BIG

    if int(dist.max(initial=0)) * BIG + topo.num_nodes >= 2**31:
        return _Support(False, "route distances overflow the int32 rep key")
    wh, wl = label_chain_matrices(topo, cm)
    if not _dyadic_exact(w_uni, wh, wl, [overhead]):
        return _Support(
            False, f"cost model {cm.name!r} prices are not dyadic (f32-exact)"
        )
    bound = _SCALE * (
        4.0
        * topo.num_nodes
        * (max(w_uni.max(initial=0), wh.max(initial=0), wl.max(initial=0))
           + overhead + 1.0)
    )
    if bound >= _EXACT_LIMIT:
        return _Support(False, "cost magnitudes exceed the f32-exact range")
    # edge-additivity spot check: the chain decomposition (and the per-edge
    # matrix build) assumes route_cost == sum of link_cost over the route
    nodes = topo.nodes()
    for v in nodes[:: max(1, len(nodes) // 8)]:
        if v == nodes[0]:
            continue
        route = provider_for(topo).unicast(topo, nodes[0], v)
        edge_sum = sum(
            cm.link_cost(topo, x, y) for x, y in zip(route, route[1:])
        )
        if abs(cm.route_cost(topo, route) - edge_sum) > 1e-9:
            return _Support(
                False, f"cost model {cm.name!r} is not edge-additive"
            )
    return _Support(True, "")


# ---------------------------------------------------------------------------
# The batched planner + arena
# ---------------------------------------------------------------------------
class _Tables(NamedTuple):
    memb_rows: list  # membership as nested python lists (decode lookups)
    memb_d: torch.Tensor  # device copies
    labels_d: torch.Tensor
    order_d: torch.Tensor
    dist_d: torch.Tensor
    wuni_d: torch.Tensor
    wh_d: torch.Tensor
    wl_d: torch.Tensor
    overhead: float


class BatchPlanner:
    """Batched DPM planner over one (topology, algorithm, cost model) with
    a bounded LRU arena of decoded ``MulticastPlan``s.

    ``plan_many(requests)`` is the entry point: arena lookups first
    (canonical keys — permuted duplicate requests hit one entry), then
    ``dpm_plan_exact`` on ``device`` over all unique misses in chunks,
    then host decode of the partition tensors. When ``support.ok`` is
    False every miss plans through host ``plan()`` instead (same results,
    same arena). Thread-safe: the plan server and direct callers may share
    an instance.
    """

    def __init__(self, topo: MeshGrid, algo="DPM", cost_model=None,
                 maxsize: int = DEFAULT_ARENA_SIZE, *,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.topo = topo
        self._algo = get_algorithm(algo)
        self._cm = get_cost_model(
            cost_model if cost_model is not None else
            self._algo.default_cost_model
        )
        self.maxsize = maxsize
        self.np_ = len(wedge_patterns(len(topo.from_idx(0))))
        self._cands = candidate_ids_for(self.np_)
        self.support = batch_support(topo, self._algo, self._cm)
        self._arena: "OrderedDict[tuple, MulticastPlan]" = OrderedDict()
        self._lock = threading.Lock()
        self._tables_cached: _Tables | None = None
        # Route memos for decode: (a, b) -> unicast hops, (a, b, high) ->
        # label-route segment past a. Naturally bounded by NN^2 (resp.
        # 2*NN^2) keys — node-pair tables, same order as the dense price
        # matrices this planner already holds.
        self._uni_memo: dict[tuple, tuple] = {}
        self._seg_memo: dict[tuple, tuple] = {}
        self._labmap: dict[Coord, int] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._batched = 0
        self._host = 0
        self._dispatches = 0

    # ------------------------------------------------------------- public
    def plan_many(self, requests) -> list[MulticastPlan]:
        """Plan ``[(src, dests), ...]``; returns plans in request order,
        each bit-identical to ``plan(algo, topo, src, dests, cost_model)``."""
        with self._lock:
            return self._plan_many_locked(list(requests))

    def plan_one(self, src: Coord, dests) -> MulticastPlan:
        return self.plan_many([(src, dests)])[0]

    def info(self) -> ArenaInfo:
        return ArenaInfo(
            self._hits, self._misses, self.maxsize, len(self._arena),
            self._evictions, self._batched, self._host, self._dispatches,
        )

    def clear(self) -> None:
        with self._lock:
            self._arena.clear()

    # ------------------------------------------------------------ internal
    def _plan_many_locked(self, requests) -> list[MulticastPlan]:
        keys = [
            (tuple(src), canonical_dests(dests)) for src, dests in requests
        ]
        out: list[MulticastPlan | None] = [None] * len(keys)
        missing: list[tuple] = []
        first_at: dict[tuple, int] = {}
        for i, key in enumerate(keys):
            hit = self._arena.get(key)
            if hit is not None:
                self._arena.move_to_end(key)
                self._hits += 1
                out[i] = hit
            else:
                self._misses += 1
                if key not in first_at:
                    first_at[key] = len(missing)
                    missing.append(key)
        if missing:
            if self.support.ok:
                plans = self._plan_batch(missing)
                self._batched += len(missing)
            else:
                plans = [
                    plan(self._algo, self.topo, src, list(dests),
                         cost_model=self._cm)
                    for src, dests in missing
                ]
                self._host += len(missing)
            for key, p in zip(missing, plans):
                self._arena[key] = p
                while len(self._arena) > self.maxsize:
                    self._arena.popitem(last=False)
                    self._evictions += 1
            for i, key in enumerate(keys):
                if out[i] is None:
                    out[i] = plans[first_at[key]]
        return out  # type: ignore[return-value]

    def _tables(self) -> _Tables:
        if self._tables_cached is None:
            from ..kernels.dpm_cost.ops import snake_labels

            dist, w_uni, overhead = route_cost_matrices(self.topo, self._cm)
            wh, wl = label_chain_matrices(self.topo, self._cm)
            labels = snake_labels(self.topo)
            memb = membership_table(self.topo)

            def dev(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

            self._tables_cached = _Tables(
                memb.tolist(),
                dev(memb),
                dev(labels),
                dev(np.argsort(labels).astype(np.int32)),
                dev(dist),
                dev(w_uni),
                dev(wh),
                dev(wl),
                float(overhead),
            )
        return self._tables_cached

    def _dispatch(self, keys: list[tuple]):
        """One ``dpm_plan_exact`` call over ≤ DISPATCH_CHUNK keys, padded to
        a power of two. Returns the device tensors *without* synchronizing
        — CUDA launches are asynchronous, so the caller can keep issuing
        chunks (and decoding earlier ones) while the card computes this
        one."""
        from ..kernels.dpm_cost.ops import dpm_plan_exact

        t = self._tables()
        g = self.topo
        NN = g.num_nodes
        Bp = 1 << max(0, len(keys) - 1).bit_length()
        mask = np.zeros((Bp, NN), bool)
        sidx = np.zeros(Bp, np.int32)
        for b, (src, dests) in enumerate(keys):
            sidx[b] = g.idx(src)
            for d in dests:
                mask[b, g.idx(d)] = True
        sidx_d = torch.from_numpy(sidx).to(self.device)
        return dpm_plan_exact(
            torch.from_numpy(mask).to(self.device),
            sidx_d,
            t.memb_d[sidx_d.long()],
            t.labels_d,
            t.order_d,
            t.dist_d,
            t.wuni_d,
            t.wh_d,
            t.wl_d,
            np_=self.np_,
            overhead=t.overhead,
            device=self.device,
        )

    def _plan_batch(self, keys: list[tuple]) -> list[MulticastPlan]:
        # Issue every chunk's device work first (async launches), then
        # decode in order — chunk k's host decode overlaps the card's work
        # on the chunks after it, so the pipeline costs ~max(device,
        # decode) instead of their sum.
        chunks = [
            keys[i : i + DISPATCH_CHUNK]
            for i in range(0, len(keys), DISPATCH_CHUNK)
        ]
        outs = [self._dispatch(ck) for ck in chunks]
        self._dispatches += len(chunks)
        plans: list[MulticastPlan] = []
        for ck, out in zip(chunks, outs):
            # one bulk device->host sync + python-list conversion per chunk
            # (per-element numpy scalar indexing in decode costs more than
            # the whole transfer)
            chosen, order, reps, modes = (x.tolist() for x in out[:4])
            plans.extend(
                self._decode(src, dests, chosen[b], order[b], reps[b],
                             modes[b])
                for b, (src, dests) in enumerate(ck)
            )
        return plans

    def _uni(self, a: Coord, b: Coord) -> list[Coord]:
        """Memoized ``xy_route`` (fresh list per call — plans own their
        hop lists)."""
        r = self._uni_memo.get((a, b))
        if r is None:
            r = self._uni_memo[(a, b)] = tuple(xy_route(self.topo, a, b))
        return list(r)

    def _chain(self, cur: Coord, dests, *, high: bool) -> list[Coord]:
        """Memoized ``path_multicast`` equivalent: the label-ordered chain
        is the concatenation of pairwise label routes between consecutive
        label-sorted members — the same decomposition ``dpm_plan_exact``
        prices C_p with, valid here because the support gate restricts the
        batched path to minimal (label-monotone) route providers, where a
        chain segment never passes a later pending destination early."""
        g = self.topo
        pending = [d for d in dests if d != cur]
        if not pending:
            return [cur]
        if not self._labmap:
            self._labmap.update((u, g.label(*u)) for u in g.nodes())
        pending.sort(key=self._labmap.__getitem__, reverse=not high)
        path = [cur]
        for t in pending:
            key = (path[-1], t, high)
            seg = self._seg_memo.get(key)
            if seg is None:
                seg = self._seg_memo[key] = tuple(
                    label_route(g, path[-1], t, high)[1:]
                )
            path.extend(seg)
        return path

    def _decode(self, src, dests, chosen, order, reps, modes) -> MulticastPlan:
        """Partition tensors -> MulticastPlan, in host emission order:
        merge winners by greedy pick round, then leftover singles by
        ascending candidate index (NO_ORDER sorts them after every round).
        Wedge assignment comes from the cached membership table (the same
        rows the device merge partitioned with), and paths are rebuilt
        through ``_emit_dpm_partition`` with memoized route primitives."""
        g = self.topo
        cands = self._cands
        row = self._tables().memb_rows[g.idx(src)]
        parts: list[list[Coord]] = [[] for _ in range(self.np_)]
        for d in dests:
            parts[row[g.idx(d)]].append(d)
        picked = sorted(
            (ci for ci in range(len(cands)) if chosen[ci]),
            key=lambda ci: (order[ci], ci),
        )
        p = MulticastPlan(self._algo.name, src, list(dests))
        for ci in picked:
            union: list[Coord] = []
            for i in cands[ci]:
                union.extend(parts[i])
            if not union:
                continue
            rep = g.from_idx(reps[ci])
            if len(union) == 1:
                # singleton partition: rep is the lone member, the emission
                # is exactly the S->R head delivering at R (both modes) —
                # skip the general machinery
                p.paths.append(PacketPath(self._uni(src, rep), [rep]))
                continue
            mode = "MU" if modes[ci] else "DP"
            _emit_dpm_partition(
                p, g, src, union, rep, mode,
                unicast=self._uni, chain=self._chain,
            )
        if getattr(g, "needs_bfs_routes", False):
            # BFS unicast hops are not label-monotone: the same worm split
            # as host ``plan()`` on a chiplet package
            p = segment_plan_for_faults(p, g)
        return p


# ---------------------------------------------------------------------------
# Module-level planner registry (the bulk-planning backend consumers use)
# ---------------------------------------------------------------------------
_PLANNERS: "OrderedDict[tuple, BatchPlanner]" = OrderedDict()
_MAX_PLANNERS = 64
_PLANNERS_LOCK = threading.Lock()


def planner_for(topo: MeshGrid, algo="DPM", cost_model=None,
                maxsize: int = DEFAULT_ARENA_SIZE, *,
                device: torch.device | str = "cuda") -> BatchPlanner:
    """The shared ``BatchPlanner`` for (topo, algo, cost-model, device) —
    one arena per combination, so every consumer (xsim compile, the plan
    server, ``WormholeSim.add_requests``, ``dist.schedule_multicasts``,
    trace replay, direct callers) reuses plans the others already
    decoded."""
    dev = resolve_device(device)
    a = get_algorithm(algo)
    cm = get_cost_model(
        cost_model if cost_model is not None else a.default_cost_model
    )
    key = (topo, a.name, cm.name if a.cost_sensitive else "", dev)
    with _PLANNERS_LOCK:
        pl = _PLANNERS.get(key)
        if pl is not None:
            _PLANNERS.move_to_end(key)
            return pl
        pl = BatchPlanner(topo, a, cm, maxsize=maxsize, device=dev)
        _PLANNERS[key] = pl
        while len(_PLANNERS) > _MAX_PLANNERS:
            _PLANNERS.popitem(last=False)
        return pl


def bulk_plan(topo: MeshGrid, requests, algo="DPM", cost_model=None, *,
              device: torch.device | str = "cuda") -> list[MulticastPlan]:
    """Plan a request list ``[(src, dests), ...]`` through the shared plan
    arena: ``dpm_plan_exact`` on ``device`` for all arena misses where the
    batched path is supported, host ``plan()`` otherwise. Always returns
    plans bit-identical to per-request ``plan()`` calls, in request order.

    This is the bulk-planning backend that ``xsim.compile_workload``,
    ``WormholeSim.add_requests``, ``dist.schedule_multicasts`` and trace
    replay route through, as their twins in the reference do.
    """
    dev = resolve_device(device)
    requests = list(requests)
    if not requests:
        return []
    a = get_algorithm(algo)
    cm = get_cost_model(
        cost_model if cost_model is not None else a.default_cost_model
    )
    if not is_registered_algorithm(a) or (
        a.cost_sensitive and not is_registered_cost_model(cm)
    ):
        # unregistered instances cannot key an arena (the name would not
        # resolve back); plan uncached exactly as plan() itself would
        return [
            plan(a, topo, src, list(dests), cost_model=cm)
            for src, dests in requests
        ]
    return planner_for(topo, a, cm, device=dev).plan_many(requests)


def arena_info() -> ArenaCacheInfo:
    """Aggregate stats over every live arena, shaped like
    ``planner.plan_cache_info()`` (hits/misses/maxsize/currsize + per-
    (algo, cost-model) attribution)."""
    hits = misses = maxsize = currsize = 0
    by_key: dict[tuple[str, str], dict[str, int]] = {}
    with _PLANNERS_LOCK:
        items = list(_PLANNERS.items())
    for (_, algo, cmk, _), pl in items:
        i = pl.info()
        hits += i.hits
        misses += i.misses
        maxsize += i.maxsize
        currsize += i.currsize
        st = by_key.setdefault(
            (algo, cmk), {"hits": 0, "misses": 0, "evictions": 0}
        )
        st["hits"] += i.hits
        st["misses"] += i.misses
        st["evictions"] += i.evictions
    return ArenaCacheInfo(hits, misses, maxsize, currsize, by_key)


def arena_clear() -> None:
    """Drop every planner (and its arena). Also the registry-mutation hook:
    arenas key plans by algorithm/cost-model *name*, so a re-registered
    name must not serve stale plans — same contract as the plan cache."""
    with _PLANNERS_LOCK:
        _PLANNERS.clear()


on_registry_change(arena_clear)
