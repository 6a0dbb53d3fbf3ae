"""Multicast planners: MU, DP (dual-path), MP (multipath), NMP, DPM.

Each planner maps (source, destination set) -> MulticastPlan: a list of
physical packet paths. A path is an explicit hop sequence plus the set of
nodes where a copy is absorbed. DPM paths may spawn *child* packets at the
representative node (the MU-mode re-injection); the simulator honours the
dependency, and hop-count accounting sums parent and child paths.

These planners run on the host. The port's twin of ``repro.core.planner``:
the batched device planner (``core.batch_planner``, the ``dpm_cost`` kernels)
comes with a later slice, and its contract is plans bit-identical to
``plan()`` here.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import NamedTuple

from .algo import (
    CostModel,
    available_algorithms,
    get_algorithm,
    get_cost_model,
    is_registered_algorithm,
    is_registered_cost_model,
    on_registry_change,
    register_algorithm,
)
from .grid import Coord, MeshGrid
from .partition import dpm_partition
from .routing import greedy_tour, path_multicast, xy_route
from .topology import make_topology


@dataclass
class PacketPath:
    """One wormhole packet: hops[0] is the injection node."""

    hops: list[Coord]
    deliveries: list[Coord]
    parent: int | None = None  # index of parent path; injected when the
    # parent delivers at hops[0] (DPM MU re-injection)

    @property
    def hop_count(self) -> int:
        return len(self.hops) - 1


@dataclass
class MulticastPlan:
    algorithm: str
    src: Coord
    dests: list[Coord]
    paths: list[PacketPath] = field(default_factory=list)

    @property
    def total_hops(self) -> int:
        return sum(p.hop_count for p in self.paths)

    def check_covers(self) -> bool:
        delivered = set()
        for p in self.paths:
            delivered |= set(p.deliveries)
        return delivered == set(self.dests)


def canonical_dests(dests) -> tuple[Coord, ...]:
    """Intern a destination set to its canonical key: sorted unique tuple.

    The single canonicalization point shared by the plan cache
    (``_plan_cached``), the device plan arena (``core.batch_planner``), and
    the dist schedule builders — permuted or duplicated destination lists
    all map to the same entry. Coordinates arriving as lists are normalized
    to tuples so the result is always hashable.
    """
    return tuple(sorted({tuple(d) for d in dests}))


def _deliveries_on(path: list[Coord], dests: set[Coord]) -> list[Coord]:
    seen, out = set(), []
    for node in path:
        if node in dests and node not in seen:
            seen.add(node)
            out.append(node)
    return out


# --------------------------------------------------------------------------
# Baselines
# --------------------------------------------------------------------------
def plan_mu(g: MeshGrid, src: Coord, dests: list[Coord]) -> MulticastPlan:
    """Multiple unicast: one XY packet per destination."""
    plan = MulticastPlan("MU", src, list(dests))
    for d in dests:
        plan.paths.append(PacketPath(xy_route(g, src, d), [d]))
    return plan


def plan_dp(g: MeshGrid, src: Coord, dests: list[Coord]) -> MulticastPlan:
    """Dual-path [10]: D_H in ascending label order, D_L descending."""
    plan = MulticastPlan("DP", src, list(dests))
    ls = g.label(*src)
    d_h = [d for d in dests if g.label(*d) > ls]
    d_l = [d for d in dests if g.label(*d) < ls]
    for group, high in ((d_h, True), (d_l, False)):
        if group:
            path = path_multicast(g, src, group, high=high)
            plan.paths.append(PacketPath(path, _deliveries_on(path, set(group))))
    return plan


def _mp_groups(g: MeshGrid, src: Coord, dests: list[Coord]):
    """MP's static 4-way split: label high/low x {x < sx, x >= sx}."""
    ls = g.label(*src)
    sx = src[0]
    d_h = [d for d in dests if g.label(*d) > ls]
    d_l = [d for d in dests if g.label(*d) < ls]
    return (
        [d for d in d_h if d[0] < sx],  # D_H1
        [d for d in d_h if d[0] >= sx],  # D_H2
        [d for d in d_l if d[0] < sx],  # D_L1
        [d for d in d_l if d[0] >= sx],  # D_L2
    )


def plan_mp(g: MeshGrid, src: Coord, dests: list[Coord]) -> MulticastPlan:
    """Multipath [11]: four label-ordered path packets, one per static group."""
    plan = MulticastPlan("MP", src, list(dests))
    g_h1, g_h2, g_l1, g_l2 = _mp_groups(g, src, dests)
    for group, high in ((g_h1, True), (g_h2, True), (g_l1, False), (g_l2, False)):
        if group:
            path = path_multicast(g, src, group, high=high)
            plan.paths.append(PacketPath(path, _deliveries_on(path, set(group))))
    return plan


def plan_nmp(g: MeshGrid, src: Coord, dests: list[Coord]) -> MulticastPlan:
    """NMP [18]: MP's static partition, but nearest-first greedy tours with
    XY legs (destinations sorted by hop distance instead of label)."""
    plan = MulticastPlan("NMP", src, list(dests))
    for group in _mp_groups(g, src, dests):
        if group:
            path = greedy_tour(g, src, group)
            plan.paths.append(PacketPath(path, _deliveries_on(path, set(group))))
    return plan


# --------------------------------------------------------------------------
# DPM
# --------------------------------------------------------------------------
def _emit_dpm_partition(
    plan: MulticastPlan, g: MeshGrid, src: Coord, dests: list[Coord],
    rep: Coord, mode: str, *, unicast=None, chain=None,
) -> None:
    """Append one final partition's delivery paths to ``plan``.

    S --XY--> R head, then either the dual-path continuation (the chain
    continues into the larger label side; the other side is a sibling child
    re-injected at R) or MU-mode child unicasts. Shared by the host
    construction loop (``plan_dpm``) and the batched planner's decode step
    (``core.batch_planner``) — device-planned partitions decode through the
    exact code path host plans are built with, which is what makes the
    bit-identical contract hold structurally rather than by coincidence.

    ``unicast(a, b)`` / ``chain(a, group, high=...)`` override the route
    primitives (defaults: ``xy_route`` / ``path_multicast``). The batched
    decode passes memoized equivalents so repeated (src, rep) legs across a
    batch don't re-walk routes hop by hop; the partition-to-paths structure
    (DP split, larger-side-first, deliveries, parent links) stays here.
    """
    if unicast is None:
        unicast = functools.partial(xy_route, g)
    if chain is None:
        chain = functools.partial(path_multicast, g)
    head = unicast(src, rep)
    rest = [d for d in dests if d != rep]
    if mode == "DP" and rest:
        lr = g.label(*rep)
        d_h = [d for d in rest if g.label(*d) > lr]
        d_l = [d for d in rest if g.label(*d) < lr]
        # The chain continues into the *larger* side from the head packet;
        # the other side is a sibling packet re-injected at R.
        first, second = (d_h, d_l) if len(d_h) >= len(d_l) else (d_l, d_h)
        tail = chain(rep, first, high=first is d_h) if first else [rep]
        full = head + tail[1:]
        deliver = _deliveries_on(full, set(dests))
        parent_idx = len(plan.paths)
        plan.paths.append(PacketPath(full, deliver))
        if second:
            spath = chain(rep, second, high=second is d_h)
            plan.paths.append(
                PacketPath(
                    spath,
                    _deliveries_on(spath, set(second)),
                    parent=parent_idx,
                )
            )
    else:  # MU mode (or singleton partition)
        deliver = _deliveries_on(head, set(dests))
        parent_idx = len(plan.paths)
        plan.paths.append(PacketPath(head, deliver))
        remaining = [d for d in rest if d not in set(deliver)]
        for d in remaining:
            plan.paths.append(
                PacketPath(unicast(rep, d), [d], parent=parent_idx)
            )


def plan_dpm(
    g: MeshGrid,
    src: Coord,
    dests: list[Coord],
    include_source_leg: bool = True,
    max_merge: int = 3,
    *,
    cost_model: CostModel | str | None = None,
) -> MulticastPlan:
    """DPM: Algorithm 1 partitions, then per-partition delivery:

    S --XY--> R, then from R either dual-path (one packet continues) or
    multiple unicast (child packets re-injected at R). ``cost_model`` is
    the objective Algorithm 1's merge comparisons optimize (default: the
    paper's hop counting).
    """
    plan = MulticastPlan("DPM", src, list(dests))
    result = dpm_partition(g, src, dests, include_source_leg, max_merge, cost_model)
    for part in result.partitions:
        if not part.dests:
            continue
        assert part.rep is not None
        _emit_dpm_partition(plan, g, src, part.dests, part.rep, part.mode)
    return plan


def plan_dpm_e(
    g: MeshGrid,
    src: Coord,
    dests: list[Coord],
    *,
    cost_model: CostModel | str | None = None,
) -> MulticastPlan:
    """DPM-E: Algorithm 1 merging under the dynamic-energy objective.

    Identical machinery to DPM; only the cost model the merge loop compares
    candidates with changes (default "energy" — DESIGN.md §6). Shipped as
    the proof that a new algorithm is one registration: no consumer file
    (noc/, dist/, benchmarks/) mentions it by name.
    """
    p = plan_dpm(g, src, dests, cost_model="energy" if cost_model is None else cost_model)
    p.algorithm = "DPM-E"
    return p


# ---------------------------------------------------------------------------
# Deadlock-free segmentation on degraded topologies (DESIGN.md §7)
# ---------------------------------------------------------------------------
def _monotone_runs(g: MeshGrid, hops: list[Coord]) -> list[tuple[int, int]]:
    """Split a hop sequence into maximal label-monotone runs.

    Returns inclusive (start, end) index ranges; consecutive runs share the
    boundary node. A worm confined to one run crosses links of exactly one
    VC class (HIGH iff labels increase), which is the property the
    degraded-topology deadlock-freedom argument needs.
    """
    labs = [g.label(*h) for h in hops]
    runs: list[tuple[int, int]] = []
    start, direction = 0, 0
    for i in range(1, len(hops)):
        d = 1 if labs[i] > labs[i - 1] else -1
        if direction == 0:
            direction = d
        elif d != direction:
            runs.append((start, i - 1))
            start, direction = i - 1, d
    runs.append((start, len(hops) - 1))
    return runs


def segment_plan_for_faults(p: MulticastPlan, g: MeshGrid) -> MulticastPlan:
    """Decompose every packet into label-monotone worm segments.

    On a degraded topology detoured routes (and even clean dimension-ordered
    ones) mix label-increasing and label-decreasing hops, so a single worm
    can hold virtual channels in both subnetworks at once — which is exactly
    the cross-class hold-and-wait that wormhole deadlock needs (observed in
    simulation at high fault density). This pass splits each path at every
    label-direction reversal; the tail segments become child packets relayed
    cut-through at the boundary node's NI (the same VCTM-style parent/child
    fork both simulators already implement for DPM's MU re-injection). Every
    resulting worm is label-monotone, so each lives in exactly one VC class
    and the per-class channel dependency graphs are ordered by the
    Hamiltonian label — acyclic, hence deadlock-free at any fault density
    (DESIGN.md §7 has the full argument).

    Deliveries stay where the original path delivered them (a relay boundary
    is an NI absorption, not a multicast delivery); transit segments may
    carry none. Idempotent, and the identity on already-monotone plans.
    """
    segs = [_monotone_runs(g, path.hops) for path in p.paths]
    if all(len(s) <= 1 for s in segs):
        return p
    new_idx: list[list[int]] = []  # original path -> its new segment indices
    base = 0
    for s in segs:
        new_idx.append(list(range(base, base + len(s))))
        base += len(s)

    def _seg_at(op: int, pos: int) -> int:
        """New index of original path ``op``'s segment entering hop ``pos``."""
        for (s, e), ni in zip(segs[op], new_idx[op]):
            if s < pos <= e:
                return ni
        raise ValueError(f"position {pos} outside path {op}")

    out = MulticastPlan(p.algorithm, p.src, list(p.dests))
    for op, path in enumerate(p.paths):
        if len(path.hops) == 1:
            # degenerate source-only path (destination == source, e.g. MU):
            # carries no flits, nothing to segment — pass through verbatim
            parent = (
                None
                if path.parent is None
                else _seg_at(
                    path.parent,
                    p.paths[path.parent].hops.index(path.hops[0], 1),
                )
            )
            out.paths.append(
                PacketPath(list(path.hops), list(path.deliveries), parent=parent)
            )
            continue
        deliver_pos = {path.hops.index(d, 1): d for d in path.deliveries}
        for j, (s, e) in enumerate(segs[op]):
            if j == 0:
                parent = (
                    None
                    if path.parent is None
                    else _seg_at(
                        path.parent,
                        p.paths[path.parent].hops.index(path.hops[0], 1),
                    )
                )
            else:
                parent = new_idx[op][j - 1]
            out.paths.append(
                PacketPath(
                    path.hops[s : e + 1],
                    [d for pos, d in sorted(deliver_pos.items())
                     if s < pos <= e],
                    parent=parent,
                )
            )
    return out


# ---------------------------------------------------------------------------
# Registry-backed cached facade
# ---------------------------------------------------------------------------
register_algorithm(plan_mu, name="MU", tags=("fig",))
register_algorithm(plan_dp, name="DP")
register_algorithm(plan_mp, name="MP", tags=("fig",))
register_algorithm(plan_nmp, name="NMP", tags=("fig",))
register_algorithm(plan_dpm, name="DPM", cost_sensitive=True, tags=("fig",))
register_algorithm(
    plan_dpm_e, name="DPM-E", cost_sensitive=True, default_cost_model="energy"
)


class PlanCacheInfo(NamedTuple):
    """Plan-cache stats, field-compatible with ``lru_cache.cache_info()``."""

    hits: int
    misses: int
    maxsize: int
    currsize: int


# LRU cache over normalized plan keys (an OrderedDict, so the maxsize is a
# module-level value a test can shrink).
_PLAN_CACHE_MAXSIZE = 200_000
_plan_cache: "OrderedDict[tuple, MulticastPlan]" = OrderedDict()
_plan_hits = 0
_plan_misses = 0


def _plan_cached(
    kind: str,
    n: int,
    m: int,
    faults: tuple,
    params: tuple,
    algo: str,
    cost_model: str,
    src: Coord,
    dests: tuple[Coord, ...],
):
    global _plan_hits, _plan_misses
    key = (kind, n, m, faults, params, algo, cost_model, src, dests)
    cached = _plan_cache.get(key)
    if cached is not None:
        _plan_cache.move_to_end(key)
        _plan_hits += 1
        return cached
    _plan_misses += 1
    a = get_algorithm(algo)
    topo = make_topology(kind, n, m, faults, params)
    p = a.plan(
        topo, src, list(dests),
        cost_model=get_cost_model(cost_model or a.default_cost_model),
    )
    if faults:
        p = segment_plan_for_faults(p, topo)
    _plan_cache[key] = p
    while len(_plan_cache) > _PLAN_CACHE_MAXSIZE:
        _plan_cache.popitem(last=False)
    return p


def plan_cache_info() -> PlanCacheInfo:
    """(hits, misses, maxsize, currsize) of the shared plan cache."""
    return PlanCacheInfo(
        _plan_hits, _plan_misses, _PLAN_CACHE_MAXSIZE, len(_plan_cache)
    )


def plan_cache_clear() -> None:
    global _plan_hits, _plan_misses
    _plan_cache.clear()
    _plan_hits = 0
    _plan_misses = 0


on_registry_change(plan_cache_clear)


def plan(
    algo: "str | object",
    g: MeshGrid,
    src: Coord,
    dests: list[Coord],
    cost_model: CostModel | str | None = None,
) -> MulticastPlan:
    """Cached planner entry point (plans are deterministic per instance).

    ``algo`` is a registered algorithm name (or a ``RoutingAlgorithm``
    instance); ``cost_model`` a registered model name or instance, defaulting
    to the algorithm's own objective. The cache key is normalized —
    (topology kind, n, m, fault set, extra factory params, algorithm,
    cost-model, src, sorted unique dests) — so grid(8) and grid(8, 8) share
    one entry, mesh/torus plans of the same dimensions never collide, two
    cost models never alias one entry, and plans for different broken-link
    sets (``FaultyTopology``) never alias each other or the healthy plan.
    Cost-insensitive algorithms
    share one entry across models. Unregistered algorithm/cost-model
    instances plan uncached (the name key could not be trusted to resolve
    back to them). On a degraded topology every returned plan is segmented
    into label-monotone worms (``segment_plan_for_faults``), the
    deadlock-freedom guarantee of DESIGN.md §7.
    """
    a = get_algorithm(algo)
    if not a.supports(g):
        raise ValueError(
            f"routing algorithm {a.name!r} does not support topology kind "
            f"{g.kind!r} (supports: {', '.join(sorted(a.topologies))}); "
            f"algorithms available here: {', '.join(available_algorithms(g))}"
        )
    cm = get_cost_model(cost_model if cost_model is not None else a.default_cost_model)
    cacheable = is_registered_algorithm(a) and (
        not a.cost_sensitive or is_registered_cost_model(cm)
    )
    faults = getattr(g, "faults", ())
    if not cacheable:
        p = a.plan(g, src, dests, cost_model=cm)
        if faults:
            p = segment_plan_for_faults(p, g)
        return p
    cm_key = cm.name if a.cost_sensitive else ""
    return _plan_cached(
        g.kind, g.n, g.rows, faults, g.params, a.name, cm_key,
        src, canonical_dests(dests),
    )


class _PlannersView(Mapping):
    """Legacy ``PLANNERS`` mapping, now a live view over the registry.

    Keys are registered algorithm names; values plan through the cached
    facade with the legacy ``f(g, src, dests)`` signature.
    """

    def __getitem__(self, name: str):
        get_algorithm(name)  # unknown names raise, listing what exists
        return functools.partial(plan, name)

    def __iter__(self):
        return iter(available_algorithms())

    def __len__(self) -> int:
        return len(available_algorithms())


PLANNERS = _PlannersView()
