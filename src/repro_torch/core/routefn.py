"""Route-provider layer: pluggable routing functions + fault-aware topologies.

Every hop sequence in this repo used to come from three free functions in
``core/routing.py`` (dimension-ordered XY, the Lin-McKinley label rule, NMP's
greedy tour) that silently assumed a *fully working* mesh/torus. This module
lifts that assumption into an explicit layer (DESIGN.md §7):

* ``RouteProvider`` — the protocol the planners, cost models, and both
  simulators route through: ``unicast`` (full hop sequence), ``label_step``
  (one hop of the dual-path rule).
* ``MinimalRouteProvider`` — the paper's routing functions, verbatim. This is
  the provider every fault-free topology resolves to, so provider-backed
  routes are bit-identical to the legacy ``core/routing.py`` output there.
* ``FaultyTopology`` — any ``MeshGrid``/``Torus`` plus a set of broken
  (bidirectional) links. Geometry (labels, deltas, partitions) delegates to
  the base topology; ``neighbors`` drops broken links and ``distance``
  becomes the BFS shortest-path distance on the degraded graph, so
  Definition 1 representatives and Definition 2 costs adapt to faults.
* ``FaultAwareProvider`` — detours: the dimension-ordered route is kept
  whenever it is clean, otherwise the BFS shortest path on the degraded
  graph is used; the label rule falls back to a BFS hop when every
  label-legal neighbor link is broken. A destination cut off from the
  source raises ``DisconnectedError`` with the offending pair.

``provider_for(topo)`` resolves the provider: plain topologies (and
``faulty(topo, ())``, which returns the base unchanged) get the minimal
provider; degraded topologies get the fault-aware one. ``route_cost_matrices``
lowers a (topology, cost model) pair to the dense per-pair tensors the
weighted Pallas planner kernel (kernels/dpm_cost) consumes.
"""
from __future__ import annotations

import functools
import zlib
from collections import deque
from dataclasses import dataclass

import numpy as np

from .grid import Coord, MeshGrid

Link = tuple[Coord, Coord]

# Directed-link id space shared with noc.xsim: idx(u) * 4 + dir(u->v),
# directions ordered +x, -x, +y, -y (``MeshGrid.direction``).


class DisconnectedError(RuntimeError):
    """A routing destination is unreachable on the degraded topology."""


def _canon(topo: MeshGrid, u: Coord, v: Coord) -> Link:
    """Canonical (sorted) form of an undirected link."""
    u = topo.normalize(*u)
    v = topo.normalize(*v)
    return (u, v) if u <= v else (v, u)


# ---------------------------------------------------------------------------
# Fault model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultyTopology:
    """A mesh/torus with a set of broken bidirectional links.

    Wraps (rather than subclasses) the base topology: labeling, deltas,
    wedges, and coordinate handling are the base's — a fault changes which
    links a worm may cross, not where a node sits — while ``neighbors``
    excludes broken links and ``distance`` is the BFS shortest-path hop
    count on the degraded graph (computed lazily, cached per source).

    ``faults`` is the canonical sorted tuple of broken links; it is the
    component the planner cache keys on (``core.planner.plan``), so plans
    for different fault sets never alias. Instances are interned by the
    ``faulty`` factory, like ``grid``/``torus``.
    """

    base: MeshGrid
    faults: tuple[Link, ...]

    # -- delegated structure -------------------------------------------------
    @property
    def kind(self) -> str:  # algorithms' topology-capability checks pass
        return self.base.kind

    @property
    def wrap(self) -> bool:
        return self.base.wrap

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def m(self) -> int | None:
        return self.base.m

    @property
    def rows(self) -> int:
        return self.base.rows

    @property
    def num_nodes(self) -> int:
        return self.base.num_nodes

    @property
    def ports(self) -> int:
        return self.base.ports

    @property
    def params(self) -> tuple:
        return self.base.params

    def label(self, *c) -> int:
        return self.base.label(*c)

    def unlabel(self, lab: int) -> Coord:
        return self.base.unlabel(lab)

    def row_major(self, *c) -> int:
        return self.base.row_major(*c)

    def idx(self, c: Coord) -> int:
        return self.base.idx(c)

    def from_idx(self, i: int) -> Coord:
        return self.base.from_idx(i)

    def in_bounds(self, *c) -> bool:
        return self.base.in_bounds(*c)

    def normalize(self, *c) -> Coord:
        return self.base.normalize(*c)

    def delta(self, a: Coord, b: Coord) -> Coord:
        """Signed geometric displacement of the *base* topology: partition
        membership (Definitions 1-3 wedges) stays geometric under faults."""
        return self.base.delta(a, b)

    def direction(self, u: Coord, v: Coord) -> int:
        return self.base.direction(u, v)

    def dir_delta(self, d: int) -> Coord:
        return self.base.dir_delta(d)

    def link_weight(self, u: Coord, v: Coord) -> float:
        return self.base.link_weight(u, v)

    def nodes(self) -> list[Coord]:
        return self.base.nodes()

    def all_labels(self) -> np.ndarray:
        return self.base.all_labels()

    def label_table(self) -> np.ndarray:
        return self.base.label_table()

    # -- degraded geometry ---------------------------------------------------
    def is_broken(self, u: Coord, v: Coord) -> bool:
        return _canon(self.base, u, v) in self._broken

    @functools.cached_property
    def _broken(self) -> frozenset[Link]:
        return frozenset(self.faults)

    def neighbors(self, *c) -> list[Coord]:
        u = self.base.normalize(*c)
        return [v for v in self.base.neighbors(*u) if not self.is_broken(u, v)]

    def distance(self, a: Coord, b: Coord) -> int:
        """BFS shortest-path hop count on the degraded graph — this is what
        Definition 1 (representative = nearest destination) and the hop cost
        model see, which is how DPM's merge loop adapts to faults."""
        d = _bfs_from(self, self.base.normalize(*a)).get(self.base.normalize(*b))
        if d is None:
            raise DisconnectedError(
                f"{b} unreachable from {a} on {self.base.kind} "
                f"{self.n}x{self.rows} with {len(self.faults)} broken links"
            )
        return d[0]

    def manhattan(self, a: Coord, b: Coord) -> int:
        return self.distance(a, b)


# Bounded (unlike the grid/torus factories): fault sets are combinatorially
# many, so a sweep over random fault sets must not retain every instance
# forever. Eviction is safe — FaultyTopology is a frozen dataclass, so two
# equal instances hash/compare equal everywhere they key caches.
@functools.lru_cache(maxsize=4096)
def _faulty(base: MeshGrid, faults: tuple[Link, ...]) -> FaultyTopology:
    return FaultyTopology(base, faults)


def faulty(base: MeshGrid, broken: tuple | list | set) -> MeshGrid:
    """Interned degraded-topology factory.

    ``broken`` is any iterable of ``(u, v)`` link pairs (order- and
    direction-insensitive; coordinates are normalized). Links that do not
    exist on the base topology raise. An empty set returns the base
    unchanged, so fault-free callers keep the exact legacy routing path.
    """
    if isinstance(base, FaultyTopology):
        broken = set(broken) | set(base.faults)
        base = base.base
    canon = {_canon(base, u, v) for u, v in broken}
    for u, v in canon:
        if v not in base.neighbors(*u):
            raise ValueError(f"({u}, {v}) is not a link of {base}")
    if not canon:
        return base
    return _faulty(base, tuple(sorted(canon)))


def router_failure(topo: MeshGrid, *nodes: Coord) -> tuple[Link, ...]:
    """Clustered fault region: a failed *router* takes down every link
    incident to it (the paper's link-fault model composes — a router fault
    is just the closure of its port links).

    Returns the canonical link tuple, ready for ``faulty(topo, links)`` or
    ``NoCConfig(broken_links=links)``. Composes with an already-degraded
    topology (links broken twice stay broken once). The failed router
    itself becomes unreachable — callers must keep it out of source and
    destination sets (planning to it raises ``DisconnectedError``).
    """
    base = topo.base if isinstance(topo, FaultyTopology) else topo
    links: set[Link] = set()
    for node in nodes:
        u = tuple(node)
        if not base.in_bounds(*u):
            raise ValueError(f"{node} is not a node of {base}")
        for v in base.neighbors(*u):
            links.add(_canon(base, u, v))
    return tuple(sorted(links))


@functools.lru_cache(maxsize=32_768)
def _bfs_from(topo: FaultyTopology, src: Coord) -> dict[Coord, tuple[int, Coord]]:
    """BFS tree over the degraded graph: node -> (distance, predecessor).

    Deterministic: neighbors expand in ``neighbors()`` order and the first
    predecessor found wins, so detoured routes are reproducible.
    """
    out: dict[Coord, tuple[int, Coord]] = {src: (0, src)}
    q = deque([src])
    while q:
        u = q.popleft()
        du = out[u][0]
        for v in topo.neighbors(*u):
            if v not in out:
                out[v] = (du + 1, u)
                q.append(v)
    return out


# ---------------------------------------------------------------------------
# Providers
# ---------------------------------------------------------------------------
class RouteProvider:
    """Produces the hop sequences every cost evaluation and simulator uses.

    ``unicast`` returns the full hop sequence (inclusive of both endpoints);
    ``label_step`` advances one hop of the dual-path (Lin-McKinley) routing
    function.
    """

    name = "abstract"

    def unicast(self, topo: MeshGrid, src: Coord, dst: Coord) -> list[Coord]:
        raise NotImplementedError

    def label_step(
        self, topo: MeshGrid, cur: Coord, target: Coord, high: bool
    ) -> Coord:
        raise NotImplementedError


class MinimalRouteProvider(RouteProvider):
    """The paper's routing functions, verbatim (fault-free topologies)."""

    name = "minimal"

    def unicast(self, topo: MeshGrid, src: Coord, dst: Coord) -> list[Coord]:
        """Dimension-ordered (XY[Z]) minimal route; each dimension travels
        its signed shortest leg (``Topology.delta``) in dimension order,
        so the length always equals ``Topology.distance``."""
        d = topo.delta(src, dst)
        cur = tuple(src)
        path = [src]
        for axis, leg in enumerate(d):
            step = 1 if leg > 0 else -1
            for _ in range(abs(leg)):
                nxt = list(cur)
                nxt[axis] += step
                cur = topo.normalize(*nxt)
                path.append(cur)
        return path

    def label_step(
        self, topo: MeshGrid, cur: Coord, target: Coord, high: bool
    ) -> Coord:
        """One hop of the dual-path routing function.

        high=True: argmax over neighbors of label(v) s.t. label(v) <= label(target)
        high=False: the mirror rule (argmin s.t. label(v) >= label(target)).
        """
        lt = topo.label(*target)
        best = None
        best_lab = None
        for v in topo.neighbors(*cur):
            lv = topo.label(*v)
            if high:
                if lv <= lt and (best_lab is None or lv > best_lab):
                    best, best_lab = v, lv
            else:
                if lv >= lt and (best_lab is None or lv < best_lab):
                    best, best_lab = v, lv
        if best is None:  # cannot happen on a connected mesh with valid direction
            raise RuntimeError(f"label_route stuck at {cur} -> {target} (high={high})")
        return best


class FaultAwareProvider(RouteProvider):
    """Detours around broken links instead of merely re-pricing them.

    * ``unicast``: the dimension-ordered route when it crosses no broken
      link (bit-identical to the minimal provider — the common case under
      sparse faults), otherwise the BFS shortest path on the degraded graph.
    * ``label_step``: the label rule over *live* neighbors, accepted only
      when it makes strict label progress toward the target without moving
      away from it (BFS distance does not increase); otherwise one hop of
      the BFS shortest path. Every step therefore either strictly decreases
      the BFS distance or keeps it while strictly advancing the label, so
      chain walks are loop-free and terminate (DESIGN.md §7).

    Detours *load-balance*: a BFS tree has one arbitrary predecessor per
    node, so every detour around a fault region funneled through the same
    few links (the first-expanded ones). ``_bfs_path`` instead walks back
    through the full set of equal-length predecessors, tie-breaking with a
    deterministic per-(src, dst) digest — distinct flows spread across the
    equal-cost detours instead of piling onto one, while every route stays
    a BFS-shortest path and is reproducible run to run.
    """

    name = "fault-aware"
    _minimal = MinimalRouteProvider()

    def unicast(self, topo: FaultyTopology, src: Coord, dst: Coord) -> list[Coord]:
        path = self._minimal.unicast(topo.base, src, dst)
        if not any(topo.is_broken(u, v) for u, v in zip(path, path[1:])):
            return path
        return self._bfs_path(topo, src, dst)

    @staticmethod
    def _bfs_path(topo: FaultyTopology, src: Coord, dst: Coord) -> list[Coord]:
        src = topo.normalize(*src)
        tree = _bfs_from(topo, src)
        dst = topo.normalize(*dst)
        if dst not in tree:
            raise DisconnectedError(
                f"{dst} unreachable from {src} on degraded {topo.kind} "
                f"({len(topo.faults)} broken links)"
            )
        # stable digest, NOT hash(): str hashing is salted per process
        flow = zlib.crc32(repr((src, dst)).encode())
        path = [dst]
        while path[-1] != src:
            u = path[-1]
            du = tree[u][0]
            preds = [
                v for v in topo.neighbors(*u)
                if tree.get(v, (du,))[0] == du - 1
            ]
            path.append(min(
                preds,
                key=lambda v: zlib.crc32(repr((flow, u, v)).encode()),
            ))
        path.reverse()
        return path

    def label_step(
        self, topo: FaultyTopology, cur: Coord, target: Coord, high: bool
    ) -> Coord:
        dists = _bfs_from(topo, topo.normalize(*target))
        cur_n = topo.normalize(*cur)
        if cur_n not in dists:
            raise DisconnectedError(
                f"{target} unreachable from {cur} on degraded {topo.kind} "
                f"({len(topo.faults)} broken links)"
            )
        dcur = dists[cur_n][0]
        lt = topo.label(*target)
        lc = topo.label(*cur_n)
        best = None
        best_lab = None
        for v in topo.neighbors(*cur_n):  # live links only
            lv = topo.label(*v)
            if dists.get(v, (dcur + 1,))[0] > dcur:
                continue  # never move away from the target
            if high:
                if lc < lv <= lt and (best_lab is None or lv > best_lab):
                    best, best_lab = v, lv
            else:
                if lc > lv >= lt and (best_lab is None or lv < best_lab):
                    best, best_lab = v, lv
        if best is not None:
            return best
        # BFS fallback: the deterministic first neighbor one hop closer.
        for v in topo.neighbors(*cur_n):
            if dists.get(v, (dcur,))[0] == dcur - 1:
                return v
        raise RuntimeError(f"label_step stuck at {cur} -> {target} (high={high})")


_MINIMAL = MinimalRouteProvider()
_FAULT_AWARE = FaultAwareProvider()


def provider_for(topo: MeshGrid) -> RouteProvider:
    """Resolve the route provider for a topology: degraded topologies get
    the detouring provider, everything else the paper's minimal functions
    (``faulty(topo, ())`` returns the base, so an empty fault set stays on
    the bit-identical legacy path)."""
    if isinstance(topo, FaultyTopology):
        return _FAULT_AWARE
    return _MINIMAL


# ---------------------------------------------------------------------------
# Dense lowering for the weighted Pallas planner kernel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)
def _route_cost_matrices_cached(topo: MeshGrid, cm) -> tuple:
    NN = topo.num_nodes
    nodes = topo.nodes()
    dist = np.zeros((NN, NN), np.int32)
    weight = np.zeros((NN, NN), np.float32)
    provider = provider_for(topo)
    for u in nodes:
        iu = topo.idx(u)
        for v in nodes:
            if u == v:
                continue
            route = provider.unicast(topo, u, v)
            dist[iu, topo.idx(v)] = len(route) - 1
            weight[iu, topo.idx(v)] = (
                len(route) - 1 if cm is None else cm.route_cost(topo, route)
            )
    overhead = 0.0 if cm is None else float(cm.packet_overhead(topo))
    return dist, weight, overhead


def route_cost_matrices(
    topo: MeshGrid, cost_model=None
) -> tuple[np.ndarray, np.ndarray, float]:
    """Lower (topology, cost model) to the dense tensors the weighted
    ``kernels/dpm_cost`` path batches over:

    * ``dist[u, v]``   int32 provider-route hop count (detours included) —
      the Definition 1 representative-selection metric;
    * ``weight[u, v]`` float32 provider-route price under ``cost_model``
      (hop count when None) — the Definition 2 C_t per-destination term;
    * ``overhead``     the model's per-worm injection price.

    Node indices are row-major (``Topology.idx``), matching the kernel's
    numbering. Results are cached per (topology, model) instance pair — both
    are interned/registered singletons in normal use. Unreachable pairs on a
    degraded topology raise ``DisconnectedError``.
    """
    return _route_cost_matrices_cached(topo, cost_model)
