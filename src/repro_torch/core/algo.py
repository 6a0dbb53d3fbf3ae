"""Pluggable routing-algorithm registry + cost-model protocol (DESIGN.md §6).

The paper's DPM chooses partition merges *by comparing routing cost*; this
module makes both axes of that comparison pluggable:

* ``CostModel`` — prices routes. The planner's merge loop (Algorithm 1)
  optimizes whatever objective the model encodes: the shipped models are
  hop counting (the paper's Definition 2, exactly), a link-contention-
  weighted variant (mesh bisection links cost more), and a dynamic-energy
  model derived from ``repro_torch.noc.config.EnergyModel``.
* ``RoutingAlgorithm`` — a named multicast planner with capability metadata
  (supported topology kinds, whether its output depends on the cost model).
  ``@register_algorithm`` publishes one; every consumer (``core.planner``'s
  cached ``plan`` facade, both simulators, the dist schedule builders, the
  figure benchmarks) resolves algorithms through the registry, so a new
  algorithm is one registration, not a many-file sweep.

Registries are process-global with insertion order preserved. Cost models
may be registered as instances or as zero-argument factories — factories
instantiate lazily on first use (the energy model imports ``repro_torch.noc``
config, which would be a circular import at ``repro_torch.core`` import time).
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import TYPE_CHECKING, Callable, Iterable

from .grid import Coord, MeshGrid
from .routefn import provider_for
from .routing import path_multicast

if TYPE_CHECKING:  # planner imports this module; annotation-only reverse dep
    from .planner import MulticastPlan

TOPOLOGY_KINDS = ("mesh", "torus", "mesh3d", "torus3d", "chiplet")


# ---------------------------------------------------------------------------
# Cost models
# ---------------------------------------------------------------------------
class CostModel:
    """Prices routes for the planners' cost comparisons (Definition 2).

    Subclasses override ``link_cost``/``packet_overhead`` (or any of the
    derived methods) to change the objective. The derived methods mirror the
    quantities Algorithm 1 compares: ``multi_unicast_cost`` is C_t,
    ``dual_path_cost`` is C_p, and ``route_cost`` prices the S->R source leg
    and arbitrary explicit hop sequences.

    Representative selection (Definition 1) stays topological — nearest
    destination by hop distance — under every model; the cost model only
    prices C_t / C_p / the source leg, which is where the paper's merge
    decisions live.
    """

    name: str = "abstract"

    def link_cost(self, g: MeshGrid, u: Coord, v: Coord) -> float:
        """Price of one worm crossing the directed link u -> v."""
        return 1.0

    def packet_overhead(self, g: MeshGrid) -> float:
        """Price of injecting one worm (NI cost; 0 under pure hop counting)."""
        return 0.0

    def route_cost(self, g: MeshGrid, hops: list[Coord]) -> float:
        """Price of one worm traversing an explicit hop sequence."""
        return sum(self.link_cost(g, u, v) for u, v in zip(hops, hops[1:]))

    def unicast_cost(self, g: MeshGrid, a: Coord, b: Coord) -> float:
        """Price of the provider's unicast route a -> b (dimension-ordered
        on a healthy topology; detoured on a degraded one)."""
        return self.route_cost(g, provider_for(g).unicast(g, a, b))

    def multi_unicast_cost(self, g: MeshGrid, src: Coord, dests: list[Coord]) -> float:
        """Definition 2's C_t under this model: one worm per destination."""
        return sum(
            self.unicast_cost(g, src, d) + self.packet_overhead(g) for d in dests
        )

    def dual_path_cost(self, g: MeshGrid, src: Coord, dests: list[Coord]) -> float:
        """Definition 2's C_p under this model: one label-ordered chain per
        subnetwork (high: labels above src, low: below)."""
        ls = g.label(*src)
        d_h = [d for d in dests if g.label(*d) > ls]
        d_l = [d for d in dests if g.label(*d) < ls]
        cost = 0  # stays int under hop counting, floats under float models
        for group, high in ((d_h, True), (d_l, False)):
            if group:
                chain = path_multicast(g, src, group, high=high)
                cost += self.route_cost(g, chain) + self.packet_overhead(g)
        return cost

    def plan_cost(self, g: MeshGrid, plan: "MulticastPlan") -> float:
        """Price a whole MulticastPlan: every path is one injected worm."""
        return sum(
            self.route_cost(g, path.hops) + self.packet_overhead(g)
            for path in plan.paths
        )


class HopCountCost(CostModel):
    """The paper's Definition 2 exactly: integer hop counts, no NI term.

    This is the default model; ``dpm_partition`` under it is bit-identical
    to the pre-registry behaviour (and to the Pallas ``dpm_cost`` tables).
    """

    name = "hops"

    def route_cost(self, g: MeshGrid, hops: list[Coord]) -> int:
        return len(hops) - 1

    def unicast_cost(self, g: MeshGrid, a: Coord, b: Coord) -> int:
        # == len(provider unicast) - 1 on every topology: the provider's
        # route is shortest on the (possibly degraded) graph, and
        # FaultyTopology.distance is exactly that BFS shortest-path length.
        return g.distance(a, b)

    def packet_overhead(self, g: MeshGrid) -> int:
        return 0


class LinkContentionCost(CostModel):
    """Hop counting with mesh bisection links weighted up.

    Under uniform traffic with minimal routing, the expected load of the
    link crossing the cut between columns i and i+1 of an n-column mesh is
    proportional to (i+1)(n-i-1) — central links are the contended ones. A
    hop costs ``1 + lam * cut_load / peak_load``, steering plans toward the
    mesh edge. On a torus every ring cut carries the same expected load
    (edge-transitive), so the model degenerates to hop counting there.
    """

    name = "contention"

    def __init__(self, lam: float = 1.0):
        self.lam = lam

    @staticmethod
    def _cut_ratio(i: int, size: int) -> float:
        peak = (size // 2) * (size - size // 2)
        if peak <= 0:
            return 0.0
        return (i + 1) * (size - i - 1) / peak

    def link_cost(self, g: MeshGrid, u: Coord, v: Coord) -> float:
        if g.wrap:
            return 1.0
        # the one axis the link moves along; cut between planes i, i+1
        for k in range(len(u)):
            if u[k] != v[k]:
                # x, y, z extents: ``rows`` is m * d on the 3-D kinds
                extent = (g.n, g.m or g.rows, getattr(g, "d", 1))[k]
                return 1.0 + self.lam * self._cut_ratio(min(u[k], v[k]), extent)
        return 1.0


class WeightedLinkCost(CostModel):
    """Hop counting priced by the topology's heterogeneous link classes.

    Each hop costs ``Topology.link_weight(u, v)`` — 1.0 for planar mesh
    links, ``z_weight`` for TSV pillars on the 3-D topologies,
    ``noi_weight`` for interposer crossings on a chiplet package. On a
    uniform topology every weight is 1.0 and the model degenerates to hop
    counting, so it is safe as a default objective everywhere; on a
    heterogeneous fabric it is the lever that makes Algorithm 1's merge
    loop prefer partitions whose chains stay on cheap planar links.
    """

    name = "weighted"

    def link_cost(self, g: MeshGrid, u: Coord, v: Coord) -> float:
        return g.link_weight(u, v)


class EnergyCost(CostModel):
    """Dynamic-energy objective (pJ) from the NoC per-event energies.

    One hop moves F flits through a buffer write, buffer read, crossbar and
    link traversal (plus one arbitration); ``packet_overhead`` charges the
    NI injection of one worm (F * e_ni) — the term hop counting cannot see:
    MU-mode re-injections pay it once per destination, a dual-path chain
    once per chain, so the energy objective shifts Algorithm 1's MU/DP mode
    choices and merge decisions. Ejection energy is partition-invariant
    (every destination ejects its copy exactly once under any algorithm)
    and is therefore omitted from the comparison.
    """

    name = "energy"

    def __init__(self, energy=None, flits_per_packet: int | None = None):
        if energy is None or flits_per_packet is None:
            # Lazy: repro_torch.noc imports repro_torch.core, so this import must not
            # run at repro_torch.core import time (the registry stores this class
            # as a factory and instantiates on first use).
            from ..noc.config import NoCConfig

            cfg = NoCConfig()
            energy = energy if energy is not None else cfg.energy
            if flits_per_packet is None:
                flits_per_packet = cfg.flits_per_packet
        self.energy = energy
        self.flits_per_packet = flits_per_packet
        e = energy
        self._per_hop = (
            flits_per_packet
            * (e.e_buffer_write + e.e_buffer_read + e.e_xbar + e.e_link)
            + e.e_arbiter
        )
        self._per_packet = flits_per_packet * e.e_ni

    def link_cost(self, g: MeshGrid, u: Coord, v: Coord) -> float:
        return self._per_hop

    def route_cost(self, g: MeshGrid, hops: list[Coord]) -> float:
        return (len(hops) - 1) * self._per_hop

    def unicast_cost(self, g: MeshGrid, a: Coord, b: Coord) -> float:
        return g.distance(a, b) * self._per_hop

    def packet_overhead(self, g: MeshGrid) -> float:
        return self._per_packet


_COST_MODELS: dict[str, CostModel | Callable[[], CostModel]] = {}


def register_cost_model(
    obj: CostModel | Callable[[], CostModel], *, name: str | None = None
) -> None:
    """Register a cost model instance, or a zero-arg factory for one.

    Factories instantiate lazily on first ``get_cost_model`` and the
    instance replaces the factory in the registry. Duplicate names raise.
    """
    n = name or getattr(obj, "name", None)
    if not n or n == CostModel.name:
        raise ValueError("cost model needs a name (set .name or pass name=)")
    if n in _COST_MODELS:
        raise ValueError(
            f"cost model {n!r} already registered; unregister_cost_model({n!r}) "
            f"first or pick another name"
        )
    if isinstance(obj, CostModel):
        # Sync the instance to its registration key so the plan cache's
        # canonical-instance check (is_registered_cost_model) recognizes it
        # when registered under a custom name. Factories sync on first use.
        obj.name = n
    _COST_MODELS[n] = obj


def unregister_cost_model(name: str) -> None:
    _COST_MODELS.pop(name, None)
    _invalidate_caches()


def get_cost_model(ref: CostModel | str | None) -> CostModel:
    """Resolve a cost model: an instance passes through, a name looks up the
    registry (instantiating a factory on first use), None means 'hops'."""
    if isinstance(ref, CostModel):
        return ref
    name = "hops" if ref is None else ref
    entry = _COST_MODELS.get(name)
    if entry is None:
        raise KeyError(
            f"unknown cost model {name!r}; registered: "
            f"{', '.join(available_cost_models())}"
        )
    if not isinstance(entry, CostModel):
        entry = entry()
        entry.name = name
        _COST_MODELS[name] = entry
    return entry


def available_cost_models() -> list[str]:
    return list(_COST_MODELS)


def is_registered_cost_model(cm: CostModel) -> bool:
    """True iff ``cm`` is the canonical instance its name resolves to (the
    planner cache may then key on the name alone)."""
    return _COST_MODELS.get(cm.name) is cm


# ---------------------------------------------------------------------------
# Routing algorithms
# ---------------------------------------------------------------------------
class RoutingAlgorithm:
    """A named multicast routing algorithm with capability metadata.

    ``plan(topo, src, dests, cost_model=...)`` returns a ``MulticastPlan``.
    ``topologies`` lists the topology kinds the algorithm can route on;
    ``cost_sensitive`` says whether the produced plan depends on the cost
    model (False for the fixed-shape baselines — the planner cache then
    shares one entry across models); ``default_cost_model`` names the
    objective the algorithm optimizes when the caller does not pick one;
    ``tags`` is free-form metadata (the figure benchmarks select the
    paper's comparison set via the "fig" tag).
    """

    name: str = "?"
    topologies: frozenset[str] = frozenset(TOPOLOGY_KINDS)
    cost_sensitive: bool = False
    default_cost_model: str = "hops"
    tags: frozenset[str] = frozenset()

    def plan(
        self,
        topo: MeshGrid,
        src: Coord,
        dests: list[Coord],
        *,
        cost_model: CostModel,
    ) -> "MulticastPlan":
        raise NotImplementedError

    def supports(self, topo: MeshGrid | str) -> bool:
        kind = topo if isinstance(topo, str) else topo.kind
        return kind in self.topologies


class _FunctionAlgorithm(RoutingAlgorithm):
    """Adapter registering a plain planning function.

    Cost-insensitive functions keep the legacy ``f(g, src, dests)``
    signature; cost-sensitive ones receive ``cost_model=`` as a keyword.
    """

    def __init__(
        self,
        fn: Callable,
        name: str,
        topologies: Iterable[str],
        cost_sensitive: bool,
        default_cost_model: str,
        tags: Iterable[str],
    ):
        self._fn = fn
        self.name = name
        self.topologies = frozenset(topologies)
        self.cost_sensitive = cost_sensitive
        self.default_cost_model = default_cost_model
        self.tags = frozenset(tags)

    def plan(self, topo, src, dests, *, cost_model):
        if self.cost_sensitive:
            return self._fn(topo, src, dests, cost_model=cost_model)
        return self._fn(topo, src, dests)


_ALGORITHMS: dict[str, RoutingAlgorithm] = {}
# Caches keyed on algorithm names (the planner's plan cache) must flush when
# a name is unregistered or re-registered; they subscribe here.
_CACHE_INVALIDATORS: list[Callable[[], None]] = []


def _invalidate_caches() -> None:
    for fn in _CACHE_INVALIDATORS:
        fn()


def on_registry_change(fn: Callable[[], None]) -> None:
    """Subscribe a cache-flush callback to registry mutations."""
    _CACHE_INVALIDATORS.append(fn)


def register_algorithm(
    obj=None,
    *,
    name: str | None = None,
    topologies: Iterable[str] | None = None,
    cost_sensitive: bool | None = None,
    default_cost_model: str | None = None,
    tags: Iterable[str] | None = None,
):
    """Register a routing algorithm; usable as decorator or direct call.

    Accepts a ``RoutingAlgorithm`` subclass (instantiated), an instance, or
    a planning function (wrapped — see ``_FunctionAlgorithm``). Keyword
    arguments override the object's own metadata. Registering a name twice
    raises; use ``temporary_algorithm`` for scoped registration in tests.
    """
    if obj is None:  # decorator-factory form: @register_algorithm(name=...)
        return functools.partial(
            register_algorithm,
            name=name,
            topologies=topologies,
            cost_sensitive=cost_sensitive,
            default_cost_model=default_cost_model,
            tags=tags,
        )
    if isinstance(obj, type) and issubclass(obj, RoutingAlgorithm):
        algo: RoutingAlgorithm = obj()
    elif isinstance(obj, RoutingAlgorithm):
        algo = obj
    elif callable(obj):
        algo = _FunctionAlgorithm(
            obj,
            name=name or obj.__name__,
            topologies=topologies or TOPOLOGY_KINDS,
            cost_sensitive=bool(cost_sensitive),
            default_cost_model=default_cost_model or "hops",
            tags=tags or (),
        )
    else:
        raise TypeError(f"cannot register {obj!r} as a routing algorithm")
    # Duplicate check BEFORE any metadata mutation: a raising registration
    # must not leave an already-registered instance renamed (which would
    # silently decouple it from its cache key).
    final_name = name or algo.name
    if final_name in _ALGORITHMS:
        raise ValueError(
            f"routing algorithm {final_name!r} already registered; "
            f"unregister_algorithm({final_name!r}) first or pick another name"
        )
    if not isinstance(algo, _FunctionAlgorithm):  # kwargs override metadata
        algo.name = final_name
        if topologies is not None:
            algo.topologies = frozenset(topologies)
        if cost_sensitive is not None:
            algo.cost_sensitive = cost_sensitive
        if default_cost_model is not None:
            algo.default_cost_model = default_cost_model
        if tags is not None:
            algo.tags = frozenset(tags)
    _ALGORITHMS[algo.name] = algo
    return obj


def unregister_algorithm(name: str) -> None:
    """Remove an algorithm and flush name-keyed caches (plan cache)."""
    _ALGORITHMS.pop(name, None)
    _invalidate_caches()


@contextmanager
def temporary_algorithm(obj=None, **kwargs):
    """Scoped registration for tests / experiments; yields the instance and
    unregisters (flushing the plan cache) on exit."""
    register_algorithm(obj, **kwargs)
    name = kwargs.get("name") or getattr(obj, "name", None) or obj.__name__
    try:
        yield get_algorithm(name)
    finally:
        unregister_algorithm(name)


def get_algorithm(ref: "RoutingAlgorithm | str") -> RoutingAlgorithm:
    """Resolve an algorithm: an instance passes through (registered or not),
    a name looks up the registry. Unknown names list what is registered."""
    if isinstance(ref, RoutingAlgorithm):
        return ref
    algo = _ALGORITHMS.get(ref)
    if algo is None:
        raise KeyError(
            f"unknown routing algorithm {ref!r}; registered: "
            f"{', '.join(available_algorithms())}"
        )
    return algo


def is_registered_algorithm(algo: RoutingAlgorithm) -> bool:
    """True iff ``algo`` is the canonical instance its name resolves to."""
    return _ALGORITHMS.get(algo.name) is algo


def available_algorithms(
    topo: MeshGrid | str | None = None, *, tag: str | None = None
) -> list[str]:
    """Registered algorithm names, in registration order, optionally
    filtered by supported topology kind and/or tag."""
    out = []
    for name, algo in _ALGORITHMS.items():
        if topo is not None and not algo.supports(topo):
            continue
        if tag is not None and tag not in algo.tags:
            continue
        out.append(name)
    return out


# Built-in cost models. "energy" is a lazy factory: instantiating it reads
# the NoC config (repro_torch.noc imports repro_torch.core, so it cannot load here).
register_cost_model(HopCountCost())
register_cost_model(LinkContentionCost())
register_cost_model(WeightedLinkCost())
register_cost_model(EnergyCost, name="energy")
