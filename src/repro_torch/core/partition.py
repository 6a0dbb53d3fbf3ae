"""Destination-set partitioning: Definitions 1-3 and Algorithm 1 (DPM).

The destination set partition problem (Section III.A) is an exact weighted
set-cover instance: choose disjoint partitions covering all destinations with
minimum total routing cost. DPM is the paper's greedy heuristic over a
restricted candidate family: the 8 basic geometric partitions P0..P7 around
the source plus merges of up to 3 *consecutive* basic partitions.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

from .algo import CostModel, get_cost_model
from .grid import Coord, MeshGrid
from .routefn import provider_for

# The paper's 2-D wedge order, counter-clockwise from the upper-right
# quadrant (Fig. 2a), as (sign(dx), sign(dy)) patterns:
# P0 (+,+)  P1 (0,+)  P2 (-,+)  P3 (-,0)  P4 (-,-)  P5 (0,-)  P6 (+,-)  P7 (+,0)
_RING2: tuple[tuple[int, int], ...] = (
    (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0),
)


@functools.lru_cache(maxsize=None)
def wedge_patterns(ndim: int) -> tuple[tuple[int, ...], ...]:
    """Canonical ordered sign patterns of the basic partitions in ``ndim``
    dimensions: every non-zero pattern in {-1, 0, +1}^ndim.

    2-D: the paper's 8 wedges P0..P7 in the order above. 3-D: 26 wedges —
    the dz=0 ring first (the 2-D order, so a flat destination set partitions
    identically to the 2-D case), then the dz=+1 block of 9 (the 8 ring
    patterns followed by the (0,0,+1) pole), then the dz=-1 block. This is
    the order the dpm_cost kernels' partition-membership tables are built in
    (``kernels/dpm_cost``) — keep them in lockstep.
    """
    if ndim == 2:
        return _RING2
    if ndim == 3:
        pats = [(sx, sy, 0) for sx, sy in _RING2]
        for sz in (1, -1):
            pats += [(sx, sy, sz) for sx, sy in _RING2]
            pats.append((0, 0, sz))
        return tuple(pats)
    raise ValueError(f"unsupported dimensionality {ndim}")


@functools.lru_cache(maxsize=None)
def _pattern_index(ndim: int) -> dict[tuple[int, ...], int]:
    return {p: i for i, p in enumerate(wedge_patterns(ndim))}


def num_wedges(topo: MeshGrid | None, src: Coord | None = None) -> int:
    """Number of basic partitions for a topology (8 in 2-D, 26 in 3-D)."""
    ndim = len(src) if topo is None else len(topo.from_idx(0))
    return len(wedge_patterns(ndim))


@functools.lru_cache(maxsize=None)
def candidate_ids_for(np_: int, max_merge: int = 3) -> tuple[tuple[int, ...], ...]:
    """DPM's candidate family over ``np_`` basic partitions: singles plus
    merges of up to ``max_merge`` cyclically *consecutive* partitions."""
    out: list[tuple[int, ...]] = [(i,) for i in range(np_)]
    for k in range(2, max_merge + 1):
        out += [tuple((i + j) % np_ for j in range(k)) for i in range(np_)]
    return tuple(out)


# 2-D candidate index sets: 8 singles, 8 consecutive pairs, 8 triples.
SINGLE_IDS: list[tuple[int, ...]] = [(i,) for i in range(8)]
PAIR_IDS: list[tuple[int, ...]] = [(i, (i + 1) % 8) for i in range(8)]
TRIPLE_IDS: list[tuple[int, ...]] = [(i, (i + 1) % 8, (i + 2) % 8) for i in range(8)]
ALL_CANDIDATE_IDS: list[tuple[int, ...]] = SINGLE_IDS + PAIR_IDS + TRIPLE_IDS


def basic_partitions(
    src: Coord, dests: list[Coord], topo: MeshGrid | None = None
) -> list[list[Coord]]:
    """Split destinations into the basic partitions around ``src``.

    Membership is the sign pattern of the signed shortest displacement from
    the source — 8 wedges P0..P7 in 2-D (counter-clockwise from the
    upper-right quadrant, Fig. 2a), 26 in 3-D (``wedge_patterns``).

    Without ``topo`` (or on a mesh) the displacement is the plain coordinate
    difference, reproducing the paper's geometry; edge/corner sources simply
    leave the out-of-mesh partitions empty. On a torus ``topo.delta`` takes
    the shorter way around each ring, so each partition is the wedge of
    nodes whose minimal route leaves the source in that direction
    (DESIGN.md §3). On a chiplet package the delta stays geometric, so the
    8 wedges apply unchanged even though routes cross declared boundaries.
    """
    ndim = len(src)
    index = _pattern_index(ndim)
    parts: list[list[Coord]] = [[] for _ in range(len(index))]
    for d in dests:
        if topo is None:
            dv = tuple(d[k] - src[k] for k in range(ndim))
        else:
            dv = topo.delta(src, d)
        sign = tuple((x > 0) - (x < 0) for x in dv)
        i = index.get(sign)
        if i is not None:  # all-zero pattern == src: already "delivered"
            parts[i].append(d)
    return parts


@dataclass
class PartitionCost:
    """Cost record for one candidate partition (Definitions 1-2).

    Costs are priced by a ``CostModel`` (repro_torch.core.algo); under the default
    hop-count model they are the paper's integer hop counts.
    """

    ids: tuple[int, ...]
    dests: list[Coord]
    rep: Coord | None  # representative node R (Definition 1)
    cost_mu: float  # C_t: multiple unicast from R
    cost_dp: float  # C_p: dual-path from R
    source_leg: float  # S -> R XY leg, priced by the model
    mode: str  # "MU" | "DP" — the cheaper of the two

    def cost(self, include_source_leg: bool) -> float:
        base = min(self.cost_mu, self.cost_dp)
        return base + (self.source_leg if include_source_leg else 0)


def representative(g: MeshGrid, src: Coord, dests: list[Coord]) -> Coord:
    """Definition 1: nearest destination to the source (topology distance —
    on a degraded topology the BFS shortest-path distance, so the
    representative choice adapts to faults).

    Ties broken by smallest boustrophedon label for determinism.
    """
    return min(dests, key=lambda d: (g.distance(src, d), g.label(*d)))


def candidate_cost(
    g: MeshGrid,
    src: Coord,
    ids: tuple[int, ...],
    dests: list[Coord],
    cost_model: CostModel | str | None = None,
) -> PartitionCost:
    """Definition 2: C = min(C_t, C_p), measured from the representative R.

    Under the default hop-count model C_t = sum of Manhattan(R, d) and C_p =
    dual-path hop count from R, exactly as printed; any registered
    ``CostModel`` (name or instance) re-prices both plus the S->R leg. When
    the two tie, MU is preferred (the paper: "the overhead of computing D_H,
    D_L is eliminated using MU").

    All three terms are priced on hop sequences from the topology's route
    provider (``routefn.provider_for``): on a degraded topology the S->R leg
    and every C_t/C_p route detour around broken links, so Algorithm 1's
    merge decisions see the fault set — the dynamic, global-view behaviour
    the paper claims over static partitioning.
    """
    cm = get_cost_model(cost_model)
    if not dests:
        return PartitionCost(ids, [], None, 0, 0, 0, "MU")
    rep = representative(g, src, dests)
    rest = [d for d in dests if d != rep]
    cost_mu = cm.multi_unicast_cost(g, rep, rest)
    cost_dp = cm.dual_path_cost(g, rep, rest)
    source_leg = cm.route_cost(g, provider_for(g).unicast(g, src, rep))
    mode = "MU" if cost_mu <= cost_dp else "DP"
    return PartitionCost(ids, list(dests), rep, cost_mu, cost_dp, source_leg, mode)


@dataclass
class DPMResult:
    """Final partition set I with per-partition routing decisions."""

    partitions: list[PartitionCost]
    iterations: int  # greedy merge iterations taken (paper: converges <= 4)
    savings_trace: list[tuple[tuple[int, ...], float]] = field(default_factory=list)

    def total_cost(self, include_source_leg: bool = True) -> float:
        return sum(p.cost(include_source_leg) for p in self.partitions)


def dpm_partition(
    g: MeshGrid,
    src: Coord,
    dests: list[Coord],
    include_source_leg: bool = True,
    max_merge: int = 3,
    cost_model: CostModel | str | None = None,
) -> DPMResult:
    """Algorithm 1: Dynamic Partition Merging.

    ``include_source_leg`` controls whether the S->R XY leg is counted inside
    C_i (see DESIGN.md §2 — Definition 2 as printed excludes it; the stated
    objective function includes it; default True).
    ``max_merge`` is the paper's limit of 3 consecutive partitions.
    ``g`` may be a MeshGrid or a Torus; all distances, partitions, and
    routes follow the topology.
    ``cost_model`` is the objective the merge loop optimizes — the paper's
    hop counting by default; any registered model (e.g. "energy") re-prices
    every candidate, which is the lever DPM-E pulls (DESIGN.md §6).
    """
    cm = get_cost_model(cost_model)
    parts = basic_partitions(src, dests, g)
    np_ = len(parts)

    candidate_ids = list(candidate_ids_for(np_, max_merge))

    costs: dict[tuple[int, ...], PartitionCost] = {}
    for ids in candidate_ids:
        union: list[Coord] = []
        for i in ids:
            union.extend(parts[i])
        costs[ids] = candidate_cost(g, src, ids, union, cm)

    # Definition 3: saving of each merged candidate vs its components.
    savings: dict[tuple[int, ...], float] = {}
    for ids in candidate_ids:
        if len(ids) == 1:
            continue
        if not costs[ids].dests:
            continue
        merged = costs[ids].cost(include_source_leg)
        split = sum(costs[(i,)].cost(include_source_leg) for i in ids)
        savings[ids] = max(0, split - merged)

    chosen: list[tuple[int, ...]] = []
    iterations = 0
    trace: list[tuple[tuple[int, ...], int]] = []
    while True:
        best_ids, best_a = None, 0
        for ids, a in savings.items():
            if a <= 0:
                continue
            # tie-break: fewer merged partitions first, then smallest index.
            if (
                best_ids is None
                or a > best_a
                or (a == best_a and (len(ids), ids) < (len(best_ids), best_ids))
            ):
                best_ids, best_a = ids, a
        if best_ids is None:
            break
        iterations += 1
        chosen.append(best_ids)
        trace.append((best_ids, best_a))
        covered = set(best_ids)
        for ids in list(savings):
            if covered & set(ids):
                savings[ids] = 0

    covered: set[int] = set()
    for ids in chosen:
        covered |= set(ids)

    final: list[PartitionCost] = [costs[ids] for ids in chosen]
    # Leftover basic partitions that did not take part in any merge.
    for i in range(np_):
        if i not in covered and parts[i]:
            final.append(costs[(i,)])
    return DPMResult(final, iterations, trace)


def brute_force_partition(
    g: MeshGrid,
    src: Coord,
    dests: list[Coord],
    include_source_leg: bool = True,
    cost_model: CostModel | str | None = None,
) -> tuple[float, list[tuple[int, ...]]]:
    """Exact minimum over DPM's candidate family (exponential; tests only).

    Enumerates every exact cover of the non-empty basic partitions by
    candidate index sets and returns (min cost, chosen ids). This is the
    optimum of the *restricted* set-cover the paper's heuristic addresses,
    under whichever ``cost_model`` prices the candidates.
    """
    cm = get_cost_model(cost_model)
    parts = basic_partitions(src, dests, g)
    candidates = candidate_ids_for(len(parts))
    nonempty = frozenset(i for i in range(len(parts)) if parts[i])
    costs: dict[tuple[int, ...], float] = {}
    for ids in candidates:
        union: list[Coord] = []
        for i in ids:
            union.extend(parts[i])
        costs[ids] = candidate_cost(g, src, ids, union, cm).cost(include_source_leg)

    best = (float("inf"), [])

    def rec(remaining: frozenset[int], acc_cost: int, acc: list[tuple[int, ...]]):
        nonlocal best
        if acc_cost >= best[0]:
            return
        if not remaining:
            best = (acc_cost, list(acc))
            return
        pivot = min(remaining)
        for ids in candidates:
            s = set(ids) & nonempty
            if pivot not in s or not s <= remaining:
                continue
            acc.append(ids)
            rec(remaining - s, acc_cost + costs[ids], acc)
            acc.pop()

    rec(nonempty, 0, [])
    return best
