"""Unicast and path-based multicast routing functions, topology-generic.

Three routing functions are used by the algorithms in this repo:

* ``xy_route``      — dimension-ordered XY (x first, then y). Used by MU and by
                      the S->R delivery leg of DPM. Each dimension travels its
                      signed shortest leg (``Topology.delta``), so on a torus
                      the route takes the shorter way around each ring and its
                      length always equals ``Topology.distance``.
* ``label_route``   — the Lin–McKinley dual-path routing function: in the
                      high-channel subnetwork move to the neighbor with the
                      largest label that does not exceed the target label; in
                      the low-channel subnetwork the mirror rule. Guarantees
                      progress along the Hamiltonian path with mesh shortcuts;
                      on a torus the wrap links only add shortcuts (the snake
                      successor is still a neighbor), so the same monotone
                      progress argument applies.
* ``greedy_tour``   — NMP's nearest-destination-first tour with XY legs.

All functions return explicit hop sequences (lists of (x, y) coords starting
at the source), which the cycle-level simulator consumes directly and whose
lengths are the hop-count costs used by the planners. ``g`` is any
``Topology`` (MeshGrid or Torus, possibly degraded by ``FaultyTopology``).

Since the route-provider layer (DESIGN.md §7) every function here routes
through ``provider_for(g)``: fault-free topologies resolve to
``MinimalRouteProvider`` (the implementations above, bit-identical to the
pre-provider behaviour) and degraded topologies to ``FaultAwareProvider``,
which detours around broken links — so every caller of these functions
(planners, cost models, simulators, dist schedulers) is fault-aware without
further changes.
"""
from __future__ import annotations

from .grid import Coord, MeshGrid
from .routefn import provider_for


def xy_route(g: MeshGrid, src: Coord, dst: Coord) -> list[Coord]:
    """Dimension-ordered minimal route, inclusive of both endpoints.

    On a degraded topology the provider detours (BFS shortest path) when the
    dimension-ordered route crosses a broken link; the length then equals the
    degraded ``Topology.distance``.
    """
    return provider_for(g).unicast(g, src, dst)


def label_route_step(g: MeshGrid, cur: Coord, target: Coord, high: bool) -> Coord:
    """One hop of the dual-path routing function (see
    ``routefn.MinimalRouteProvider.label_step`` for the rule; the
    fault-aware provider restricts it to live links and falls back to a BFS
    hop when the rule has no live candidate)."""
    return provider_for(g).label_step(g, cur, target, high)


def label_route(g: MeshGrid, src: Coord, dst: Coord, high: bool) -> list[Coord]:
    """Full label-ordered route src -> dst inside one subnetwork."""
    path = [src]
    cur = src
    guard = 4 * g.num_nodes
    while cur != dst:
        cur = label_route_step(g, cur, dst, high)
        path.append(cur)
        guard -= 1
        if guard == 0:
            raise RuntimeError("label_route did not converge")
    return path


def path_multicast(
    g: MeshGrid, src: Coord, dests: list[Coord], high: bool
) -> list[Coord]:
    """Path-based multicast: visit ``dests`` in label order within a subnetwork.

    ``high=True`` visits in ascending label order (all dest labels must be
    > label(src)); ``high=False`` descending. A destination passed through en
    route is considered delivered at that point (wormhole pass-through
    delivery), so the walk always heads for the nearest-in-label-order
    unvisited destination. A destination equal to ``src`` is delivered at
    injection (zero hops) — the same rule ``greedy_tour`` applies.
    Returns the full hop sequence (deliveries are simply path points that are
    destinations).
    """
    pending = [d for d in dests if d != src]
    if not pending:
        return [src]
    pending.sort(key=lambda d: g.label(*d), reverse=not high)
    path = [src]
    cur = src
    while pending:
        target = pending[0]
        cur = label_route_step(g, cur, target, high)
        path.append(cur)
        pending = [d for d in pending if d != cur]
    return path


def greedy_tour(g: MeshGrid, src: Coord, dests: list[Coord]) -> list[Coord]:
    """NMP-style tour: repeatedly go (XY) to the nearest remaining destination.

    Delivery dedup matches ``path_multicast``: a destination equal to ``src``
    is delivered at injection, and a destination is considered delivered at
    the first hop that *enters* it (leg points after the leg's start) —
    whether it was the leg's explicit target or a pass-through. The previous
    rule filtered explicit targets and pass-throughs separately with a set
    built from the whole leg (including its start), which double-counted the
    leg origin and handled src-equal destinations inconsistently.
    """
    path = [src]
    cur = src
    pending = [d for d in dests if d != src]
    while pending:
        nxt = min(pending, key=lambda d: (g.distance(cur, d), g.row_major(*d)))
        leg = xy_route(g, cur, nxt)
        path.extend(leg[1:])
        cur = nxt
        # one rule for target and pass-through deliveries alike: every node
        # the leg entered (leg[1:] — the worm's arrivals) is delivered
        entered = set(leg[1:])
        pending = [d for d in pending if d not in entered]
    return path


def dual_path_cost(g: MeshGrid, src: Coord, dests: list[Coord]) -> int:
    """Hop count of dual-path routing from ``src`` (Definition 2's C_p).

    Destinations with label > label(src) are served by the high-channel chain
    in ascending order; label < label(src) by the low-channel chain in
    descending order.
    """
    ls = g.label(*src)
    d_h = [d for d in dests if g.label(*d) > ls]
    d_l = [d for d in dests if g.label(*d) < ls]
    cost = 0
    if d_h:
        cost += len(path_multicast(g, src, d_h, high=True)) - 1
    if d_l:
        cost += len(path_multicast(g, src, d_l, high=False)) - 1
    return cost


def multi_unicast_cost(g: MeshGrid, src: Coord, dests: list[Coord]) -> int:
    """Definition 2's C_t: sum of minimal distances src -> each destination
    (Manhattan on the mesh, toroidal Manhattan on the torus, BFS shortest
    path on a degraded topology — always the provider route length)."""
    return sum(g.distance(src, d) for d in dests)
