"""Topology protocol + the wraparound ``Torus`` (DESIGN.md §3).

The paper defines DPM on a 2-D mesh; the deployments the ROADMAP targets run
on wraparound tori (TPU-pod ICI). Everything geometric that the routing
functions, planners, simulator, and kernels need is expressed through the
``Topology`` protocol below, with ``MeshGrid`` and ``Torus`` as the two
implementations:

* **labeling** — the boustrophedon snake label order. On the torus the wrap
  link from the last to the first snake node closes the path into a
  Hamiltonian cycle, so label-ordered (dual-path) routing stays valid: mesh
  links are a subset of torus links, and the label-monotone progress argument
  only needs the snake successor to be a neighbor.
* **delta / distance** — the signed shortest per-dimension displacement. On
  a torus each dimension independently takes the shorter way around the
  ring; an exact half-way tie breaks toward the negative direction, matching
  the kernels' ``((d + size//2) % size) - size//2`` formula bit for bit.
* **neighbors / normalize** — wrap links and coordinate canonicalization.

The 8-partition geometry of Definitions 1-3 generalizes through ``delta``:
partition membership is the sign pattern of the shortest displacement, which
on the torus makes each basic partition the wedge of nodes whose minimal
route leaves the source in that direction.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from .grid import Coord, MeshGrid, grid


@runtime_checkable
class Topology(Protocol):
    """Structural interface shared by MeshGrid and Torus."""

    kind: str
    wrap: bool
    n: int

    @property
    def rows(self) -> int: ...

    @property
    def num_nodes(self) -> int: ...

    def label(self, x: int, y: int) -> int: ...

    def unlabel(self, lab: int) -> Coord: ...

    def row_major(self, x: int, y: int) -> int: ...

    def idx(self, c: Coord) -> int: ...

    def normalize(self, x: int, y: int) -> Coord: ...

    def neighbors(self, x: int, y: int) -> list[Coord]: ...

    def delta(self, a: Coord, b: Coord) -> Coord: ...

    def distance(self, a: Coord, b: Coord) -> int: ...


def ring_delta(d: int, size: int) -> int:
    """Signed shortest displacement on a ring of ``size`` nodes.

    Result lies in [-size//2, (size-1)//2]; an exact half-way tie (even
    ``size``) goes negative — the same convention as the Pallas kernel's
    wrapped-distance formula, so host and device partitions always agree.
    """
    if size <= 1:
        return 0
    return (d + size // 2) % size - size // 2


@dataclass(frozen=True)
class Torus(MeshGrid):
    """n x m wraparound torus.

    Inherits the boustrophedon labeling and vectorized helpers from
    ``MeshGrid``; overrides the geometric methods with wraparound semantics.
    ``Torus(n, 1)`` degenerates to a 1-D ring of ``n`` ranks (used by
    by the reference's ``dist.multicast.dp_broadcast_schedule``).
    """

    kind = "torus"
    wrap = True

    def normalize(self, x: int, y: int) -> Coord:
        return x % self.n, y % self.rows

    def neighbors(self, x: int, y: int) -> list[Coord]:
        out: list[Coord] = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            v = self.normalize(x + dx, y + dy)
            if v != (x, y) and v not in out:  # size-1/2 rings: no self/dup links
                out.append(v)
        return out

    def delta(self, a: Coord, b: Coord) -> Coord:
        return (
            ring_delta(b[0] - a[0], self.n),
            ring_delta(b[1] - a[1], self.rows),
        )

    def manhattan(self, a: Coord, b: Coord) -> int:  # type: ignore[override]
        """Toroidal distance (shadows the mesh staticmethod on instances so
        no call site can accidentally get non-wrapped distances)."""
        return self.distance(a, b)


@functools.lru_cache(maxsize=None)
def _torus(n: int, m: int) -> Torus:
    return Torus(n, m)


def torus(n: int, m: int | None = None) -> Torus:
    """Interned torus factory (normalized like ``grid``)."""
    return _torus(n, n if m is None else m)


_FACTORIES = {"mesh": grid, "torus": torus}


def register_topology(kind: str, factory) -> None:
    """Register a topology factory under ``kind``.

    ``factory(n, m, *params)`` must return an interned instance whose
    ``kind``/``params`` attributes round-trip through ``make_topology`` —
    that tuple is the planner cache key. Registering lets new topology
    new topology modules plug in without editing this file;
    re-registering an existing kind raises to keep cache keys unambiguous.
    """
    if kind in _FACTORIES:
        raise ValueError(f"topology kind {kind!r} is already registered")
    _FACTORIES[kind] = factory


def registered_topology_kinds() -> tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


def make_topology(
    kind: str, n: int, m: int | None = None, faults: tuple = (),
    params: tuple = (),
) -> MeshGrid:
    """Construct a topology from its cache key (kind, n, m, faults, params).

    ``faults`` is an iterable of broken (u, v) links; when non-empty the
    base topology is wrapped in a ``FaultyTopology`` (interned, like the
    bases), which is what keys the planner cache for degraded plans.
    ``params`` are the extra factory arguments beyond (n, m) — empty for
    mesh/torus; depth/weight-class tuples for the ``topo3d`` kinds.
    """
    try:
        factory = _FACTORIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown topology kind {kind!r}; registered kinds: "
            f"{', '.join(registered_topology_kinds())}"
        ) from None
    base = factory(n, m, *params)
    if not faults:
        return base
    from .routefn import faulty  # routefn imports grid only; no cycle

    return faulty(base, tuple(faults))
