"""3-D mesh/torus and two-level chiplet-package topologies.

Twin of ``repro.core.topo3d``: pure Python and numpy, copied so that the
port imports nothing of the reference. Geometry, labels and BFS distances
are the reference's bit for bit.

The paper defines DPM on a 2-D mesh; the fabrics the ROADMAP targets are
3-D tori (TPU-pod ICI, stacked dies with TSV pillars) and chiplet packages
(per-chiplet NoC meshes stitched by an interposer NoI). All three shapes
here implement the ``Topology`` protocol, so the planner cache,
``FaultyTopology`` wrapping, registry capability filtering, both
simulators, and the telemetry link indexing apply unchanged:

* ``Mesh3D`` / ``Torus3D`` — nx x ny x nz grids with 6-port routers. The
  snake label order is the per-layer 2-D boustrophedon with every odd
  layer traversed in *reverse*: consecutive labels inside a layer are the
  2-D snake (a neighbor step), and the layer boundary lands on the same
  (x, y) of the adjacent layer (a z-link) — a Hamiltonian path, so
  label-monotone dual-path routing stays valid exactly as on the 2-D
  mesh. ``delta`` is the signed per-dimension shortest displacement with
  the kernels' half-way tie-break on the torus. TSV z-links carry a
  ``z_weight`` price class (>= 1.0) that the weighted cost path prices.
* ``ChipletPackage`` — cx x cy chiplets of cw x ch routers each, in one
  global coordinate frame. Within-chiplet links form the full 2-D mesh;
  inter-chiplet (NoI) links exist only through declared boundary routers
  (``h_rows`` local rows for east-west crossings, ``v_cols`` local cols
  for north-south) and carry the ``noi_weight`` price class. All links
  are unit x/y steps, so routers keep 4 ports and the 2-D directed-link
  convention; ``distance`` is BFS over the sparse link set and routes go
  through the BFS provider (``needs_bfs_routes``). The snake is a
  two-level boustrophedon — chiplets in chiplet-level snake order, each
  traversed corner-to-corner by a serpentine whose crossings land on
  boundary routers (validated at construction) — again a Hamiltonian
  path, so the dual-path label argument carries over.
"""
from __future__ import annotations

import functools
from collections import deque
from dataclasses import dataclass

import numpy as np

from .grid import MeshGrid
from .topology import register_topology, ring_delta

Coord3 = tuple[int, int, int]

# canonical 3-D direction order (+x, -x, +y, -y, +z, -z): extends the 2-D
# (+x, -x, +y, -y) prefix so planar link ids keep their relative order
DIRS3 = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
_DIR_OF3 = {d: i for i, d in enumerate(DIRS3)}


@dataclass(frozen=True)
class Mesh3D:
    """nx x ny x nz 3-D mesh with 6-port routers and weighted TSV z-links.

    Protocol mapping: ``n`` is the x extent; ``rows = ny * nz`` so the
    ``num_nodes == rows * n`` invariant (telemetry heatmaps, kernel node
    numbering ``idx = (z*ny + y)*nx + x``) holds with no 2-D special
    cases downstream.
    """

    n: int  # x extent
    m: int  # y extent
    d: int  # z extent (layers)
    z_weight: float = 1.0  # TSV price class (>= 1.0; 1.0 = uniform)

    kind = "mesh3d"
    wrap = False
    ports = 6

    def __post_init__(self):
        if min(self.n, self.m, self.d) < 1:
            raise ValueError("Mesh3D dimensions must be positive")
        if self.z_weight < 1.0:
            raise ValueError("z_weight must be >= 1.0")

    @property
    def params(self) -> tuple:
        return (self.d, self.z_weight)

    @property
    def rows(self) -> int:
        return self.m * self.d

    @property
    def num_nodes(self) -> int:
        return self.n * self.m * self.d

    # -- labeling -----------------------------------------------------------
    def _label2(self, x: int, y: int) -> int:
        return y * self.n + (x if y % 2 == 0 else self.n - x - 1)

    def label(self, x: int, y: int, z: int) -> int:
        """Layered boustrophedon: odd layers traverse the 2-D snake in
        reverse, so the path crosses layers on a single z-link."""
        nn = self.n * self.m
        s = self._label2(x, y)
        return z * nn + (s if z % 2 == 0 else nn - 1 - s)

    def unlabel(self, lab: int) -> Coord3:
        nn = self.n * self.m
        z, s = divmod(lab, nn)
        if z % 2 == 1:
            s = nn - 1 - s
        y, r = divmod(s, self.n)
        x = r if y % 2 == 0 else self.n - r - 1
        return x, y, z

    def row_major(self, x: int, y: int, z: int) -> int:
        return (z * self.m + y) * self.n + x

    def idx(self, c: Coord3) -> int:
        return (c[2] * self.m + c[1]) * self.n + c[0]

    def from_idx(self, i: int) -> Coord3:
        r, x = divmod(i, self.n)
        z, y = divmod(r, self.m)
        return x, y, z

    # -- geometry -----------------------------------------------------------
    def in_bounds(self, x: int, y: int, z: int) -> bool:
        return 0 <= x < self.n and 0 <= y < self.m and 0 <= z < self.d

    def normalize(self, x: int, y: int, z: int) -> Coord3:
        return x, y, z

    def neighbors(self, x: int, y: int, z: int) -> list[Coord3]:
        out = []
        for dx, dy, dz in DIRS3:
            v = (x + dx, y + dy, z + dz)
            if self.in_bounds(*v):
                out.append(v)
        return out

    def delta(self, a: Coord3, b: Coord3) -> Coord3:
        return b[0] - a[0], b[1] - a[1], b[2] - a[2]

    def distance(self, a: Coord3, b: Coord3) -> int:
        return sum(abs(d) for d in self.delta(a, b))

    def direction(self, u: Coord3, v: Coord3) -> int:
        d = _DIR_OF3.get(tuple(self.delta(u, v)))
        if d is None:
            raise ValueError(f"{u}->{v} is not a single-hop link")
        return d

    def dir_delta(self, d: int) -> Coord3:
        return DIRS3[d]

    def link_weight(self, u: Coord3, v: Coord3) -> float:
        return self.z_weight if u[2] != v[2] else 1.0

    def nodes(self) -> list[Coord3]:
        return [self.from_idx(i) for i in range(self.num_nodes)]

    # -- vectorized helpers -------------------------------------------------
    def all_labels(self) -> np.ndarray:
        """(rows, n) = (ny*nz, nx) array of snake labels in idx layout."""
        out = np.zeros((self.rows, self.n), dtype=np.int64)
        for i in range(self.num_nodes):
            x, y, z = self.from_idx(i)
            out[z * self.m + y, x] = self.label(x, y, z)
        return out

    def label_table(self) -> np.ndarray:
        """label -> (x, y, z), shape (num_nodes, 3)."""
        out = np.zeros((self.num_nodes, 3), dtype=np.int32)
        for i in range(self.num_nodes):
            c = self.from_idx(i)
            out[self.label(*c)] = c
        return out


@dataclass(frozen=True)
class Torus3D(Mesh3D):
    """nx x ny x nz wraparound 3-D torus (shortest-way-around deltas with
    the kernels' half-way tie-break, per dimension independently)."""

    kind = "torus3d"
    wrap = True

    def normalize(self, x: int, y: int, z: int) -> Coord3:
        return x % self.n, y % self.m, z % self.d

    def neighbors(self, x: int, y: int, z: int) -> list[Coord3]:
        out: list[Coord3] = []
        for dx, dy, dz in DIRS3:
            v = self.normalize(x + dx, y + dy, z + dz)
            if v != (x, y, z) and v not in out:  # size-1/2 rings
                out.append(v)
        return out

    def delta(self, a: Coord3, b: Coord3) -> Coord3:
        return (
            ring_delta(b[0] - a[0], self.n),
            ring_delta(b[1] - a[1], self.m),
            ring_delta(b[2] - a[2], self.d),
        )


def _col_serpentine(W: int, H: int) -> list[tuple]:
    """Column-by-column Hamiltonian path (0,0) -> (W-1, 0); W even keeps
    the exit on the entry row."""
    path = []
    for j in range(W):
        ys = range(H) if j % 2 == 0 else range(H - 1, -1, -1)
        path.extend((j, y) for y in ys)
    return path


def _row_serpentine(W: int, H: int) -> list[tuple]:
    """Row-by-row Hamiltonian path (0,0) -> (0, H-1); H even keeps the
    exit on the entry column."""
    path = []
    for i in range(H):
        xs = range(W) if i % 2 == 0 else range(W - 1, -1, -1)
        path.extend((x, i) for x in xs)
    return path


def _comb(W: int, H: int) -> list[tuple]:
    """Hamiltonian path (W-1, H-1) -> (0, H-1) for even W: up the east
    column, then a column serpentine over the remaining odd count of
    columns (ends on the bottom row)."""
    path = [(W - 1, y) for y in range(H - 1, -1, -1)]
    for j in range(W - 2, -1, -1):
        ys = range(H) if (W - 2 - j) % 2 == 0 else range(H - 1, -1, -1)
        path.extend((j, y) for y in ys)
    return path


def _flip(path: list[tuple], W: int, H: int, fx: bool, fy: bool):
    return [
        (W - 1 - x if fx else x, H - 1 - y if fy else y) for x, y in path
    ]


@dataclass(frozen=True)
class ChipletPackage:
    """cx x cy chiplets of cw x ch routers with an interposer NoI.

    Global coordinates (x, y) over a (cx*cw) x (cy*ch) frame; ``n``/``m``
    are the *global* extents so the protocol invariants (idx = y*n + x,
    num_nodes = rows*n) match the 2-D mesh. ``params`` round-trips the
    chiplet grid and boundary declaration through ``make_topology``.
    """

    n: int  # global columns = cx * chiplet width
    m: int  # global rows = cy * chiplet height
    cx: int  # chiplets per package row
    cy: int  # chiplet rows
    noi_weight: float = 2.0  # interposer (NoI) link price class
    h_rows: tuple = None  # local rows carrying east-west NoI links
    v_cols: tuple = None  # local cols carrying north-south NoI links

    kind = "chiplet"
    wrap = False
    ports = 4  # all links are unit x/y steps in the global frame
    needs_bfs_routes = True  # dimension-ordered routes may cross gaps

    def __post_init__(self):
        if self.n % self.cx or self.m % self.cy:
            raise ValueError(
                f"global {self.n}x{self.m} does not tile into "
                f"{self.cx}x{self.cy} chiplets"
            )
        cw, ch = self.cw, self.ch
        if cw % 2 or ch % 2:
            raise ValueError(
                "chiplet extents must be even (the two-level snake needs "
                f"corner-preserving serpentines); got {cw}x{ch}"
            )
        if self.noi_weight < 1.0:
            raise ValueError("noi_weight must be >= 1.0")
        if self.h_rows is None:
            object.__setattr__(self, "h_rows", (0, ch - 1))
        if self.v_cols is None:
            object.__setattr__(self, "v_cols", (0, cw - 1))
        hr, vc = tuple(self.h_rows), tuple(self.v_cols)
        if any(r < 0 or r >= ch for r in hr) or any(
            c < 0 or c >= cw for c in vc
        ):
            raise ValueError("boundary routers outside the chiplet extent")
        object.__setattr__(self, "h_rows", hr)
        object.__setattr__(self, "v_cols", vc)
        # the two-level snake crosses east-west at local rows 0 (rightward
        # chiplet rows) / ch-1 (leftward rows) and north-south at local
        # col 0 — those routers must be declared boundary routers or the
        # label path is broken (conformance tests pin successor-is-neighbor)
        if self.cx > 1 and 0 not in hr:
            raise ValueError("snake needs local row 0 in h_rows")
        if self.cx > 1 and self.cy > 1 and ch - 1 not in hr:
            raise ValueError("snake needs local row ch-1 in h_rows")
        if self.cy > 1 and 0 not in vc:
            raise ValueError("snake needs local col 0 in v_cols")

    @property
    def cw(self) -> int:
        return self.n // self.cx

    @property
    def ch(self) -> int:
        return self.m // self.cy

    @property
    def params(self) -> tuple:
        return (self.cx, self.cy, self.noi_weight, self.h_rows, self.v_cols)

    @property
    def rows(self) -> int:
        return self.m

    @property
    def num_nodes(self) -> int:
        return self.n * self.m

    # -- labeling: two-level boustrophedon ----------------------------------
    @functools.cached_property
    def _snake(self) -> list[tuple]:
        """Global snake path: chiplet-level boustrophedon with corner-
        preserving serpentines. Rightward rows run column-serpentines NW -> NE (crossing
        east at local row 0) and end with a row-serpentine NW -> SW
        (crossing south at local col 0); leftward rows open with a
        row-serpentine NW -> SW (crossing west at local row ch-1),
        continue with x/y-flipped column-serpentines SE -> SW, and end
        with a comb path SE -> SW (crossing south at local col 0). Every
        chiplet-interior step is a mesh link and every crossing lands on
        a declared boundary router, so the path is Hamiltonian over the
        package's link set."""
        cw, ch = self.cw, self.ch
        path: list[tuple] = []
        for cj in range(self.cy):
            rightward = cj % 2 == 0
            order = (
                range(self.cx) if rightward else range(self.cx - 1, -1, -1)
            )
            for k, ci in enumerate(order):
                first, last = k == 0, k == self.cx - 1
                if rightward:
                    local = (
                        _row_serpentine(cw, ch) if last
                        else _col_serpentine(cw, ch)
                    )
                elif first:
                    # entered from above at the NW corner (crossing came
                    # down local col 0); exits SW for the westward hop
                    # (or the southward one when cx == 1)
                    local = _row_serpentine(cw, ch)
                elif last:
                    local = _comb(cw, ch)
                else:
                    local = _flip(
                        _col_serpentine(cw, ch), cw, ch, fx=True, fy=True
                    )
                path.extend(
                    (ci * cw + lx, cj * ch + ly) for lx, ly in local
                )
        assert len(path) == self.num_nodes
        return path

    @functools.cached_property
    def _label_of(self) -> dict:
        return {c: i for i, c in enumerate(self._snake)}

    def label(self, x: int, y: int) -> int:
        return self._label_of[(x, y)]

    def unlabel(self, lab: int) -> tuple:
        return self._snake[lab]

    def row_major(self, x: int, y: int) -> int:
        return y * self.n + x

    def idx(self, c: tuple) -> int:
        return c[1] * self.n + c[0]

    def from_idx(self, i: int) -> tuple:
        y, x = divmod(i, self.n)
        return x, y

    # -- geometry -----------------------------------------------------------
    def in_bounds(self, x: int, y: int) -> bool:
        return 0 <= x < self.n and 0 <= y < self.m

    def normalize(self, x: int, y: int) -> tuple:
        return x, y

    def chiplet_of(self, c: tuple) -> tuple:
        return c[0] // self.cw, c[1] // self.ch

    def is_noi(self, u: tuple, v: tuple) -> bool:
        """True when u-v is an inter-chiplet (interposer) link."""
        return self.chiplet_of(u) != self.chiplet_of(v)

    def _has_link(self, u: tuple, v: tuple) -> bool:
        if not self.is_noi(u, v):
            return True
        if u[1] == v[1]:  # east-west crossing at a boundary row
            return u[1] % self.ch in self.h_rows
        return u[0] % self.cw in self.v_cols  # north-south crossing

    def neighbors(self, x: int, y: int) -> list[tuple]:
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            v = (x + dx, y + dy)
            if self.in_bounds(*v) and self._has_link((x, y), v):
                out.append(v)
        return out

    def delta(self, a: tuple, b: tuple) -> tuple:
        """Geometric displacement (not a link count): partition wedges
        stay the paper's 8 sign patterns over the global frame."""
        return b[0] - a[0], b[1] - a[1]

    @functools.cached_property
    def _dist(self) -> np.ndarray:
        """All-pairs BFS hop counts over the sparse link set."""
        nn = self.num_nodes
        dist = np.full((nn, nn), -1, dtype=np.int32)
        for s in range(nn):
            dist[s, s] = 0
            dq = deque([self.from_idx(s)])
            while dq:
                u = dq.popleft()
                du = dist[s, self.idx(u)]
                for v in self.neighbors(*u):
                    vi = self.idx(v)
                    if dist[s, vi] < 0:
                        dist[s, vi] = du + 1
                        dq.append(v)
        return dist

    def distance(self, a: tuple, b: tuple) -> int:
        return int(self._dist[self.idx(a), self.idx(b)])

    def direction(self, u: tuple, v: tuple) -> int:
        d = {(1, 0): 0, (-1, 0): 1, (0, 1): 2, (0, -1): 3}.get(
            self.delta(u, v)
        )
        if d is None or not self._has_link(u, v):
            raise ValueError(f"{u}->{v} is not a single-hop link")
        return d

    def dir_delta(self, d: int) -> tuple:
        return ((1, 0), (-1, 0), (0, 1), (0, -1))[d]

    def link_weight(self, u: tuple, v: tuple) -> float:
        return self.noi_weight if self.is_noi(u, v) else 1.0

    def nodes(self) -> list[tuple]:
        return [self.from_idx(i) for i in range(self.num_nodes)]

    def all_labels(self) -> np.ndarray:
        out = np.zeros((self.m, self.n), dtype=np.int64)
        for i, (x, y) in enumerate(self._snake):
            out[y, x] = i
        return out

    def label_table(self) -> np.ndarray:
        return np.array(self._snake, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _mesh3d(n: int, m: int, d: int, z_weight: float) -> Mesh3D:
    return Mesh3D(n, m, d, z_weight)


def mesh3d(n: int, m: int | None = None, d: int | None = None,
           z_weight: float = 1.0) -> Mesh3D:
    """Interned 3-D mesh factory (``m``/``d`` default to ``n``)."""
    m = n if m is None else m
    return _mesh3d(n, m, m if d is None else d, float(z_weight))


@functools.lru_cache(maxsize=None)
def _torus3d(n: int, m: int, d: int, z_weight: float) -> Torus3D:
    return Torus3D(n, m, d, z_weight)


def torus3d(n: int, m: int | None = None, d: int | None = None,
            z_weight: float = 1.0) -> Torus3D:
    """Interned 3-D torus factory (``m``/``d`` default to ``n``)."""
    m = n if m is None else m
    return _torus3d(n, m, m if d is None else d, float(z_weight))


@functools.lru_cache(maxsize=None)
def _chiplet(n, m, cx, cy, noi_weight, h_rows, v_cols) -> ChipletPackage:
    return ChipletPackage(n, m, cx, cy, noi_weight, h_rows, v_cols)


def chiplet(n: int, m: int | None = None, cx: int = 2, cy: int | None = None,
            noi_weight: float = 2.0, h_rows: tuple | None = None,
            v_cols: tuple | None = None) -> ChipletPackage:
    """Interned chiplet-package factory over *global* extents (n, m)."""
    m = n if m is None else m
    cy = cx if cy is None else cy
    t = _chiplet(
        n, m, cx, cy, float(noi_weight),
        None if h_rows is None else tuple(h_rows),
        None if v_cols is None else tuple(v_cols),
    )
    # re-intern under the resolved default boundary so params round-trip
    return _chiplet(n, m, cx, cy, float(noi_weight), t.h_rows, t.v_cols)


register_topology("mesh3d", mesh3d)
register_topology("torus3d", torus3d)
register_topology("chiplet", chiplet)
