"""2-D mesh geometry and Hamiltonian (boustrophedon) labeling.

The paper labels each node of an n x n mesh as

    L(x, y) = y*n + x          if y is even
    L(x, y) = y*n + n - x - 1  if y is odd

which traces a Hamiltonian ("snake") path 0, 1, ..., n^2-1 through the mesh.
The dual-path / multipath family of algorithms routes along this label order;
the high-channel subnetwork contains every mesh link directed from a lower to
a higher label and the low-channel subnetwork the reverse direction.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

Coord = tuple[int, int]

# canonical 2-D direction order (+x, -x, +y, -y) — directed-link ids are
# idx(u) * ports + direction, shared by telemetry and the xsim geometry
DIRS2 = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIR_OF2 = {d: i for i, d in enumerate(DIRS2)}


@dataclass(frozen=True)
class MeshGrid:
    """An n_cols x n_rows 2-D mesh (the paper uses square 8x8).

    This is the mesh instance of the ``Topology`` protocol (see
    core/topology.py); ``Torus`` subclasses it with wraparound geometry.
    """

    n: int  # columns (x in [0, n))
    m: int | None = None  # rows (y in [0, m)); defaults to n

    kind = "mesh"  # topology discriminator (planner cache key)
    wrap = False
    ports = 4  # output ports per router (directed-link ids span idx*ports+dir)
    params = ()  # extra factory args beyond (n, m) — planner cache-key suffix

    @property
    def rows(self) -> int:
        return self.m if self.m is not None else self.n

    @property
    def num_nodes(self) -> int:
        return self.n * self.rows

    # -- labeling ------------------------------------------------------------
    def label(self, x: int, y: int) -> int:
        """Boustrophedon label used by dual-path/MP/DPM."""
        if y % 2 == 0:
            return y * self.n + x
        return y * self.n + self.n - x - 1

    def unlabel(self, lab: int) -> Coord:
        y, r = divmod(lab, self.n)
        x = r if y % 2 == 0 else self.n - r - 1
        return x, y

    def row_major(self, x: int, y: int) -> int:
        """Row-major label L = y*n + x (used by NMP [18])."""
        return y * self.n + x

    def idx(self, c: Coord) -> int:
        """Row-major rank index of a node (the kernels' node numbering)."""
        return c[1] * self.n + c[0]

    # -- geometry ------------------------------------------------------------
    def in_bounds(self, x: int, y: int) -> bool:
        return 0 <= x < self.n and 0 <= y < self.rows

    def normalize(self, x: int, y: int) -> Coord:
        """Canonical coordinates (identity on a mesh, modulo on a torus)."""
        return x, y

    def neighbors(self, x: int, y: int) -> list[Coord]:
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if self.in_bounds(nx, ny):
                out.append((nx, ny))
        return out

    def delta(self, a: Coord, b: Coord) -> Coord:
        """Signed per-dimension displacement of a minimal route a -> b."""
        return b[0] - a[0], b[1] - a[1]

    def distance(self, a: Coord, b: Coord) -> int:
        """Minimal hop count a -> b (Manhattan; toroidal on a torus)."""
        dx, dy = self.delta(a, b)
        return abs(dx) + abs(dy)

    # -- directed-link geometry (telemetry / xsim port numbering) -----------
    def direction(self, u: Coord, v: Coord) -> int:
        """Port index in [0, ports) of the directed link u -> v."""
        d = _DIR_OF2.get(tuple(self.delta(u, v)))
        if d is None:
            raise ValueError(f"{u}->{v} is not a single-hop link")
        return d

    def dir_delta(self, d: int) -> Coord:
        """Unit displacement of port ``d`` (inverse of ``direction``)."""
        return DIRS2[d]

    def link_weight(self, u: Coord, v: Coord) -> float:
        """Relative price class of link u -> v (1.0 = planar baseline;
        heterogeneous topologies price TSV / interposer links higher)."""
        return 1.0

    def from_idx(self, i: int) -> Coord:
        """Inverse of ``idx`` (the kernels' node numbering)."""
        y, x = divmod(i, self.n)
        return x, y

    def nodes(self) -> list[Coord]:
        """All node coordinates in ``idx`` order."""
        return [self.from_idx(i) for i in range(self.num_nodes)]

    @staticmethod
    def manhattan(a: Coord, b: Coord) -> int:
        return abs(a[0] - b[0]) + abs(a[1] - b[1])

    # -- vectorized helpers (used by the jnp reference / kernels) -----------
    def all_labels(self) -> np.ndarray:
        """(rows, n) array of boustrophedon labels."""
        ys, xs = np.mgrid[0 : self.rows, 0 : self.n]
        even = ys % 2 == 0
        return np.where(even, ys * self.n + xs, ys * self.n + self.n - xs - 1)

    def label_table(self) -> np.ndarray:
        """label -> (x, y), shape (num_nodes, 2)."""
        out = np.zeros((self.num_nodes, 2), dtype=np.int32)
        for y in range(self.rows):
            for x in range(self.n):
                out[self.label(x, y)] = (x, y)
        return out


@functools.lru_cache(maxsize=None)
def _grid(n: int, m: int) -> MeshGrid:
    return MeshGrid(n, m)


def grid(n: int, m: int | None = None) -> MeshGrid:
    """Interned mesh factory. ``m`` is normalized (grid(8) is grid(8, 8)) so
    equivalent geometries share one instance and one planner-cache key."""
    return _grid(n, n if m is None else m)
