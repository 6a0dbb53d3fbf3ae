"""NoC simulation configuration — Table I of the paper + Orion-style energies.

Twin of ``repro.noc.config``. The reference's ``xsim_backend`` field is gone:
the port picks its cycle engine from the device its tensors live on
(``xsimulate(..., device=)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class EnergyModel:
    """Per-event dynamic energies (pJ), Orion-2.0-class 45 nm ballpark.

    Absolute values are calibration constants; the benchmarks report *relative*
    power (as the paper does: % improvement vs MU / MP).
    """

    e_buffer_write: float = 1.20  # pJ / flit buffer write
    e_buffer_read: float = 1.10  # pJ / flit buffer read
    e_xbar: float = 1.70  # pJ / flit crossbar traversal
    e_arbiter: float = 0.24  # pJ / arbitration
    e_link: float = 1.90  # pJ / flit link traversal (1 mm)
    e_ni: float = 0.80  # pJ / flit injected or ejected


@dataclass(frozen=True)
class NoCConfig:
    """Network parameters (paper Table I defaults)."""

    n: int = 8  # 8x8 mesh
    m: int | None = None
    topology: str = "mesh"  # any registered kind (core.topology.make_topology)
    # Extra factory arguments beyond (n, m) — empty for mesh/torus; e.g.
    # (d, z_weight) for mesh3d/torus3d, the chiplet-grid/boundary tuple for
    # "chiplet" (core.topo3d). Threaded verbatim into make_topology.
    topology_params: tuple = ()
    # Broken bidirectional links ((u, v) coordinate pairs): both simulators
    # build a FaultyTopology, plan detours through the route-provider layer
    # (core.routefn), and refuse plans that traverse a broken link.
    broken_links: tuple = ()
    vcs_per_class: int = 2  # 4 VCs total: 2 high-channel + 2 low-channel
    buffer_depth: int = 4  # flits per VC FIFO
    flits_per_packet: int = 4
    multicast_fraction: float = 0.10
    dest_range: tuple[int, int] = (4, 8)  # paper sweeps (2-5),(4-8),(7-10),(10-16)
    energy: EnergyModel = field(default_factory=EnergyModel)
    # measurement window shared by both simulators (traffic.simulate and
    # noc.xsim): packets enqueued in [warmup, horizon) are measured, and the
    # run extends drain_grace cycles past the last injection to let in-flight
    # packets deliver.
    warmup: int = 200
    drain_grace: int = 3000
    # telemetry time-bucket width (cycles) shared by both engines: the host
    # sim's Telemetry epochs and xsim's per-link utilization / per-router
    # conflict planes both bucket on cycle // epoch_len (DESIGN.md §10)
    epoch_len: int = 128

    def make_topology(self):
        """The (possibly degraded) topology instance this config describes."""
        from ..core.topology import make_topology

        return make_topology(
            self.topology, self.n, self.m, self.broken_links,
            self.topology_params,
        )

    @property
    def rows(self) -> int:
        if self.topology_params:  # e.g. mesh3d: rows = m * d, not m
            return self.make_topology().rows
        return self.m if self.m is not None else self.n

    @property
    def num_nodes(self) -> int:
        return self.n * self.rows


DEST_RANGES: list[tuple[int, int]] = [(2, 5), (4, 8), (7, 10), (10, 16)]
