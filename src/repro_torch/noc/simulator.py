"""Simulation statistics shared by the NoC engines.

Twin of ``repro.noc.simulator``, holding ``SimStats`` only. The host
event-ordered oracle ``WormholeSim`` and its ``Telemetry`` come with the
host-NoC slice of the port, so ``telemetry`` stays ``None`` here.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SimStats:
    latencies: list[int] = field(default_factory=list)  # per-dest, measured
    flit_link_traversals: int = 0
    buffer_writes: int = 0
    buffer_reads: int = 0
    xbar_traversals: int = 0
    arbitrations: int = 0
    ni_flits: int = 0
    cycles: int = 0
    packets_created: int = 0
    packets_finished: int = 0
    max_srcq: int = 0
    # the reference's structured per-link view; no engine of the port
    # attaches one yet
    telemetry: object | None = field(default=None, compare=False, repr=False)

    @property
    def avg_latency(self) -> float:
        return sum(self.latencies) / max(1, len(self.latencies))

    def dyn_energy_pj(self, e) -> float:
        return (
            self.buffer_writes * e.e_buffer_write
            + self.buffer_reads * e.e_buffer_read
            + self.xbar_traversals * e.e_xbar
            + self.arbitrations * e.e_arbiter
            + self.flit_link_traversals * e.e_link
            + self.ni_flits * e.e_ni
        )

    def dyn_power(self, e) -> float:
        """Average dynamic power (pJ/cycle) over the simulated window."""
        return self.dyn_energy_pj(e) / max(1, self.cycles)
