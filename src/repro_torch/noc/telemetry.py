"""Structured NoC observability of the host simulator.

Twin of ``repro.noc.telemetry``, numpy on the host as there:

* ``Telemetry`` — the host simulator's time-and-space-resolved counter
  store: per-directed-link / per-VC-class flit traversals, per-(link, VC)
  buffer-occupancy high-water marks, per-link arbitration conflicts and
  credit stalls, a log2-bucketed per-packet latency histogram, and
  epoch-bucketed time series (``cycle // epoch_len``). ``WormholeSim``
  records into it on every event; the flat ``SimStats`` aggregates stay
  the public API.
* The xsim engine accumulates the same per-link utilization planes in
  ``kernels.noc_cycle`` (``XSimResults.link_utilization``); per-link flit
  totals are conserved events and match ``Telemetry.link_flits`` exactly
  whenever delivery sets match.
* ``MeasuredContentionCost`` / ``MeasuredEnergyCost`` / ``fit_energy_cost``
  build cost models from measured counters. The reference's closed
  calibration loop (``calibrate_cost_model``) comes with a later slice.

Directed-link ids use the engines' shared convention
``idx(u) * ports + direction(u -> v)`` (``core.grid``: 4 ports in the order
+x, -x, +y, -y); ``link_index``/``link_coords`` convert both ways.
"""
from __future__ import annotations

import numpy as np

from ..core.grid import Coord, MeshGrid

LATENCY_BINS = 21  # log2 buckets: [1,2), [2,4), ... [2^19, 2^20), overflow


def link_index(g: MeshGrid, u: Coord, v: Coord) -> int:
    """Directed-link id of u -> v: ``idx(u) * ports + direction``.

    Shared with the xsim compiler and the fused-cycle geometry tables, so
    host telemetry rows and device utilization planes index identically.
    Torus wrap hops resolve through ``Topology.delta``'s signed shortest
    step, like every other consumer of the convention; non-links raise
    ValueError.
    """
    return g.idx(u) * g.ports + g.direction(u, v)


def link_coords(g: MeshGrid, link_id: int) -> tuple[Coord, Coord]:
    """Inverse of ``link_index`` (canonical coordinates on a torus)."""
    node, d = divmod(int(link_id), g.ports)
    u = g.from_idx(node)
    dd = g.dir_delta(d)
    return u, g.normalize(*(c + e for c, e in zip(u, dd)))


class LatencyHistogram:
    """Per-packet latency histogram over log2 buckets.

    Bucket ``i`` holds latencies in ``[2**i, 2**(i+1))``; the last bucket
    absorbs overflow. Latencies below 1 clamp into bucket 0 (a delivery
    takes at least one cycle in both engines, so the clamp is defensive).
    """

    def __init__(self) -> None:
        self.counts = np.zeros(LATENCY_BINS, np.int64)

    def add(self, latency: int) -> None:
        self.counts[min(max(int(latency), 1).bit_length() - 1,
                        LATENCY_BINS - 1)] += 1

    @classmethod
    def from_latencies(cls, latencies) -> "LatencyHistogram":
        h = cls()
        for lat in latencies:
            h.add(lat)
        return h

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def quantile(self, q: float) -> int:
        """Upper edge of the bucket holding the q-quantile (0 if empty)."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile must be in [0, 1] (got {q})")
        total = self.total
        if total == 0:
            return 0
        cum = np.cumsum(self.counts)
        return 2 ** (int(np.searchsorted(cum, q * total)) + 1)

    def to_dict(self) -> dict:
        return {"bins_log2": self.counts.tolist(), "total": self.total}


class Telemetry:
    """Per-link / per-VC event counters + epoch time series (host engine).

    All arrays index directed links by ``link_index``. ``epoch_len`` sets
    the time-bucket width; epoch rows grow on demand (a drained run is a
    handful of rows, never the dense cycle axis).
    """

    def __init__(self, num_nodes: int, vcs_per_class: int,
                 epoch_len: int = 128, ports: int = 4) -> None:
        if epoch_len < 1:
            raise ValueError(f"epoch_len must be >= 1 (got {epoch_len})")
        self.num_nodes = num_nodes
        self.ports = ports
        self.num_links = num_nodes * ports
        self.vcs = 2 * vcs_per_class
        self.vcs_per_class = vcs_per_class
        self.epoch_len = epoch_len
        L, W = self.num_links, self.vcs
        self.link_flits = np.zeros(L, np.int64)  # flit traversals per link
        self.vc_class_flits = np.zeros((L, 2), np.int64)  # HIGH(0) / LOW(1)
        self.occupancy_hwm = np.zeros((L, W), np.int32)  # per-(link, VC)
        self.link_conflicts = np.zeros(L, np.int64)  # losing arbitration reqs
        self.credit_stalls = np.zeros(L, np.int64)  # admissions blocked on
        #                                             credit / free-VC
        self.latency_hist = LatencyHistogram()
        self._epoch_link: list[np.ndarray] = []  # per-epoch (L,) flit counts
        self._epoch_lat: list[list[int]] = []  # per-epoch [count, sum]

    # ------------------------------------------------------------- recording
    def _epoch(self, cycle: int) -> int:
        e = cycle // self.epoch_len
        while len(self._epoch_link) <= e:
            self._epoch_link.append(np.zeros(self.num_links, np.int64))
            self._epoch_lat.append([0, 0])
        return e

    def flit(self, link_id: int, vcls: int, cycle: int) -> None:
        self.link_flits[link_id] += 1
        self.vc_class_flits[link_id, vcls] += 1
        self._epoch_link[self._epoch(cycle)][link_id] += 1

    def occupancy(self, link_id: int, vc: int, depth: int) -> None:
        if depth > self.occupancy_hwm[link_id, vc]:
            self.occupancy_hwm[link_id, vc] = depth

    def conflicts(self, link_id: int, losers: int) -> None:
        self.link_conflicts[link_id] += losers

    def stall(self, link_id: int) -> None:
        self.credit_stalls[link_id] += 1

    def latency(self, lat: int, cycle: int) -> None:
        self.latency_hist.add(lat)
        row = self._epoch_lat[self._epoch(cycle)]
        row[0] += 1
        row[1] += lat

    # --------------------------------------------------------------- reading
    @property
    def num_epochs(self) -> int:
        return len(self._epoch_link)

    def epoch_link_flits(self) -> np.ndarray:
        """(E, L) per-epoch per-link flit traversals (E = epochs touched)."""
        if not self._epoch_link:
            return np.zeros((0, self.num_links), np.int64)
        return np.stack(self._epoch_link)

    def epoch_series(self) -> list[dict]:
        """Per-epoch aggregate rows for timeline rendering."""
        out = []
        for e, (lnk, (cnt, tot)) in enumerate(
            zip(self._epoch_link, self._epoch_lat)
        ):
            out.append({
                "epoch": e,
                "cycle_start": e * self.epoch_len,
                "flits": int(lnk.sum()),
                "deliveries": cnt,
                "avg_latency": round(tot / cnt, 3) if cnt else None,
            })
        return out

    def router_conflicts(self) -> np.ndarray:
        """(NN,) conflicts per router (a link arbitrates at its source)."""
        return self.link_conflicts.reshape(self.num_nodes, self.ports).sum(axis=1)

    def heatmap(self, g: MeshGrid) -> np.ndarray:
        """(rows, n, ports) per-node outgoing-link flit counts for rendering."""
        return self.link_flits.reshape(g.rows, g.n, self.ports).copy()

    def to_dict(self) -> dict:
        """JSON-ready snapshot (timeline artifacts, benchmark exports)."""
        return {
            "epoch_len": self.epoch_len,
            "link_flits": self.link_flits.tolist(),
            "vc_class_flits": self.vc_class_flits.tolist(),
            "occupancy_hwm_max": int(self.occupancy_hwm.max(initial=0)),
            "conflicts_total": int(self.link_conflicts.sum()),
            "credit_stalls_total": int(self.credit_stalls.sum()),
            "latency_hist": self.latency_hist.to_dict(),
            "epochs": self.epoch_series(),
        }


# ---------------------------------------------------------------------------
# Calibrated cost models (closed loop over measured telemetry)
# ---------------------------------------------------------------------------
from ..core.algo import (  # noqa: E402  (after Telemetry: no cycle — algo
    CostModel,  # imports core only)
    EnergyCost,
)


class MeasuredContentionCost(CostModel):
    """Per-directed-link weights fitted from measured utilization.

    ``link_cost(u, v) = weights[link_index(u, v)]`` with weights
    ``1 + lam * util / max(util)`` — the empirical replacement for
    ``LinkContentionCost``'s analytic bisection argument. Weights quantize
    to ``1/QUANT`` steps, with hysteresis against ``prev`` (the previous
    calibration iterate): a link keeps its old weight unless the raw value
    moved more than ``STICK`` quanta away from it. Plans are therefore a
    *step* function of utilization with dead zones around every step edge —
    measurement movement below the dead zone cannot flip a merge decision,
    which is what lets the calibration loop reach an exact fixed point.
    Weights are tied to one fabric; pricing a different geometry raises.
    """

    name = "calibrated"
    QUANT = 8  # weight resolution: 1/8-hop steps
    STICK = 0.75  # hysteresis half-width, in quanta

    def __init__(self, g: MeshGrid, utilization: np.ndarray,
                 lam: float = 1.0,
                 prev: "MeasuredContentionCost | None" = None):
        util = np.asarray(utilization, np.float64)
        ports = g.ports
        if util.shape != (g.num_nodes * ports,):
            raise ValueError(
                f"utilization must be ({g.num_nodes * ports},) directed-link "
                f"flit counts (got {util.shape})"
            )
        peak = float(util.max(initial=0.0))
        self.lam = float(lam)
        self.fabric = (g.kind, g.n, g.rows, g.params)
        raw = (
            1.0 + self.lam * util / peak if peak > 0
            else np.ones_like(util)
        )
        self.weights = np.round(raw * self.QUANT) / self.QUANT
        if prev is not None and prev.fabric == self.fabric:
            keep = np.abs(raw - prev.weights) < self.STICK / self.QUANT
            self.weights = np.where(keep, prev.weights, self.weights)

    def _check(self, g: MeshGrid) -> None:
        fab = (g.kind, g.n, g.rows, g.params)
        if fab != self.fabric:
            raise ValueError(
                f"cost model calibrated for {self.fabric} cannot price {fab}"
            )

    def link_cost(self, g: MeshGrid, u: Coord, v: Coord) -> float:
        self._check(g)
        return float(self.weights[link_index(g, u, v)])


class MeasuredEnergyCost(EnergyCost):
    """EnergyCost with per-hop / per-worm constants fitted from counters.

    The analytic model assumes every worm-hop performs exactly F buffer
    writes/reads/crossbar/link events plus one arbitration; measured runs
    differ (ejection reads, lost arbitrations, relay re-injections).
    ``fit_energy_cost`` computes the measured pJ-per-worm-hop and
    pJ-per-worm from a run's event counters and builds this model.
    """

    name = "energy-calibrated"

    def __init__(self, per_hop_pj: float, per_packet_pj: float,
                 energy, flits_per_packet: int):
        # bypass EnergyCost.__init__'s analytic derivation: the measured
        # constants ARE the model
        self.energy = energy
        self.flits_per_packet = flits_per_packet
        self._per_hop = float(per_hop_pj)
        self._per_packet = float(per_packet_pj)


def fit_energy_cost(counters, energy, flits_per_packet: int,
                    ) -> MeasuredEnergyCost:
    """Fit EnergyCost constants from measured event counters.

    ``counters`` maps the SimStats counter names (``flit_link_traversals``,
    ``buffer_writes``, ``buffer_reads``, ``xbar_traversals``,
    ``arbitrations``, ``ni_flits``, ``packets_finished``) to totals — a
    ``SimStats``, an xsim ``ctr`` row dict, or any mapping-like object.
    """
    get = (
        counters.get if hasattr(counters, "get")
        else lambda k, d=0: getattr(counters, k, d)
    )
    e = energy
    hops = max(1.0, get("flit_link_traversals", 0) / flits_per_packet)
    packets = max(1, get("packets_finished", 0))
    per_hop = (
        get("buffer_writes", 0) * e.e_buffer_write
        + get("buffer_reads", 0) * e.e_buffer_read
        + get("xbar_traversals", 0) * e.e_xbar
        + get("arbitrations", 0) * e.e_arbiter
        + get("flit_link_traversals", 0) * e.e_link
    ) / hops
    per_packet = get("ni_flits", 0) * e.e_ni / packets
    return MeasuredEnergyCost(per_hop, per_packet, e, flits_per_packet)
