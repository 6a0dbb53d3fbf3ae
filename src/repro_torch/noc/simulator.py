"""Flit-level wormhole NoC simulator with VC-split high/low subnetworks.

Twin of ``repro.noc.simulator``: the host, event-ordered oracle that the
batched xsim engine is held against, pure Python on the host as there. It
keeps the reference's containers (a ``set`` of pending packet ids, dicts of
FIFOs and NI lanes in insertion order, stable sorts on ``(age, pid, fid)``),
so its release and arbitration order, and the order of
``SimStats.latencies``, are the reference's.

Model (cycle-level, matching the paper's setup at the granularity its claims
need):

* A packet with route ``hops = [n0 .. nk]`` is a train of F flits moving
  through *stages*; stage ``i`` is the input FIFO at node ``hops[i+1]`` fed by
  directed link ``(hops[i], hops[i+1])``. Flits enter stage 0 from the source
  NI queue and are consumed by the ejection port after the last stage.
* Wormhole + VCs: the header flit allocates one VC (FIFO of depth
  ``buffer_depth``) per stage; body/tail follow on the same VC; the VC frees
  when the tail flit leaves that FIFO. Each physical directed link carries
  ``vcs_per_class`` high-channel and ``vcs_per_class`` low-channel VCs; a hop
  uses the high class iff the boustrophedon label increases on that hop (the
  paper's deadlock rule, applied to unicast and multicast alike). The rule is
  derived from the topology's label order, so it applies unchanged on a
  torus: wrap hops are classified by their label delta like any other hop
  (the snake's closing wrap link is a LOW hop).
* Bandwidth: one flit per directed physical link per cycle, age-based (oldest
  enqueue first) arbitration; one flit per node per cycle ejection.
* Path-based multicast delivery: a copy is absorbed when the **tail** flit
  reaches a delivery node (ejection copies are free — separate port).
* DPM MU-mode children are injected at the representative node R once the
  parent delivers there.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import torch

from ..core.grid import Coord, MeshGrid
from ..core.planner import MulticastPlan
from ..core.planner import plan as _registry_plan
from .config import NoCConfig
from .telemetry import Telemetry, link_index

HIGH, LOW = 0, 1
Link = tuple[Coord, Coord]


@dataclass
class _Pkt:
    pid: int
    hops: list[Coord]
    deliveries: set[Coord]
    enqueue_time: int
    parent: int | None  # global pid; child released when parent delivers at hops[0]
    is_multicast: bool
    flits: int  # worm length — per-packet (trace payloads vary)
    released: bool = False
    flits_sent: int = 0  # flits that left the source NI queue
    head_stage: int = -1  # highest stage the header has entered (-1: in NI)
    vc_held: dict = field(default_factory=dict)  # stage -> vc index
    delivery_times: dict = field(default_factory=dict)  # Coord -> cycle (tail)
    header_times: dict = field(default_factory=dict)  # Coord -> cycle (header)
    done: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.hops) - 1

    def link(self, stage: int) -> Link:
        return (self.hops[stage], self.hops[stage + 1])


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
    # structured per-link/per-VC/per-epoch view of the same events (the host
    # sim always attaches one, xsim none; the flat aggregates above stay the
    # public API and the conservation tests pin the two views equal)
    telemetry: Telemetry | None = field(
        default=None, compare=False, repr=False
    )

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


class WormholeSim:
    def __init__(self, cfg: NoCConfig, measure_window: tuple[int, int] | None = None):
        self.cfg = cfg
        self.g: MeshGrid = cfg.make_topology()
        self.packets: list[_Pkt] = []
        self.fifos: dict[Link, list[deque]] = {}  # link -> per-VC FIFOs
        self.vc_owner: dict[tuple[Link, int], int] = {}
        self.src_queues: dict[tuple[Coord, int], deque] = {}
        self.stats = SimStats(
            telemetry=Telemetry(
                self.g.num_nodes, cfg.vcs_per_class, cfg.epoch_len,
                ports=self.g.ports,
            )
        )
        self._lids: dict[Link, int] = {}  # link -> directed-link id memo
        self.time = 0
        self._measure = measure_window
        self._pending: set[int] = set()
        self._active: set[int] = set()

    # ------------------------------------------------------------- helpers
    def _fifo(self, link: Link) -> list[deque]:
        f = self.fifos.get(link)
        if f is None:
            f = [deque() for _ in range(2 * self.cfg.vcs_per_class)]
            self.fifos[link] = f
        return f

    def _class(self, link: Link) -> int:
        return HIGH if self.g.label(*link[1]) > self.g.label(*link[0]) else LOW

    def _lid(self, link: Link) -> int:
        lid = self._lids.get(link)
        if lid is None:
            lid = self._lids[link] = link_index(self.g, *link)
        return lid

    # ----------------------------------------------------------- admission
    def add_request(
        self,
        algo,
        src: Coord,
        dests: list[Coord],
        enqueue_time: int,
        cost_model=None,
        flits: int | None = None,
    ) -> list[int]:
        """Plan one multicast via the algorithm registry and ingest it.

        ``algo`` is a registered name or ``RoutingAlgorithm`` instance;
        unknown names raise listing what is registered, and algorithms that
        do not support this simulator's topology kind are rejected before
        any packet is admitted. ``flits`` overrides the per-packet worm
        length (default ``cfg.flits_per_packet``).
        """
        return self.add_plan(
            _registry_plan(algo, self.g, src, dests, cost_model=cost_model),
            enqueue_time,
            flits=flits,
        )

    def add_requests(self, algo, requests, cost_model=None, *,
                     device: torch.device | str = "cuda") -> list[list[int]]:
        """Bulk admission: plan every request through the shared plan arena
        (``core.batch_planner.bulk_plan`` — batched ``dpm_plan_exact`` on
        ``device`` for all arena misses where the fabric supports it, host
        planning otherwise) and ingest each plan at its request time.

        ``requests`` is an iterable of ``noc.traffic.Request``-likes
        (``.src``, ``.dests``, ``.time``, optional ``.flits``). Plans are
        bit-identical to per-request ``add_request`` calls; returns the
        per-request packet-id lists in order. ``device`` is where
        ``dpm_plan_exact`` runs DPM's batched plans: plain torch on either
        device, no ``dpm_cost`` kernel. It defaults to the card and raises
        without one; pass ``device="cpu"`` to plan on the host.
        """
        from ..core.batch_planner import bulk_plan

        reqs = list(requests)
        plans = bulk_plan(
            self.g, [(r.src, r.dests) for r in reqs], algo,
            cost_model=cost_model, device=device,
        )
        return [
            self.add_plan(p, r.time, flits=getattr(r, "flits", None))
            for r, p in zip(reqs, plans)
        ]

    def add_plan(
        self, plan: MulticastPlan, enqueue_time: int, flits: int | None = None
    ) -> list[int]:
        """Ingest a pre-planned multicast.

        On a degraded topology (``cfg.broken_links``) every path is checked
        hop by hop: a plan that would push a flit across a broken link is
        refused outright — routes must come from the fault-aware provider
        (``add_request`` does), not from a healthy-topology plan.
        """
        is_broken = getattr(self.g, "is_broken", None)
        if is_broken is not None:
            for path in plan.paths:
                for u, v in zip(path.hops, path.hops[1:]):
                    if is_broken(u, v):
                        raise ValueError(
                            f"plan {plan.algorithm!r} traverses broken link "
                            f"({u}, {v}); replan on the degraded topology"
                        )
        flits = self.cfg.flits_per_packet if flits is None else int(flits)
        if flits < 1:
            raise ValueError(f"packet needs at least one flit (got {flits})")
        base = len(self.packets)
        pids = []
        for path in plan.paths:
            if len(path.hops) == 1:
                # degenerate: source is the only "delivery" (can happen for
                # a representative == destination plan); deliver instantly
                continue
            pid = len(self.packets)
            parent = None if path.parent is None else base + path.parent
            self.packets.append(
                _Pkt(
                    pid,
                    path.hops,
                    set(path.deliveries),
                    enqueue_time,
                    parent,
                    is_multicast=len(plan.dests) > 1,
                    flits=flits,
                )
            )
            self._pending.add(pid)
            pids.append(pid)
        return pids

    def _release_ready(self, now: int) -> None:
        for pid in list(self._pending):
            p = self.packets[pid]
            if p.enqueue_time > now:
                continue
            if p.parent is not None:
                # Cut-through relay: the NI at R forks/re-injects as soon as
                # the parent's HEADER arrives (payload flits stream behind).
                t = self.packets[p.parent].header_times.get(p.hops[0])
                if t is None or t >= now:
                    continue
            p.released = True
            # Relayed children (DPM re-injection at R) use the NI's multicast
            # relay port, not the node's normal injection queue: the router's
            # multicast unit forks locally instead of queuing behind fresh
            # traffic (VCTM-style NI support). Link bandwidth is still shared.
            lane = (p.hops[0], 1 if p.parent is not None else 0)
            self.src_queues.setdefault(lane, deque()).append(pid)
            self.stats.packets_created += 1
            self._pending.discard(pid)
            self._active.add(pid)

    # ------------------------------------------------------------ delivery
    def _tail_arrived(self, p: _Pkt, stage: int, now: int) -> None:
        node = p.hops[stage + 1]
        if node in p.deliveries and node not in p.delivery_times:
            p.delivery_times[node] = now
            lat = now - p.enqueue_time
            if self._measure is None or (
                self._measure[0] <= p.enqueue_time < self._measure[1]
            ):
                self.stats.latencies.append(lat)
                self.stats.telemetry.latency(lat, now)

    def _maybe_finish(self, p: _Pkt) -> None:
        if not p.vc_held and p.flits_sent >= p.flits and (
            p.head_stage == p.num_stages - 1
        ):
            if not p.done:
                p.done = True
                self._active.discard(p.pid)
                self.stats.packets_finished += 1

    # ------------------------------------------------------------ main loop
    def run(self, max_cycles: int, drain: bool = True, watchdog: int = 50_000):
        B = self.cfg.buffer_depth
        V = self.cfg.vcs_per_class
        last_progress = self.time
        end = self.time + max_cycles
        while self.time < end:
            now = self.time
            self._release_ready(now)
            progressed = False

            # ---- 1. gather candidates per target link -------------------
            # candidate: (age key, pid, fid, from_stage) wanting to enter
            # stage = from_stage + 1's FIFO (or stage 0 from the NI).
            cand: dict[Link, list] = {}
            for lane, q in self.src_queues.items():
                if not q:
                    continue
                pid = q[0]
                p = self.packets[pid]
                if p.flits_sent < p.flits:
                    link = p.link(0)
                    cand.setdefault(link, []).append(
                        (p.enqueue_time, pid, p.flits_sent, -1)
                    )
            for link, fifos in self.fifos.items():
                for vc, fifo in enumerate(fifos):
                    if not fifo:
                        continue
                    pid, fid, stage = fifo[0]
                    p = self.packets[pid]
                    if stage + 1 >= p.num_stages:
                        continue  # at final stage: ejection handles it
                    nxt = p.link(stage + 1)
                    cand.setdefault(nxt, []).append((p.enqueue_time, pid, fid, stage))

            # ---- 2. per-link arbitration: one flit crosses each link ----
            tm = self.stats.telemetry
            for link, reqs in cand.items():
                reqs.sort(key=lambda c: (c[0], c[1], c[2]))
                self.stats.arbitrations += len(reqs)
                lid = self._lid(link)
                if len(reqs) > 1:  # everyone but one winner loses this cycle
                    tm.conflicts(lid, len(reqs) - 1)
                fifos = self._fifo(link)
                for age, pid, fid, from_stage in reqs:
                    p = self.packets[pid]
                    to_stage = from_stage + 1
                    cls = self._class(link)
                    if fid == 0:  # header: allocate a VC of the hop's class
                        lo = 0 if cls == HIGH else V
                        vc = next(
                            (
                                i
                                for i in range(lo, lo + V)
                                if (link, i) not in self.vc_owner
                            ),
                            None,
                        )
                        if vc is None:
                            tm.stall(lid)  # no free VC in the hop's class
                            continue
                        self.vc_owner[(link, vc)] = pid
                        p.vc_held[to_stage] = vc
                        p.head_stage = to_stage
                    else:
                        vc = p.vc_held.get(to_stage)
                        if vc is None or len(fifos[vc]) >= B:
                            tm.stall(lid)  # no credit (or header still queued)
                            continue  # header not yet there / no credit
                    # move the flit
                    if from_stage == -1:
                        p.flits_sent += 1
                        self.stats.ni_flits += 1
                        if p.flits_sent == p.flits:
                            lane0 = (p.hops[0], 1 if p.parent is not None else 0)
                            self.src_queues[lane0].popleft()
                    else:
                        src_vc = p.vc_held[from_stage]
                        self._fifo(p.link(from_stage))[src_vc].popleft()
                        self.stats.buffer_reads += 1
                        if fid == p.flits - 1:  # tail left from_stage: free its VC
                            self.vc_owner.pop((p.link(from_stage), src_vc), None)
                            del p.vc_held[from_stage]
                    fifos[vc].append((pid, fid, to_stage))
                    self.stats.buffer_writes += 1
                    self.stats.xbar_traversals += 1
                    self.stats.flit_link_traversals += 1
                    tm.flit(lid, cls, now)
                    tm.occupancy(lid, vc, len(fifos[vc]))
                    if fid == 0:
                        # first header arrival per node: releases relayed
                        # children (DPM MU re-injection and the degraded-
                        # topology monotone segments) at any hop, delivery
                        # or not
                        node = p.hops[to_stage + 1]
                        if node not in p.header_times:
                            p.header_times[node] = now
                    if fid == p.flits - 1:
                        self._tail_arrived(p, to_stage, now)
                    progressed = True
                    break  # one flit per link per cycle

            # ---- 3. ejection: one flit per node per cycle ----------------
            ej: dict[Coord, list] = {}
            for link, fifos in self.fifos.items():
                for vc, fifo in enumerate(fifos):
                    if not fifo:
                        continue
                    pid, fid, stage = fifo[0]
                    p = self.packets[pid]
                    if stage + 1 == p.num_stages:
                        ej.setdefault(link[1], []).append(
                            (p.enqueue_time, pid, fid, stage, link, vc)
                        )
            for node, reqs in ej.items():
                reqs.sort(key=lambda c: (c[0], c[1], c[2]))
                age, pid, fid, stage, link, vc = reqs[0]
                p = self.packets[pid]
                self._fifo(link)[vc].popleft()
                self.stats.buffer_reads += 1
                self.stats.ni_flits += 1
                progressed = True
                if fid == p.flits - 1:  # tail ejected: packet complete
                    self.vc_owner.pop((link, vc), None)
                    p.vc_held.pop(stage, None)
                    self._maybe_finish(p)

            if progressed:
                last_progress = now
            elif now - last_progress > watchdog:
                raise RuntimeError(f"simulator wedged at cycle {now}")
            for q in self.src_queues.values():
                if len(q) > self.stats.max_srcq:
                    self.stats.max_srcq = len(q)
            self.time += 1
            if drain and not self._pending and not self._active:
                break

        self.stats.cycles = self.time
        return self.stats
