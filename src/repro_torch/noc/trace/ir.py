"""Trace IR: dependency-ordered phases of timestamped multicast events.

Twin of ``repro.noc.trace.ir`` (pure Python there and here; a copy, not an
import). A ``Trace`` is the NoC-facing snapshot of an ML workload: a
sequence of *phases* executed under barrier semantics — every event of
phase ``k`` must complete delivery before any event of phase ``k+1``
injects (the store-and-forward causality of a collective round, a pipeline
step, or a serving batch). Each phase holds timestamped events carrying a
source rank, a destination rank set, and a payload byte count; ranks are
abstract indices in ``[0, num_ranks)`` that the replay drivers embed onto
a mesh/torus in boustrophedon label order (``Topology.unlabel``), the
same rank->node convention ``dist.multicast`` schedules use.

Byte counts stay bytes in the IR — the replay layer converts them to
per-packet flit counts against a flit width (``replay.flits_for_bytes``),
so one captured trace replays faithfully across link-width configs.

Traces serialize to/from JSON (round-trip identity, and ``to_json`` byte
for byte the reference's — the artifact-diffing contract benchmarks rely
on).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class TraceEvent:
    """One multicast (or unicast) injection.

    ``time`` is the cycle offset *within the phase*; ``dests`` is the
    ordered destination rank tuple (unicast = one entry); ``payload_bytes``
    is the logical message size before flit conversion.
    """

    time: int
    src: int
    dests: tuple[int, ...]
    payload_bytes: int

    def validate(self, num_ranks: int) -> None:
        if self.time < 0:
            raise ValueError(f"event time must be >= 0 (got {self.time})")
        if not 0 <= self.src < num_ranks:
            raise ValueError(f"src {self.src} outside [0, {num_ranks})")
        if not self.dests:
            raise ValueError("event needs at least one destination")
        for d in self.dests:
            if not 0 <= d < num_ranks:
                raise ValueError(f"dest {d} outside [0, {num_ranks})")
        if self.src in self.dests:
            raise ValueError(f"src {self.src} cannot be its own destination")
        if len(set(self.dests)) != len(self.dests):
            raise ValueError(f"duplicate destinations in {self.dests}")
        if self.payload_bytes < 0:
            raise ValueError(f"negative payload ({self.payload_bytes})")


@dataclass(frozen=True)
class TracePhase:
    """One barrier-delimited batch of events (a collective round, a
    pipeline step, a coherence burst, a serving batch)."""

    name: str
    events: tuple[TraceEvent, ...]

    @property
    def span(self) -> int:
        """Last injection offset within the phase."""
        return max((e.time for e in self.events), default=0)

    @property
    def total_bytes(self) -> int:
        return sum(e.payload_bytes * len(e.dests) for e in self.events)


@dataclass(frozen=True)
class Trace:
    """A named workload trace: phases replay in order, barrier-separated."""

    name: str
    num_ranks: int
    phases: tuple[TracePhase, ...]
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.num_ranks < 2:
            raise ValueError(f"need >= 2 ranks (got {self.num_ranks})")
        for ph in self.phases:
            for e in ph.events:
                e.validate(self.num_ranks)

    @property
    def num_events(self) -> int:
        return sum(len(ph.events) for ph in self.phases)

    @property
    def total_bytes(self) -> int:
        return sum(ph.total_bytes for ph in self.phases)

    # ---------------------------------------------------------------- JSON
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(
            {
                "name": self.name,
                "num_ranks": self.num_ranks,
                "meta": self.meta,
                "phases": [
                    {
                        "name": ph.name,
                        "events": [
                            [e.time, e.src, list(e.dests), e.payload_bytes]
                            for e in ph.events
                        ],
                    }
                    for ph in self.phases
                ],
            },
            indent=indent,
        )

    @staticmethod
    def from_json(text: str) -> "Trace":
        d = json.loads(text)
        return Trace(
            name=d["name"],
            num_ranks=int(d["num_ranks"]),
            phases=tuple(
                TracePhase(
                    name=ph["name"],
                    events=tuple(
                        TraceEvent(int(t), int(s), tuple(int(x) for x in ds),
                                   int(b))
                        for t, s, ds, b in ph["events"]
                    ),
                )
                for ph in d["phases"]
            ),
            meta=d.get("meta", {}),
        )


def phase(name: str, events) -> TracePhase:
    """Phase constructor accepting any event iterable."""
    return TracePhase(name=name, events=tuple(events))


def trace(name: str, num_ranks: int, phases, meta: dict | None = None) -> Trace:
    """Trace constructor accepting any phase iterable."""
    return Trace(
        name=name, num_ranks=num_ranks, phases=tuple(phases),
        meta=meta or {},
    )
