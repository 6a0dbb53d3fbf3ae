"""Lowerers: real workload code paths -> ``Trace`` phase sequences.

Twin of ``repro.noc.trace.lower`` (a copy adapted to the port, not an
import). Every producer here captures the *communication shape* of a code
path of the system — collective schedules from ``dist.multicast``, GPipe
handoffs (the reference's ``dist.pipeline`` step loop), the int8 RS+AG
rounds of its ``dist.compress``, HLO collective mixes (its
``launch.hlo.collective_bytes``) — plus two synthetic generators
(directory coherence invalidations, Poisson serving arrivals) for traffic
classes the collectives layer does not emit. The seeded generators draw
from numpy exactly as the reference does, so both give the same events.

Producers that plan schedules take ``device``: where ``bulk_plan`` plans
DPM's batched misses (the card by default; ``device="cpu"`` plans there).

Ranks are abstract; the replay drivers embed rank ``r`` at
``topo.unlabel(r)`` (boustrophedon order), matching the 1-D ring embedding
``dist.multicast`` schedules assume.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ir import Trace, TraceEvent, TracePhase

# Control-message payload (coherence invalidations / acks): header-only.
CTRL_BYTES = 8


# --------------------------------------------------------------------------
# dist.multicast schedules
# --------------------------------------------------------------------------
def from_schedule(
    sched,
    name: str,
    payload_bytes: int,
    req_payload_bytes: dict[int, int] | None = None,
    phase_prefix: str = "round",
    meta: dict | None = None,
) -> Trace:
    """Lower a ``dist.multicast.Schedule`` round-by-round.

    Each ppermute round becomes one phase (the store-and-forward causality
    a round boundary encodes *is* the trace barrier); every transfer is a
    unicast event at offset 0 carrying ``req_payload_bytes[rid]`` (falling
    back to ``payload_bytes``) — the same per-request attribution
    ``Schedule.cost`` uses.
    """
    phases = []
    reqs = sched.round_reqs or [[] for _ in sched.rounds]
    for r, (rnd, rr) in enumerate(zip(sched.rounds, reqs)):
        events = []
        for k, (s, d) in enumerate(rnd):
            b = payload_bytes
            if req_payload_bytes is not None and k < len(rr):
                b = req_payload_bytes.get(rr[k], payload_bytes)
            events.append(TraceEvent(0, s, (d,), b))
        phases.append(TracePhase(f"{phase_prefix}{r}", tuple(events)))
    m = {"schedule_rounds": sched.num_rounds, "schedule_hops": sched.total_hops}
    m.update(meta or {})
    return Trace(name, sched.num_ranks, tuple(phases), m)


def ep_dispatch_trace(
    num_ranks: int, chunk_bytes: int = 256, algo: str = "DPM", *,
    device: torch.device | str = "cuda",
) -> Trace:
    """Expert-parallel all-to-all: dispatch rounds then combine rounds.

    Both halves replay ``dist.multicast.alltoall_schedule`` — the schedule
    expert-parallel MoE's token exchange realizes — with one chunk of
    ``chunk_bytes`` per (src, dst) pair.
    """
    from ...dist.multicast import alltoall_schedule

    sched = alltoall_schedule(num_ranks, algo, device=device)
    disp = from_schedule(sched, "ep", chunk_bytes, phase_prefix="dispatch.r")
    comb = from_schedule(sched, "ep", chunk_bytes, phase_prefix="combine.r")
    return Trace(
        f"ep_alltoall.n{num_ranks}.{algo}",
        num_ranks,
        disp.phases + comb.phases,
        {"algo": algo, "chunk_bytes": chunk_bytes, "kind": "ep_alltoall"},
    )


def zero1_gather_trace(
    num_ranks: int, param_bytes: int, algo: str = "DPM", *,
    device: torch.device | str = "cuda",
) -> Trace:
    """ZeRO-1 parameter all-gather over a data axis.

    Each rank owns a ``param_bytes / n`` optimizer shard (the reference's
    ``dist.sharding.zero1_shardings``) and broadcasts it to every peer;
    the n concurrent broadcasts are packed into ppermute rounds by
    ``schedule_multicasts`` on the rank ring.
    """
    from ...core.topology import torus
    from ...dist.multicast import schedule_multicasts

    ring = torus(num_ranks, 1)
    requests = [
        ((i, 0), [(j, 0) for j in range(num_ranks) if j != i])
        for i in range(num_ranks)
    ]
    shard = max(1, math.ceil(param_bytes / num_ranks))
    sched = schedule_multicasts(ring, requests, algo, device=device)
    return from_schedule(
        sched,
        f"zero1_gather.n{num_ranks}.{algo}",
        shard,
        phase_prefix="ag.r",
        meta={"algo": algo, "param_bytes": param_bytes, "kind": "zero1"},
    )


def compressed_allreduce_trace(
    num_ranks: int, grad_bytes: int, algo: str = "DPM", *,
    device: torch.device | str = "cuda",
) -> Trace:
    """int8 compressed gradient all-reduce (the reference's
    ``dist.compress``): an int8
    reduce-scatter rendered as the all-to-all chunk exchange it lowers to,
    then the all-gather of re-quantized reduced chunks. Chunks are
    ``grad_bytes / (4 n)`` — f32 gradients quantized 4x, split n ways."""
    from ...core.topology import torus
    from ...dist.multicast import alltoall_schedule, schedule_multicasts

    chunk = max(1, math.ceil(grad_bytes / (4 * num_ranks)))
    rs = from_schedule(
        alltoall_schedule(num_ranks, algo, device=device), "rs", chunk,
        phase_prefix="rs.r",
    )
    ring = torus(num_ranks, 1)
    requests = [
        ((i, 0), [(j, 0) for j in range(num_ranks) if j != i])
        for i in range(num_ranks)
    ]
    ag = from_schedule(
        schedule_multicasts(ring, requests, algo, device=device), "ag",
        chunk, phase_prefix="ag.r",
    )
    return Trace(
        f"int8_allreduce.n{num_ranks}.{algo}",
        num_ranks,
        rs.phases + ag.phases,
        {"algo": algo, "grad_bytes": grad_bytes, "chunk_bytes": chunk,
         "kind": "int8_allreduce"},
    )


def pipeline_trace(
    num_stages: int, num_micro: int, activation_bytes: int = 512
) -> Trace:
    """GPipe stage handoffs (the reference's
    ``dist.pipeline.pipeline_apply``): the static ``M + S - 1`` step loop,
    one phase per step, stage ``s`` shipping its microbatch activation to
    ``s + 1`` whenever it holds one (the per-step shift). Ranks are
    pipeline stages."""
    phases = []
    for t in range(num_micro + num_stages - 1):
        events = tuple(
            TraceEvent(0, s, (s + 1,), activation_bytes)
            for s in range(num_stages - 1)
            if 0 <= t - s < num_micro
        )
        if events:
            phases.append(TracePhase(f"step{t}", events))
    return Trace(
        f"gpipe.s{num_stages}.m{num_micro}",
        num_stages,
        tuple(phases),
        {"num_micro": num_micro, "activation_bytes": activation_bytes,
         "kind": "pipeline"},
    )


# --------------------------------------------------------------------------
# HLO collective mixes
# --------------------------------------------------------------------------
def from_hlo(
    hlo_or_collectives,
    num_ranks: int,
    name: str = "hlo",
    algo: str = "DPM",
    scale_to: int | None = None,
    *,
    device: torch.device | str = "cuda",
) -> Trace:
    """Lower an HLO collective-byte profile onto the rank fabric.

    Accepts HLO text (read through ``launch.hlo.collective_bytes``) or an
    already-computed ``{kind: bytes}`` dict. Each collective kind maps to
    the phase structure its exchange pattern implies, for a logical buffer
    of ``B`` bytes over ``n`` ranks:

    * ``all-gather``      — each rank broadcasts its ``B/n`` shard
      (``schedule_multicasts`` rounds);
    * ``reduce-scatter``  — all-to-all of ``B/n`` chunks;
    * ``all-reduce``      — reduce-scatter then all-gather of ``B/n``;
    * ``all-to-all``      — all-to-all of ``B/n`` chunks;
    * ``collective-permute`` — one phase, every rank shipping ``B`` to its
      +1 ring neighbor.

    ``scale_to`` rescales the *largest* per-event payload down to that many
    bytes (ratios preserved) so multi-GB training buffers replay as
    NoC-sized worms instead of all clamping at the flit ceiling; the factor
    lands in ``meta["byte_scale"]``.
    """
    from ...core.topology import torus
    from ...dist.multicast import alltoall_schedule, schedule_multicasts

    if isinstance(hlo_or_collectives, str):
        from ...launch.hlo import collective_bytes

        coll = collective_bytes(hlo_or_collectives)
    else:
        coll = dict(hlo_or_collectives)
    kinds = [
        (k, float(coll.get(k, 0.0)))
        for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
    ]
    kinds = [(k, b) for k, b in kinds if b > 0]
    if not kinds:
        raise ValueError(f"no collective bytes in profile {sorted(coll)}")

    per_event = {
        k: b / num_ranks if k != "collective-permute" else b
        for k, b in kinds
    }
    scale = 1.0
    if scale_to is not None:
        scale = scale_to / max(per_event.values())

    def nbytes(k):
        return max(1, math.ceil(per_event[k] * scale))

    ring = torus(num_ranks, 1)
    bcast_reqs = [
        ((i, 0), [(j, 0) for j in range(num_ranks) if j != i])
        for i in range(num_ranks)
    ]
    a2a = alltoall_schedule(num_ranks, algo, device=device)

    phases: list[TracePhase] = []

    def add(tr: Trace):
        phases.extend(tr.phases)

    for k, _ in kinds:
        if k == "all-gather":
            add(from_schedule(
                schedule_multicasts(ring, bcast_reqs, algo, device=device),
                k, nbytes(k),
                phase_prefix=f"{k}.r",
            ))
        elif k in ("reduce-scatter", "all-to-all"):
            add(from_schedule(a2a, k, nbytes(k), phase_prefix=f"{k}.r"))
        elif k == "all-reduce":
            add(from_schedule(a2a, k, nbytes(k), phase_prefix=f"{k}.rs.r"))
            add(from_schedule(
                schedule_multicasts(ring, bcast_reqs, algo, device=device),
                k, nbytes(k),
                phase_prefix=f"{k}.ag.r",
            ))
        else:  # collective-permute: +1 ring shift
            phases.append(TracePhase(
                f"{k}.r0",
                tuple(
                    TraceEvent(0, i, ((i + 1) % num_ranks,), nbytes(k))
                    for i in range(num_ranks)
                ),
            ))
    return Trace(
        name, num_ranks, tuple(phases),
        {"algo": algo, "byte_scale": scale, "kind": "hlo_mix",
         "collectives": {k: b for k, b in kinds}},
    )


def model_collective_mix(
    arch_name: str,
    num_ranks: int,
    algo: str = "DPM",
    scale_to: int = 512,
    *,
    device: torch.device | str = "cuda",
) -> Trace:
    """Per-training-step collective mix of a ``repro_torch.configs`` model.

    Sizes come from the parameter total of the real model, counted by the
    port's ``models.model_init`` on the meta device (the reference counts
    its abstract init, ``launch.specs.param_counts``; both include the
    padded vocabulary): bf16 gradient all-reduce over the data axis, the
    ZeRO-1 bf16 parameter all-gather, and — for MoE archs — the
    expert-parallel token all-to-all (bf16 activations for one ~1k-token
    microbatch, dispatch + combine). ``from_hlo`` then lowers the byte
    profile with payloads rescaled to NoC-sized worms. An arch the port
    does not have raises, as ``configs.get_arch`` does.
    """
    from ...configs import get_arch
    from ...models import RunConfig, model_init
    from ...models.layers import count_params

    cfg = get_arch(arch_name)
    total = count_params(
        model_init(0, cfg, RunConfig(), device=torch.device("meta"))[0]
    )
    coll = {
        "all-reduce": 2.0 * total,  # bf16 grads over data axis
        "all-gather": 2.0 * total,  # zero1 param gather
    }
    if cfg.moe:
        # EP dispatch+combine: ~1k tokens of bf16 d_model activations
        coll["all-to-all"] = 2.0 * 2.0 * cfg.d_model * 1024
    return from_hlo(
        coll, num_ranks, f"mix.{arch_name}.n{num_ranks}.{algo}", algo,
        scale_to=scale_to, device=device,
    )


# --------------------------------------------------------------------------
# synthetic generators
# --------------------------------------------------------------------------
def coherence_trace(
    num_ranks: int,
    num_bursts: int = 4,
    lines_per_burst: int = 4,
    sharers: int = 4,
    seed: int = 0,
) -> Trace:
    """Directory-coherence invalidation bursts.

    Each burst is a write acquiring exclusive ownership of a few cache
    lines: the line's home node multicasts a header-only invalidation to
    the sharer set (phase ``inv.bK``), and the sharers ack back (phase
    ``ack.bK``) — the ack phase cannot inject before the invalidations
    deliver, which is exactly the trace barrier.
    """
    rng = np.random.default_rng(seed)
    sharers = min(sharers, num_ranks - 1)
    phases = []
    for b in range(num_bursts):
        inv, ack = [], []
        for _ in range(lines_per_burst):
            home = int(rng.integers(num_ranks))
            others = [r for r in range(num_ranks) if r != home]
            dests = tuple(
                int(x) for x in rng.choice(others, size=sharers, replace=False)
            )
            inv.append(TraceEvent(0, home, dests, CTRL_BYTES))
            ack.extend(TraceEvent(0, d, (home,), CTRL_BYTES) for d in dests)
        # acks from one sharer to distinct homes are distinct unicasts;
        # drop exact duplicates (same sharer acking the same home twice in
        # one burst collapses to one message)
        seen, uack = set(), []
        for e in ack:
            key = (e.src, e.dests)
            if key not in seen:
                seen.add(key)
                uack.append(e)
        phases.append(TracePhase(f"inv.b{b}", tuple(inv)))
        phases.append(TracePhase(f"ack.b{b}", tuple(uack)))
    return Trace(
        f"coherence.n{num_ranks}.s{seed}",
        num_ranks,
        tuple(phases),
        {"num_bursts": num_bursts, "lines_per_burst": lines_per_burst,
         "sharers": sharers, "seed": seed, "kind": "coherence"},
    )


def serving_trace(
    num_ranks: int,
    num_requests: int = 24,
    rate: float = 0.02,
    act_bytes: int = 256,
    max_batch: int = 8,
    seed: int = 0,
) -> Trace:
    """Poisson serving arrivals batched ``serve.engine.BatchServer``-style.

    Requests arrive as a Poisson process (exponential inter-arrivals at
    ``rate`` per cycle) on random entry ranks; the server admits up to
    ``max_batch`` in arrival order, and a new batch starts only when the
    previous one retires — so each batch is one phase, with each request's
    activations broadcast to the model-parallel group (all other ranks) at
    its arrival offset within the batch window.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=num_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    entries = rng.integers(num_ranks, size=num_requests)
    phases = []
    for b in range(0, num_requests, max_batch):
        batch = range(b, min(b + max_batch, num_requests))
        t0 = int(arrivals[b])
        events = tuple(
            TraceEvent(
                int(arrivals[i]) - t0,
                int(entries[i]),
                tuple(r for r in range(num_ranks) if r != int(entries[i])),
                act_bytes,
            )
            for i in batch
        )
        phases.append(TracePhase(f"batch{b // max_batch}", events))
    return Trace(
        f"serving.n{num_ranks}.s{seed}",
        num_ranks,
        tuple(phases),
        {"num_requests": num_requests, "rate": rate, "act_bytes": act_bytes,
         "max_batch": max_batch, "seed": seed, "kind": "serving"},
    )
