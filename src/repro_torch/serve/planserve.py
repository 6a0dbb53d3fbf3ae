"""Streaming plan server over the device plan arena.

Twin of ``repro.serve.planserve``. ``PlanServer`` is the serving front-end
to ``core.batch_planner``: callers ``submit()`` (src, dest-set) instances and
get ``Future``s back; a background thread gathers arrivals with deadline
batching (``engine.take_batch``) and plans each batch through the shared
``BatchPlanner`` of its device — one ``dpm_plan_exact`` dispatch per batch
of arena misses. ``prefetch()`` enqueues fire-and-forget requests so a simulation
driver can overlap the planning of its next phase with the simulation of
the current one; by the time it asks for those plans they are arena hits.

Plans returned are bit-identical to host ``plan()`` (the batched planner's
contract); fabrics or objectives outside ``batch_support`` transparently
plan on the host path, same arena, same futures.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import torch

from ..core.batch_planner import DISPATCH_CHUNK, ArenaInfo, planner_for
from ..core.planner import MulticastPlan
from .engine import take_batch


class PlanServer:
    """Deadline-batched asynchronous planning service.

    One background thread per server; ``max_wait_s`` trades per-request
    latency for batch size. ``device`` is the planner's (default the card;
    a missing card raises). Thread-safe:
    any number of producers may ``submit``/``prefetch`` concurrently.
    Usable as a context manager (``with PlanServer(topo) as ps: ...``) —
    exit closes with drain.
    """

    def __init__(self, topo, algo="DPM", cost_model=None, *,
                 max_batch: int = DISPATCH_CHUNK, max_wait_s: float = 0.002,
                 planner=None, device: torch.device | str = "cuda"):
        self.planner = (
            planner if planner is not None
            else planner_for(topo, algo, cost_model, device=device)
        )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.queue: queue.Queue[tuple] = queue.Queue()
        self.stats = {"batches": 0, "requests": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="planserve", daemon=True
        )
        self._thread.start()

    # ---------------------------------------------------------------- API
    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission into a planning batch."""
        return self.queue.qsize()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def submit(self, src, dests) -> "Future[MulticastPlan]":
        """Enqueue one instance; the Future resolves to its plan."""
        if self._stop.is_set():
            raise RuntimeError("PlanServer is closed")
        fut: "Future[MulticastPlan]" = Future()
        self.queue.put((src, dests, fut))
        return fut

    def prefetch(self, requests) -> None:
        """Fire-and-forget arena warming: enqueue ``[(src, dests), ...]``
        without futures. Later ``submit``/``plan`` calls (or direct
        ``bulk_plan`` consumers sharing the arena) hit the decoded plans."""
        if self._stop.is_set():
            raise RuntimeError("PlanServer is closed")
        for src, dests in requests:
            self.queue.put((src, dests, None))

    def plan(self, src, dests) -> MulticastPlan:
        """Synchronous convenience wrapper: submit and wait."""
        return self.submit(src, dests).result()

    def info(self) -> ArenaInfo:
        return self.planner.info()

    def close(self, drain: bool = True) -> None:
        """Shut the worker down. With ``drain`` (default) every queued
        request is still planned (pending futures resolve); without,
        pending futures are cancelled and the queue is dropped."""
        if not drain:
            while True:
                try:
                    _, _, fut = self.queue.get_nowait()
                except queue.Empty:
                    break
                if fut is not None:
                    fut.cancel()
        self._stop.set()
        self._thread.join(timeout=60.0)

    def __enter__(self) -> "PlanServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            batch = take_batch(
                self.queue, self.max_batch, self.max_wait_s, stop=self._stop
            )
            if not batch:  # stopped and drained
                return
            try:
                plans = self.planner.plan_many(
                    [(src, dests) for src, dests, _ in batch]
                )
            except Exception as e:  # propagate to every waiter, keep serving
                for _, _, fut in batch:
                    if fut is not None:
                        fut.set_exception(e)
                continue
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            for (_, _, fut), p in zip(batch, plans):
                if fut is not None:
                    fut.set_result(p)
