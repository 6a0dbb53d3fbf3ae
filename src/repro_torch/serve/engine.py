"""Deadline batching over a queue. Twin of the batching primitive of
``repro.serve.engine``; that module's ``BatchServer`` and ``generate`` serve
the ML models and come with the ML-stack slice of the port."""
from __future__ import annotations

import queue
import threading
import time

_POLL_S = 0.05  # stop-event poll interval while blocked on an empty queue


def take_batch(q: queue.Queue, max_batch: int, max_wait_s: float,
               stop: threading.Event | None = None) -> list:
    """Deadline batching over any queue: block for the first item, then
    admit more until the batch is full or ``max_wait_s`` has elapsed since
    the first arrival.

    The batching primitive of the plan server's streaming driver
    (``serve.planserve``). With ``stop`` given, the blocking wait polls the
    event and returns ``[]`` once it fires and the queue is empty — the
    clean-shutdown path ``close()`` relies on; queued items are still
    drained into batches first.
    """
    first = None
    while first is None:
        if stop is None:
            first = q.get()
            break
        try:
            first = q.get(timeout=_POLL_S)
        except queue.Empty:
            if stop.is_set():
                return []
    out = [first]
    deadline = time.monotonic() + max_wait_s
    while len(out) < max_batch:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            out.append(q.get(timeout=left))
        except queue.Empty:
            break
    return out
