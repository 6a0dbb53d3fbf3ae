"""Serving: batched prefill + decode with greedy/temperature sampling, a
queue-based batch server, and the deadline-batching primitive. Twin of
``repro.serve.engine``.

``generate`` and ``BatchServer`` take ``device=`` (default the card; a
missing card raises). As in the reference, a batch is left-padded with
token 0 to its longest prompt and no pad mask is applied, and sampling
reads the logits of the real vocabulary (``[:, :vocab]``). A frame model's
``generate`` takes frame prompts ``(B, S, d)`` and feeds back zero frames
``(B, 1, d)`` at each decode step, as the reference's does; ``BatchServer``
serves token prompts, as the reference's does. Sampling with
``temperature > 0`` draws from a ``torch.Generator`` seeded with ``seed``:
deterministic per seed, not the reference's ``jax.random`` bits.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ArchConfig, RunConfig
from ..models.model import decode_step, prefill


@dataclass
class GenResult:
    tokens: np.ndarray  # (B, steps)
    prefill_ms: float
    decode_ms_per_token: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(
    params,
    cfg: ArchConfig,
    run: RunConfig,
    prompts,  # (B, S) int tokens, or a frame model's frames (B, S, d)
    steps: int,
    temperature: float = 0.0,
    seed: int = 0,
    *,
    device: torch.device | str = "cuda",
) -> GenResult:
    dev = resolve_device(device)
    tokens = cfg.embed_input == "tokens"
    prompts = torch.as_tensor(prompts).to(
        dev, torch.int32 if tokens else torch.float32)
    B, S = prompts.shape[:2]
    key = "tokens" if tokens else "frames"

    _sync(dev)
    t0 = time.monotonic()
    logits, caches = prefill(params, {key: prompts}, cfg, run,
                             cache_len=S + steps)
    _sync(dev)
    prefill_ms = (time.monotonic() - t0) * 1e3

    out = np.zeros((B, steps), np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t1 = time.monotonic()
    for t in range(steps):
        lg = logits[:, -1, : cfg.vocab]
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(lg, dim=-1)
        out[:, t] = tok.cpu().numpy()
        if t == steps - 1:
            break
        batch = {"pos": S + t}
        if tokens:
            batch["tokens"] = tok[:, None].to(torch.int32)
        else:  # frame models feed back an embedding stub
            batch["frames"] = torch.zeros((B, 1, cfg.d_model), device=dev)
        logits, caches = decode_step(params, caches, batch, cfg, run)
    _sync(dev)
    decode_ms = (time.monotonic() - t1) * 1e3 / max(1, steps - 1)
    return GenResult(out, prefill_ms, decode_ms)


_POLL_S = 0.05  # stop-event poll interval while blocked on an empty queue


def take_batch(q: queue.Queue, max_batch: int, max_wait_s: float,
               stop: threading.Event | None = None) -> list:
    """Deadline batching over any queue: block for the first item, then
    admit more until the batch is full or ``max_wait_s`` has elapsed since
    the first arrival.

    The shared batching primitive of ``BatchServer`` and the plan server's
    streaming driver (``serve.planserve``). With ``stop`` given, the
    blocking wait polls the event and returns ``[]`` once it fires and the
    queue is empty — the clean-shutdown path ``close()`` relies on; queued
    items are still drained into batches first.
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


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_tokens: int
    submitted: float = field(default_factory=time.monotonic)


@dataclass
class Response:
    rid: int
    tokens: np.ndarray
    latency_s: float


class BatchServer:
    """Collect requests into fixed-size batches (pad to the longest prompt),
    run generate(), return per-request responses. Continuous-batching-lite:
    a new batch is admitted as soon as the previous one retires.

    ``close()`` stops admission (further ``submit`` raises) and unblocks
    any ``serve_once`` waiting on an empty queue; with ``drain=True`` it
    serves out whatever was already queued first. ``queue_depth`` reports
    the requests waiting for admission. ``params`` must lie on ``device``;
    ``last_result`` holds the last batch's ``GenResult`` (its timings)."""

    def __init__(self, params, cfg: ArchConfig, run: RunConfig,
                 max_batch: int = 8, max_wait_s: float = 0.05, *,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.params, self.cfg, self.run = params, cfg, run
        self.max_batch, self.max_wait_s = max_batch, max_wait_s
        self.queue: queue.Queue[Request] = queue.Queue()
        self.stats = {"batches": 0, "requests": 0, "tokens": 0}
        self._closed = threading.Event()
        self.last_result: GenResult | None = None  # the last batch's timing

    @property
    def queue_depth(self) -> int:
        return self.queue.qsize()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def submit(self, req: Request):
        if self._closed.is_set():
            raise RuntimeError("BatchServer is closed")
        self.queue.put(req)

    def close(self, drain: bool = True) -> list[Response]:
        """Stop admitting requests. With ``drain`` (default), serve every
        already-queued request to completion and return those responses;
        without, queued requests are dropped."""
        self._closed.set()
        out: list[Response] = []
        if drain:
            while not self.queue.empty():
                out.extend(self.serve_once())
        else:
            while True:
                try:
                    self.queue.get_nowait()
                except queue.Empty:
                    break
        return out

    def serve_once(self) -> list[Response]:
        reqs = take_batch(self.queue, self.max_batch, self.max_wait_s,
                          stop=self._closed)
        if not reqs:  # closed and drained
            return []
        S = max(len(r.prompt) for r in reqs)
        steps = max(r.max_tokens for r in reqs)
        B = len(reqs)
        prompts = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):  # left-pad to align last token
            prompts[i, S - len(r.prompt):] = r.prompt
        res = generate(self.params, self.cfg, self.run, prompts, steps,
                       device=self.device)
        now = time.monotonic()
        self.stats["batches"] += 1
        self.stats["requests"] += B
        self.stats["tokens"] += B * steps
        self.last_result = res
        return [
            Response(r.rid, res.tokens[i, : r.max_tokens], now - r.submitted)
            for i, r in enumerate(reqs)
        ]
