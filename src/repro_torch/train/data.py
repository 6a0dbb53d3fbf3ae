"""Deterministic data pipeline. Twin of ``repro.train.data``.

Synthetic corpus: batches are a pure function of (seed, step) — restart at
step k reproduces exactly the stream a continuous run would have seen, which
makes checkpoint-restart reproducible. The tokens come from numpy, as the
reference draws them, so the same (seed, step) gives the reference's tokens
and labels bit for bit; the batch is returned as tensors on ``device``.
A file-backed mode memory-maps a token binary and shards it by host.
Prefetch runs one step ahead on a background thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ArchConfig


@dataclass
class DataConfig:
    seed: int = 0
    corpus_path: str | None = None  # uint16/uint32 token binary (memmap)
    host_index: int = 0
    host_count: int = 1


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int,
                    step: int, device: torch.device | str = "cpu") -> dict:
    """Markov synthetic tokens with learnable structure: a restricted
    effective vocabulary plus a strong successor bias, so smoke training
    shows a real loss decrease within tens of steps (unigram first, then
    the bigram rule). ``tokens`` (a frame model's ``frames``, rows of a
    seeded embedding table) and ``labels``, int32 (frames f32)."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + np.uint64(step))
    v = cfg.vocab
    ev = min(v, 64)  # effective vocab
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, ev, batch)
    jump = rng.random((batch, seq)) < 0.1  # 10% random restarts
    rand = rng.integers(0, ev, (batch, seq))
    for t in range(seq):
        nxt = (toks[:, t] + 1) % ev
        toks[:, t + 1] = np.where(jump[:, t], rand[:, t], nxt)
    out = {}
    if cfg.embed_input == "tokens":
        out["tokens"] = torch.from_numpy(toks[:, :seq].copy())
    else:
        emb_rng = np.random.default_rng(np.uint64(seed) + 17)
        table = emb_rng.standard_normal((v, cfg.d_model), np.float32)
        out["frames"] = torch.from_numpy(table[toks[:, :seq]])
    out["labels"] = torch.from_numpy(toks[:, 1: seq + 1].copy())
    return {k: t.to(device) for k, t in out.items()}


class FileCorpus:
    """Memory-mapped token binary, sharded by host, sequential windows."""

    def __init__(self, path: str, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")

    def batch(self, cfg: ArchConfig, batch: int, seq: int, step: int,
              host_index: int = 0, host_count: int = 1,
              device: torch.device | str = "cpu") -> dict:
        n = len(self.tokens)
        span = batch * (seq + 1)
        start = (step * host_count + host_index) * span % max(1, n - span - 1)
        window = np.asarray(self.tokens[start: start + span]).astype(np.int32)
        window = window.reshape(batch, seq + 1) % cfg.vocab
        return {
            "tokens": torch.from_numpy(window[:, :seq].copy()).to(device),
            "labels": torch.from_numpy(window[:, 1:].copy()).to(device),
        }


class Prefetcher:
    """One-step-ahead background prefetch (straggler smoothing on hosts)."""

    def __init__(self, make_batch, start_step: int, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(s), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
