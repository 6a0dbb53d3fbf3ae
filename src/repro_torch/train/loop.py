"""Training loop: checkpoint/restart, straggler watchdog, metrics log.
Twin of ``repro.train.loop``.

* **checkpoint/restart** — async committed checkpoints every N steps, never
  more than one save in flight; auto-resume picks the latest COMMITTED
  step; the data pipeline is a pure function of step, so a restart
  replays the exact stream.
* **straggler mitigation** — per-step wall-clock EWMA; steps slower than
  ``straggler_factor`` x the EWMA are logged and counted. A step's time
  ends when its loss reaches the host, which waits for the card.

``train`` draws the parameters in f32 from the seed (``model_init`` of the
run with f32 activations: the master weights are drawn and stored in f32)
and casts the compute copy to ``run.params_dtype`` each step
(``train.step.cast_params``), as the reference does.

* **mesh** — under a ``shardctx`` mesh (as ``models.blocks`` reads it for
  expert parallelism) ``train`` runs on each rank of the mesh
  (``optim.DataParallel``): each rank takes its rows of the global batch
  over the data axes, runs the forward on its ``model`` blocks (tensor
  parallelism) and, with ``RunConfig.zero1``, keeps its blocks of the
  state; checkpoints hold whole leaves (``ckpt.save`` gathers them, rank 0
  writes) and a resume re-shards onto the mesh it runs on
  (``ckpt.restore``'s ``shardings``). Without a mesh nothing changes.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import torch

from ..ckpt.checkpoint import latest_step, restore, save
from ..device import resolve_device
from ..models.config import ArchConfig, RunConfig
from ..models.layers import tree_map
from ..models.model import model_init
from .data import synthetic_batch
from .optim import DataParallel, cosine_lr, init_state
from .step import build_train_step


@dataclass
class LoopConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    log_every: int = 10
    seed: int = 0
    accum: int = 1
    straggler_factor: float = 3.0
    warmup: int | None = None  # default: 5% of steps


@dataclass
class LoopResult:
    losses: list = field(default_factory=list)
    final_step: int = 0
    resumed_from: int | None = None
    straggler_steps: list = field(default_factory=list)
    wall_s: float = 0.0
    # the port's additions, for measurement: each step's wall time (ms,
    # ending when its loss reaches the host) and its gradient norm
    step_ms: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)


def train(cfg: ArchConfig, run: RunConfig, loop: LoopConfig, *,
          device="cuda") -> LoopResult:
    """Train ``loop.steps`` steps on ``synthetic_batch`` on ``device``
    (default the card; a missing card raises), over the data ranks of the
    ``shardctx`` mesh when one is set (module docstring)."""
    from ..shardctx import _CTX

    dev = resolve_device(device)
    res = LoopResult()
    f32_run = dataclasses.replace(run, activations_dtype="float32")
    params, specs = model_init(loop.seed, cfg, f32_run, device=dev)
    data = None
    ckpt_kw = {}
    if _CTX["mesh"] is not None:
        data = DataParallel.for_training(_CTX["mesh"], cfg, run, specs,
                                         params)
        params = data.shard(params)
        ckpt_kw = dict(shardings=data.state_specs, mesh=data.mesh)
    state = init_state(params)
    del params

    start = 0
    if loop.ckpt_dir:
        last = latest_step(loop.ckpt_dir)
        if last is not None:
            like = state
            if data is not None:  # the whole leaves' shapes
                like = type(state)(state.step, *(
                    tree_map(lambda s: torch.empty(s, device="meta"),
                             data.shapes) for _ in range(3)))
            state = restore(loop.ckpt_dir, last, like, **ckpt_kw)
            state = type(state)(*(tree_map(lambda t: t.to(dev), part)
                                  for part in state))
            start = int(state.step)
            res.resumed_from = last

    warmup = loop.warmup if loop.warmup is not None else max(2, loop.steps // 20)
    lr_fn = cosine_lr(run, warmup=warmup, total=loop.steps)
    step_fn = build_train_step(cfg, run, accum=loop.accum, lr_fn=lr_fn,
                               data=data)

    ewma = None
    t_loop = time.monotonic()
    pending_join = lambda: None
    for step in range(start, loop.steps):
        batch = synthetic_batch(cfg, loop.batch, loop.seq, loop.seed, step,
                                device=dev)
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if step > start + 2 and dt > loop.straggler_factor * ewma:
            res.straggler_steps.append((step, dt, ewma))
        res.losses.append(loss)
        res.step_ms.append(dt * 1e3)
        res.grad_norms.append(float(metrics["grad_norm"]))
        if loop.log_every and step % loop.log_every == 0:
            print(
                f"step {step:5d} loss {loss:.4f} "
                f"gnorm {res.grad_norms[-1]:.3f} {dt*1e3:.0f} ms"
            )
        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            pending_join()  # never more than one async save in flight
            pending_join = save(loop.ckpt_dir, step + 1, state, async_=True,
                                **ckpt_kw)
    pending_join()
    if loop.ckpt_dir:
        save(loop.ckpt_dir, loop.steps, state, **ckpt_kw)
    res.final_step = loop.steps
    res.wall_s = time.monotonic() - t_loop
    return res
