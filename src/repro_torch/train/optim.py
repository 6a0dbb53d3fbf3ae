"""AdamW + cosine schedule + global-norm clipping. Twin of
``repro.train.optim``.

``TrainState`` holds f32 master parameters and moments; the forward runs on
a cast (``train.step.cast_params``). The update keeps the reference's
formula and order of operations: weight decay inside the step, on every
leaf; bias corrections from the step as f32; the learning rate from the
step before the update. ``torch.optim.AdamW`` orders the operations
otherwise and is not used. ``adamw_update`` writes the new parameters and
moments into the state's tensors in place (the reference donates the state
to its jitted step for the same reason: at 1.6 B parameters the master
weights and moments are 19.7 GB) and returns a new ``TrainState`` around
them.

The reference's ``RunConfig.zero1`` shards the master weights and moments
over the data axes of a device mesh; on one card there is nothing to shard
over, so the port keeps them whole and ignores it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.config import RunConfig
from ..models.layers import tree_flatten, tree_leaves, tree_map


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    params: Any  # f32 master
    m: Any
    v: Any


def init_state(params) -> TrainState:
    """f32 master parameters (an f32 leaf is taken as it is, not copied)
    and zero moments, step 0."""
    dev = tree_leaves(params)[0].device
    return TrainState(
        torch.zeros((), dtype=torch.int32, device=dev),
        tree_map(lambda x: x.float(), params),
        tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
        tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
    )


def cosine_lr(run: RunConfig, warmup: int = 100, total: int = 10_000):
    """Linear warm-up to ``run.learning_rate``, then a cosine decay to a
    tenth of it at ``total``; computed in f32 from the int32 step, as the
    reference's jnp does."""
    base = run.learning_rate

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.int32)
        warm = base * (step + 1) / warmup
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = 0.5 * base * (1 + torch.cos(math.pi * t))
        floor = torch.tensor(0.1 * base, dtype=torch.float32,
                             device=step.device)
        return torch.where(step < warmup, warm, torch.maximum(cos, floor))

    return lr


@torch.no_grad()
def adamw_update(state: TrainState, grads, run: RunConfig,
                 lr_fn=None) -> TrainState:
    """One AdamW step, in place (module docstring)."""
    lr = (lr_fn or cosine_lr(run))(state.step)
    b1, b2, eps, wd = run.beta1, run.beta2, run.eps, run.weight_decay
    step = state.step + 1
    stepf = step.float()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=stepf.device)
    bc1 = 1 - f32(b1) ** stepf
    bc2 = 1 - f32(b2) ** stepf
    for p, g, m, v in zip(*(tree_leaves(t) for t in
                            (state.params, grads, state.m, state.v))):
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))  # b1 m + (1 - b1) g
        v.mul_(b2).add_(g * (1 - b2) * g)  # b2 v + (1 - b2) g g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u.add_(wd * p)
        p.sub_(lr * u)  # p - lr (mhat / (sqrt(vhat) + eps) + wd p)
    return TrainState(step, state.params, state.m, state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, the leaves in the
    reference's order (sorted keys)."""
    total = 0
    for _, x in tree_flatten(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
