"""The train step: loss -> grads -> clip -> AdamW, with microbatch
gradient accumulation and a cast compute copy over f32 master parameters,
on one device or on the ranks of a mesh (``optim.DataParallel``: data
ranks, tensor parallelism over ``model``). Twin of
``repro.train.step``."""
from __future__ import annotations

from typing import Callable

import torch

from ..models.config import ArchConfig, RunConfig
from ..models.layers import tree_map
from ..models.model import loss_fn, value_and_grad
from .optim import (
    DataParallel, TrainState, adamw_update, clip_by_global_norm, cosine_lr,
)


def cast_params(params, dtype: torch.dtype):
    """Every leaf cast to ``dtype``; differentiable, so the gradients come
    back to the f32 masters in f32."""
    return tree_map(lambda x: x.to(dtype), params)


def build_train_step(
    cfg: ArchConfig,
    run: RunConfig,
    *,
    accum: int = 1,
    lr_fn: Callable | None = None,
    data: DataParallel | None = None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state's
    tensors are updated in place (``optim.adamw_update``).

    ``accum`` > 1 splits the batch into microbatches whose gradients sum in
    an f32 accumulator, then divides by ``accum``. Under ``data`` the state
    holds this rank's blocks and ``batch`` is the global batch, of which
    the step takes this rank's rows (``data.rows``): the forward and
    backward run on the cast masters gathered over the data axes (the
    rank's ``model`` blocks, with ``data.parallel`` in ``shardctx``), and
    the loss, metrics and gradients are averaged over the data ranks
    (``optim.DataParallel``)."""
    from ..shardctx import training_on

    compute_dtype = getattr(torch, run.params_dtype)
    lr_fn = lr_fn or cosine_lr(run)

    def loss_of(params, batch):
        return loss_fn(cast_params(params, compute_dtype), batch, cfg, run)

    def train_step(state: TrainState, batch: dict):
        if data is None:
            return finish(state, *grads_of(state, batch))
        n = next(iter(batch.values())).shape[0]
        with training_on(data.parallel(n)):
            return finish(state, *grads_of(state, data.rows(batch, accum)))

    def grads_of(state: TrainState, batch: dict):
        metrics = {}
        params = (state.params if data is None
                  else data.gather(state.params, compute_dtype))
        if accum == 1:
            (loss, metrics), grads = value_and_grad(loss_of, params, batch)
        else:
            mbs = {k: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
                   for k, x in batch.items()}
            grads = tree_map(lambda t: torch.zeros_like(t,
                                                        dtype=torch.float32),
                             params)
            loss = 0.0
            for i in range(accum):
                (l, _), g = value_and_grad(
                    loss_of, params, {k: x[i] for k, x in mbs.items()})
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        return loss, metrics, grads

    def finish(state: TrainState, loss, metrics, grads):
        norm = None
        if data is not None:
            grads = data.average(grads)
            loss = data.mean(loss)
            metrics = {k: data.mean(v) for k, v in metrics.items()}
            norm = data.global_norm(grads)
        lr = lr_fn(state.step)
        grads, gnorm = clip_by_global_norm(grads, norm=norm)
        new_state = adamw_update(state, grads, run, lr_fn)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return new_state, out

    return train_step
