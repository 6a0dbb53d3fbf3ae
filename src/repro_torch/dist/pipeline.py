"""GPipe-style microbatched pipeline parallelism over a mesh axis. Twin of
``repro.dist.pipeline``.

``pipeline_apply`` schedules M microbatches across the S stages of a
``pipe`` mesh axis: at step t stage s runs microbatch ``t - s`` over its
own stacked layers, one layer at a time; stage outputs hand off to the next
stage with one shift round (pairs ``(i, i + 1)``) of ``dist.multicast``'s
executor per step, ``M + S - 1`` steps in all, and the last stage's
results are summed over the axis (the reference's ``psum``), which
replicates them.

The reference's bubble steps run the stage on zeros whose results reach
no output; here a stage runs only its M real microbatches and hands off
zeros in the bubbles, so the values are the same and the layers launch
``M`` times a stage. The whole schedule is one autograd Function whose
backward runs the steps in reverse, the shift rounds transposed, so that
every rank posts the same rounds in the same order both ways. Gradients
follow the reference's shard_map transpose: a stage leaf's gradient holds
this rank's stage (its other stages' slices are zero here and live on
their own ranks), and the gradient of the replicated input ``x`` is the
sum over the stages.
"""
from __future__ import annotations

import torch

from ..models.layers import tree_leaves, tree_map
from .comm import AllReduceSum, Axis, all_reduce_sum
from .multicast import _adopt_rounds, _adopt_rounds_transpose


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class _Pipeline(torch.autograd.Function):
    """The schedule: (x, *stage leaves) -> this rank's outputs (zeros off
    the last stage)."""

    @staticmethod
    def forward(ctx, layer_fn, like, ax: Axis, grad: bool, x, *leaves):
        S, M = ax.n, x.shape[0]
        stage, first, last = ax.me, ax.me == 0, ax.me == ax.n - 1
        shift = [[(i, i + 1) for i in range(S - 1)]]
        n_layers = leaves[0].shape[1]
        # this stage's layers, each leaf a view of its layer
        local = [[leaf[stage, i].detach().requires_grad_(grad)
                  for leaf in leaves] for i in range(n_layers)]
        layers = [_unflatten(like, lp) for lp in local]
        state = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        saved = []
        for t in range(M + S - 1):
            mb = t - stage
            if first and t < M:
                state = x[t]
            if 0 <= mb < M:
                h_in = state.detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    h = h_in
                    for lp in layers:
                        h = layer_fn(lp, h)
                saved.append((t, h_in, h))
                y = h.detach()
            else:
                y = torch.zeros_like(state)
            if last and mb >= 0 and mb < M:
                outs[mb] = y
            state = _adopt_rounds(y, shift, ax)
        ctx.ax, ctx.saved, ctx.local = ax, saved, local
        ctx.shapes = [leaf.shape for leaf in leaves]
        return outs

    @staticmethod
    def backward(ctx, ct_outs):
        ax, saved, local = ctx.ax, ctx.saved, ctx.local
        S, M = ax.n, ct_outs.shape[0]
        stage, first, last = ax.me, ax.me == 0, ax.me == ax.n - 1
        shift = [[(i, i + 1) for i in range(S - 1)]]
        steps = {t: (h_in, h) for t, h_in, h in saved}
        flat = [p for lp in local for p in lp]
        grads = [torch.zeros_like(p) for p in flat]
        ct_x = torch.zeros_like(ct_outs)
        ct_state = None  # the cotangent of the state handed off at step t
        for t in reversed(range(M + S - 1)):
            mb = t - stage
            # the shift after step t; its result after the last step is
            # unused on every rank, so no rank posts its transpose
            if ct_state is None:
                ct_y = torch.zeros_like(ct_outs[0])
            else:
                ct_y = _adopt_rounds_transpose(ct_state, shift, ax)
            if last and 0 <= mb < M:
                ct_y = ct_y + ct_outs[mb]
            if t in steps:
                h_in, h = steps.pop(t)
                got = torch.autograd.grad(h, [h_in, *flat], ct_y,
                                          allow_unused=True)
                ct_state = got[0]
                for g, d in zip(grads, got[1:]):
                    if d is not None:
                        g += d
            else:
                ct_state = torch.zeros_like(ct_y)
            if first and t < M:
                ct_x[t] = ct_state
                ct_state = torch.zeros_like(ct_state)
        n_layers = len(local)
        n_leaves = len(grads) // n_layers
        out = []
        for j, shape in enumerate(ctx.shapes):
            full = grads[j].new_zeros(shape)
            for i in range(n_layers):
                full[stage, i] = grads[i * n_leaves + j]
            out.append(full)
        # a replicated input collects its stages' cotangents
        ct_x = all_reduce_sum(ax, ct_x)
        return (None, None, None, None, ct_x, *out)


def pipeline_apply(layer_fn, stage_params, x: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run ``layer_fn`` layers, partitioned into pipeline stages.

    layer_fn: (layer_params, h) -> h, one layer.
    stage_params: tree (nested dicts, or one tensor) of leaves with leading
        dims (S, L_per_stage, ...): stage-major stacked layer weights; this
        rank runs ``leaf[coordinate along axis]`` and reads no other stage,
        so a rank that holds only its own stage may pass
        ``own[None].expand(S, *own.shape)``.
    x: (M, microbatch...) M microbatches, the same on every rank.
    Returns (M, microbatch...) on every rank: every microbatch through all
    S*L layers. Differentiable."""
    ax = Axis(mesh, axis)
    leaves = tree_leaves(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != ax.n:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != "
                f"{ax.n} pipeline stages on axis {axis!r}"
            )
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(leaf.requires_grad for leaf in leaves))
    like = tree_map(lambda _: None, stage_params)
    outs = _Pipeline.apply(layer_fn, like, ax, grad, x, *leaves)
    # only the last stage wrote non-zeros; the sum replicates the result
    return AllReduceSum.apply(outs, ax)
