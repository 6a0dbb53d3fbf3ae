"""Primitive layers on plain dicts of tensors. Twin of ``repro.models.layers``.

Parameters keep the reference's tree and layout: a dense weight is
``(in, out)`` and is applied as ``x @ w.to(x.dtype)``, norms hold
``scale`` (and ``bias`` for layernorm), tables are ``(vocab, d)``. As in
the reference, every ``*_init`` returns two parallel trees, ``(params,
specs)``: the tensors, and one logical-axis tuple per tensor (one logical
name per dim, the vocabulary below), which ``dist.sharding`` maps onto the
axes of a mesh. Each init writes a leaf's axes beside its draw, as a
``(tensor, axes)`` pair that ``split`` takes apart, so the two trees cannot
drift. ``stack_init`` stacks a group's layers on a leading "layers" dim.
``tree_map`` and ``tree_flatten`` walk the nested dicts (a spec tree's
tuples are leaves). Random draws come from an explicit
``torch.Generator``; on the ``meta`` device nothing is drawn.

Logical axis vocabulary:
    batch seq embed heads kv_heads head_dim mlp vocab experts expert_mlp
    layers state conv qk_rope kv_lora q_lora

Tensor parallelism (training on a mesh whose ``model`` axis has more than
one rank, ``shardctx.tensor_parallel``): each rank holds its ``model``
block of the leaves whose ``heads``/``kv_heads``/``mlp``/``vocab``/
``experts`` dim the rule splits (``dist.sharding``: the axis size divides
the dim). A product whose out-dim is split runs column-parallel on the
rank's block (its bias too); one whose in-dim is split runs row-parallel
and the ranks' partial products are summed (``row_parallel``), a
replicated bias added after the sum. ``embed_apply`` looks ids up in the
rank's vocabulary block and sums the ranks' rows. The split of a dim is
read from its whole size, which the callers take from the configuration.
Outside training on a mesh the view has one rank (``dist.comm.ONE_RANK``),
its operators are the identity, and the same code is the one-process
layer.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..shardctx import tensor_parallel

Params = dict[str, Any]
Specs = dict[str, Any]


def normal(gen: torch.Generator | None, shape: tuple, std: float,
           device: torch.device) -> torch.Tensor:
    """f32 N(0, std^2) draws from ``gen`` (uninitialised on ``meta``)."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device).mul_(std)


def split(pairs: dict) -> tuple[Params, Specs]:
    """``(params, specs)`` from a dict whose values are ``(tensor, axes)``
    pairs of a leaf or ``(params, specs)`` pairs of a sub-init."""
    params: Params = {}
    specs: Specs = {}
    for k, (p, sp) in pairs.items():
        params[k], specs[k] = p, sp
    return params, specs


def dense_init(gen, in_dim: int, out_dim: int, in_axis: str | None,
               out_axis: str | None, device: torch.device, *,
               bias: bool = False) -> tuple[Params, Specs]:
    leaves = {"w": (normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                           device), (in_axis, out_axis))}
    if bias:
        leaves["b"] = (torch.zeros((out_dim,), device=device), (out_axis,))
    return split(leaves)


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm_init(d: int, device: torch.device,
              kind: str = "rmsnorm") -> tuple[Params, Specs]:
    leaves = {"scale": (torch.ones((d,), device=device), ("embed",))}
    if kind == "layernorm":
        leaves["bias"] = (torch.zeros((d,), device=device), ("embed",))
    return split(leaves)


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6,
               stats_only_f32: bool = False) -> torch.Tensor:
    """RMSNorm / LayerNorm with f32 statistics; ``stats_only_f32`` applies
    the normalisation in the input dtype, as the reference does."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        if stats_only_f32:
            inv = torch.rsqrt(var + eps).to(x.dtype)
            return (x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype) \
                + p["bias"].to(x.dtype)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        if stats_only_f32:
            inv = torch.rsqrt(ms + eps).to(x.dtype)
            return x * inv * p["scale"].to(x.dtype)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def embed_init(gen, vocab: int, d: int,
               device: torch.device) -> tuple[Params, Specs]:
    return split({"table": (normal(gen, (vocab, d), 0.02, device),
                            ("vocab", "embed"))})


def tp_project(tp, p: Params, x: torch.Tensor, full: int) -> torch.Tensor:
    """The whole output (width ``full``) of ``dense_apply(p, x)`` on every
    model rank, inside a region that ``tp.leave``/``tp.leave_replicated``
    closes: the ranks' column blocks gathered where the rule splits
    ``full``, else the product with the replicated leaves entering the
    region. ``x`` has entered it (``tp.enter``)."""
    if tp.split(full):
        return tp.gather(dense_apply(p, x), full)
    return dense_apply(tree_map(tp.enter, p), x)


def row_parallel(tp, p: Params, h: torch.Tensor) -> torch.Tensor:
    """``dense_apply(p, h)`` of a product whose in-dim ``tp`` splits (the
    rank's rows of ``w`` take its columns of ``h``): the ranks' partial
    products summed (``tp.leave``), then the replicated bias."""
    y = tp.leave(h @ p["w"].to(h.dtype))
    if "b" in p:
        y = y + p["b"].to(h.dtype)
    return y


def embed_apply(p: Params, ids: torch.Tensor, dtype,
                vocab: int) -> torch.Tensor:
    """The table's rows of ``ids`` in ``dtype``. Where tensor parallelism
    splits the (padded) ``vocab``, each rank looks up the ids in its
    block, zeros the others, and the ranks' rows are summed."""
    tp = tensor_parallel().over(vocab)
    lo, hi = tp.block(vocab)
    ids = ids.long()
    inside = (ids >= lo) & (ids < hi)
    rows = p["table"][(ids - lo).clamp(0, hi - lo - 1)].to(dtype)
    return tp.leave(torch.where(inside[..., None], rows,
                                torch.zeros((), dtype=dtype,
                                            device=rows.device)))


def lm_head_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Project to (padded) vocab logits using the (vocab, embed) table."""
    return x @ p["table"].to(x.dtype).T


def mlp_init(gen, cfg, device: torch.device,
             d_ff: int | None = None) -> tuple[Params, Specs]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return split({
            "wi": dense_init(gen, d, ff, "embed", "mlp", device),
            "wg": dense_init(gen, d, ff, "embed", "mlp", device),
            "wo": dense_init(gen, ff, d, "mlp", "embed", device),
        })
    return split({
        "wi": dense_init(gen, d, ff, "embed", "mlp", device, bias=True),
        "wo": dense_init(gen, ff, d, "mlp", "embed", device, bias=True),
    })


def mlp_apply(p: Params, x: torch.Tensor, kind: str,
              d_ff: int) -> torch.Tensor:
    """The dense MLP of hidden width ``d_ff``; where tensor parallelism
    splits it, column-parallel into the hidden layer and row-parallel out
    of it."""
    tp = tensor_parallel().over(d_ff)
    x = tp.enter(x)
    if kind == "swiglu":
        h = F.silu(dense_apply(p["wg"], x)) * dense_apply(p["wi"], x)
    else:  # jax.nn.gelu is the tanh approximation by default
        h = F.gelu(dense_apply(p["wi"], x), approximate="tanh")
    return row_parallel(tp, p["wo"], h)


def stack_init(init_fn, gen, n: int, cast=None) -> tuple[Params, Specs]:
    """``n`` layers of ``init_fn(gen) -> (params, specs)`` stacked on a
    leading "layers" dim, each spec gaining ``"layers"`` in front (the
    reference's ``stack_init``, which vmaps over split keys; one generator
    here, drawn layer after layer). The layers are drawn one at a time and
    copied into the stack, so the peak is the stack plus one layer's draws;
    ``cast`` maps each drawn layer's tree to the one stored (the stack takes
    the first layer's dtypes)."""
    cast = cast or (lambda t: t)
    layer, specs = init_fn(gen)
    layer = cast(layer)
    stack = tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
    _copy_into(stack, layer, 0)
    del layer
    for i in range(1, n):
        _copy_into(stack, init_fn(gen)[0], i)
    return stack, tree_map(lambda ax: ("layers", *ax), specs)


def _copy_into(stack: Params, layer: Params, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _copy_into(stack[k], v, i)
        elif v.device.type != "meta":
            stack[k][i].copy_(v)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of ``rest``, trees of
    the same keys), keeping the tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of nested dicts in the order of
    ``jax.tree_util`` (keys sorted), paths joined by ``/``."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_flatten(tree[k], f"{prefix}/{k}"
                                         if prefix else str(k))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def count_params(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
