"""AdamW + cosine schedule + global-norm clipping + ZeRO-1 state
sharding. Twin of ``repro.train.optim``.

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

``DataParallel`` trains on a mesh of ``pod``, ``data`` and ``model``
axes: the reference's jitted step under the shardings of
``launch.specs.train_cell``. Each rank holds its ``model`` block of every
leaf that the rule splits over ``model`` (tensor parallelism, the models'
forward reading ``shardctx.tensor_parallel``) and takes its rows of the
global batch over the data axes. With ``RunConfig.zero1`` it keeps only
its block of every master, ``m`` and ``v`` leaf, as
``dist.sharding.zero1_shardings`` gives it (a leaf with no dim that the
data ranks divide stays whole over them); without it the state is split
over ``model`` alone. The forward runs on the master gathered over the
data axes only, cast: the rank's model blocks, never a whole leaf split
over ``model``. The gradients are summed over the data ranks
(``all_reduce``; gloo runs ``reduce_scatter_tensor`` too, on host and
card tensors under torch 2.11, but the swap waits for a measurement),
divided by their number, and each rank keeps its block; the clipping
norm sums the squares of every rank's blocks, a block held by several
ranks counted once over the data and model axes; ``adamw_update`` then
runs unchanged on the blocks. A
MoE model's layers compute the global batch's routing from each rank's
rows (``models.moe``). Axes other than ``pod``, ``data`` and ``model``
raise ``NotImplementedError``, as does ``moe_impl="ep"``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.config import ArchConfig, RunConfig
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


def clip_by_global_norm(grads, max_norm: float = 1.0,
                        norm: torch.Tensor | None = None):
    """``(grads * min(1, max_norm / max(norm, 1e-9)), norm)``; ``norm``
    defaults to ``global_norm(grads)`` (``DataParallel.global_norm`` for a
    rank's blocks)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


class DataParallel:
    """Training on the ranks of ``mesh`` (module docstring): ``specs`` is
    the state's per-leaf spec tree, ``shapes`` the whole leaves' shapes."""

    def __init__(self, mesh, specs, shapes):
        from ..dist.sharding import _axis_sizes, mesh_coords

        sizes = _axis_sizes(mesh)
        self.mesh = mesh
        self.axes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
        self.n = math.prod(sizes[a] for a in self.axes)
        self.split_axes = self.axes + (
            ("model",) if sizes.get("model", 1) > 1 else ())
        self.coords = mesh_coords(mesh)
        self.specs = specs
        self.shapes = tree_map(lambda t: tuple(t.shape), shapes)

    @classmethod
    def for_training(cls, mesh, cfg: ArchConfig, run: RunConfig, specs,
                     shapes) -> "DataParallel":
        """The layout ``train`` uses on ``mesh`` for parameters of logical
        axes ``specs`` and whole shapes ``shapes``: ``zero1_shardings``
        under ``run.zero1``, else ``tree_shardings``."""
        from ..dist.sharding import (_axis_sizes, tree_shardings,
                                     zero1_shardings)

        sizes = _axis_sizes(mesh)
        other = {a: n for a, n in sizes.items()
                 if a not in ("pod", "data", "model") and n > 1}
        if other:
            raise NotImplementedError(
                f"training over mesh axes {other}: only the data axes "
                "('pod', 'data') and the tensor-parallel axis 'model' are "
                "ported")
        if cfg.moe and run.moe_impl == "ep" and math.prod(sizes.values()) > 1:
            raise NotImplementedError(
                f"{cfg.name}: expert-parallel training (moe_impl='ep') is "
                "not ported; train with moe_impl='dense'")
        build = zero1_shardings if run.zero1 else tree_shardings
        return cls(mesh, build(specs, shapes, mesh), shapes)

    def shard(self, tree):
        """This rank's blocks of a tree of whole leaves."""
        return tree_map(self.shard_leaf, tree, self.specs)

    def shard_leaf(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a leaf under ``spec`` (a copy; a leaf it
        keeps whole comes back as it is)."""
        from ..dist.sharding import shard_slices

        sl = shard_slices(spec, t.shape, self.mesh, self.coords)
        if all(s.stop - s.start == n for s, n in zip(sl, t.shape)):
            return t
        return t[sl].clone()

    def data_spec(self, spec: tuple) -> tuple:
        """``spec`` with its ``model`` entries dropped: the split of a
        model block over the data axes (the rules never shard one dim over
        ``model`` and a data axis together)."""
        return tuple(None if e == "model" else e for e in spec)

    def gather(self, tree, dtype: torch.dtype):
        """This rank's model blocks of a tree of its state blocks, gathered
        over the data axes, each cast to ``dtype`` before it is gathered
        (the same bits as the cast of the gathered block, in fewer
        bytes)."""
        from ..dist.comm import gather_shards

        return tree_map(lambda t, spec: gather_shards(
            self.mesh, t.to(dtype), self.data_spec(spec)), tree, self.specs)

    def average(self, grads):
        """The gradients of this rank's model blocks, one a rank's rows, to
        this rank's blocks of their f32 mean over the data ranks, leaf by
        leaf."""
        from ..dist.comm import all_reduce_axes

        def one(g, spec):
            total = all_reduce_axes(self.mesh, self.axes, g.float())
            return self.shard_leaf(total.div_(self.n), self.data_spec(spec))

        return tree_map(one, grads, self.specs)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a rank's scalar over the data ranks (the model ranks
        hold the same)."""
        from ..dist.comm import all_reduce_axes

        return all_reduce_axes(self.mesh, self.axes, x.float()) / self.n

    def global_norm(self, grads) -> torch.Tensor:
        """``global_norm`` of the whole gradients from this rank's blocks:
        each rank's sum of squares over the blocks it owns (a block held by
        several ranks counts on the one at coordinate 0 of the data and
        model axes its leaf is not split over), summed over the ranks."""
        from ..dist.comm import all_reduce_axes
        from ..dist.sharding import _flat_axes

        total = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(grads)[0].device)
        for (_, g), (_, spec) in zip(tree_flatten(grads),
                                     tree_flatten(self.specs)):
            split = {a for e in spec for a in _flat_axes(e)}
            if all(self.coords[a] == 0 for a in self.split_axes
                   if a not in split):
                total = total + torch.sum(torch.square(g.float()))
        return torch.sqrt(all_reduce_axes(self.mesh, self.split_axes, total))

    def row_axes(self, n: int) -> tuple[str, ...]:
        """The data axes over which a global batch of ``n`` rows is split,
        as the reference shards its ``("batch", ...)`` inputs (an axis
        that does not divide ``n`` leaves the rows whole over it)."""
        from ..dist.sharding import _flat_axes, spec_for_shape

        return _flat_axes(spec_for_shape(("batch",), (n,), self.mesh)[0])

    def rows(self, batch: dict, accum: int = 1) -> dict:
        """This rank's rows of a global batch, as the reference shards its
        ``("batch", "seq", ...)`` inputs. With ``accum`` microbatches, its
        block of each microbatch of the global batch, in order (the rows
        ``build_train_step`` splits into microbatches on this rank)."""
        from ..dist.sharding import _axis_sizes, shard_slices, spec_for_shape

        sizes = _axis_sizes(self.mesh)
        out = {}
        for k, t in batch.items():
            axes = self.row_axes(t.shape[0])
            n = math.prod(sizes[a] for a in axes)
            if accum > 1 and n > 1:
                if t.shape[0] % (accum * n):
                    raise ValueError(
                        f"a batch of {t.shape[0]} rows does not split into "
                        f"{accum} microbatches over {n} data ranks")
                idx = 0
                for a in axes:
                    idx = idx * sizes[a] + self.coords[a]
                out[k] = t.reshape(accum, n, -1, *t.shape[1:])[:, idx] \
                    .reshape(-1, *t.shape[1:])
            else:
                spec = spec_for_shape(("batch", "seq", "embed")[:t.dim()],
                                      tuple(t.shape), self.mesh)
                out[k] = t[shard_slices(spec, t.shape, self.mesh,
                                        self.coords)]
        return out

    def parallel(self, n: int):
        """The ``dist.comm.TensorParallel`` of this mesh for a global batch
        of ``n`` rows, which the step's forward reads."""
        from ..dist.comm import TensorParallel

        return TensorParallel(self.mesh, self.row_axes(n))

    @property
    def state_specs(self) -> TrainState:
        """The spec tree of a ``TrainState`` in this layout (the step
        whole), for ``ckpt.save``/``restore``."""
        return TrainState((), self.specs, self.specs, self.specs)
