"""Collectives along one axis of a ``DeviceMesh``, for ``dist``'s executors
and model-side consumers (the reference's ``jax.lax`` collectives inside
``shard_map``).

A mesh axis is the process group ``mesh.get_group(axis)``; rank ``i`` of a
schedule or a chunk list is coordinate ``i`` along that axis (the
reference's ``axis_index``), and the group's ranks must come in that order.
Payloads move as raw bytes (``view(torch.uint8)``), so bf16 and int8 cross
bit for bit whatever the backend's dtype support. Where the group's backend
is gloo and a payload lies on a card, it is staged through host memory:
gloo moves only host tensors for these operations. The rule is read from
the group (``staged``), never found by trying.

Training and serving on a mesh add ``TensorParallel``: this rank's view
of the ``model`` axis and of the data axes that split the batch's rows,
with the autograd Functions of tensor parallelism (``EnterModel``,
``LeaveModel``, ``GatherModel``, ``LeaveReplicated``) and
``SumOverRanks``, and for serving the caches' blocks over ``model``
(``cat``, ``seq_block``, ``seq_span``) and the log-sum-exp merge of
partial attention (``merge_softmax``). They stage through the host as the
rest do: they use ``all_reduce`` and ``all_gather``, not DTensor. Under
the ``fake`` backend of the dry run (``launch.dryrun``) nothing is staged:
that group is not gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` on a ``DeviceMesh`` or a ``sharding.abstract_mesh``
    (a ``KeyError`` names a missing axis)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]


class Axis:
    """One mesh axis as seen from this rank: its group, the global ranks of
    its coordinates in order (``ranks[i]`` holds coordinate ``i``), this
    rank's coordinate ``me`` and whether payloads on a card are staged
    through the host."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.me = mesh.get_local_rank(axis)
        n = axis_size(mesh, axis)
        self.ranks = [dist.get_global_rank(self.group, i) for i in range(n)]
        if self.ranks[self.me] != dist.get_rank():
            raise ValueError(
                f"axis {axis!r}: group rank {self.me} is global rank "
                f"{self.ranks[self.me]}, not this rank {dist.get_rank()}; "
                "the group's rank order must be the axis's coordinate order")
        self.n = n
        self.gloo = dist.get_backend(self.group) == "gloo"

    def staged(self, t: torch.Tensor) -> bool:
        return self.gloo and t.is_cuda


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def exchange(ax: Axis, sends: list, recvs: list) -> None:
    """One round of point-to-point transfers as one ``batch_isend_irecv``:
    ``sends`` are ``(coordinate, tensor)``, ``recvs`` are ``(coordinate,
    contiguous out tensor)``, filled in place. A rank with neither posts
    nothing."""
    if not sends and not recvs:
        return
    ops, fills = [], []
    for peer, t in sends:
        b = _bytes(t.contiguous())
        if ax.staged(t):
            b = b.cpu()
        ops.append(dist.P2POp(dist.isend, b, ax.ranks[peer], group=ax.group))
    for peer, out in recvs:
        if not out.is_contiguous():
            raise ValueError("exchange: a receive buffer must be contiguous")
        b = _bytes(out)
        if ax.staged(out):
            host = torch.empty(b.shape, dtype=torch.uint8)
            fills.append((b, host))
            b = host
        ops.append(dist.P2POp(dist.irecv, b, ax.ranks[peer], group=ax.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for dev, host in fills:
        dev.copy_(host)


def all_to_all(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    """``t[j]`` goes to coordinate ``j``; row ``i`` of the result is what
    coordinate ``i`` sent here (``lax.all_to_all`` over dim 0)."""
    if t.shape[0] != ax.n:
        raise ValueError(f"all_to_all: leading dim {t.shape[0]} != {ax.n}")
    src = t.contiguous()
    out = torch.empty_like(src)
    sb, ob = _bytes(src), _bytes(out)
    if ax.staged(t):
        sb, host = sb.cpu(), torch.empty(ob.shape, dtype=torch.uint8)
        dist.all_to_all_single(host, sb, group=ax.group)
        ob.copy_(host)
    else:
        dist.all_to_all_single(ob, sb, group=ax.group)
    return out


def all_gather(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    """The coordinates' ``t`` stacked on a new leading dim, in order."""
    src = t.contiguous()
    b = _bytes(src)
    if ax.staged(t):
        b = b.cpu()
    parts = [torch.empty_like(b) for _ in range(ax.n)]
    dist.all_gather(parts, b, group=ax.group)
    out = torch.empty((ax.n, *src.shape), dtype=src.dtype, device=src.device)
    _bytes(out).copy_(torch.cat(parts))
    return out


def all_reduce_sum(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    """The sum over the axis (``lax.psum``) in ``t``'s dtype, as a new
    tensor."""
    out = t.detach().clone().contiguous()
    if ax.staged(out):
        host = out.cpu()
        dist.all_reduce(host, group=ax.group)
        out.copy_(host)
    else:
        dist.all_reduce(out, group=ax.group)
    return out


def all_reduce_max(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the axis (``lax.pmax``), as a new
    tensor."""
    out = t.detach().clone().contiguous()
    if ax.staged(out):
        host = out.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX, group=ax.group)
        out.copy_(host)
    else:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out


def merge_softmax(ax: Axis, acc: torch.Tensor, mx: torch.Tensor,
                  total: torch.Tensor) -> torch.Tensor:
    """Softmax-weighted sums over keys split across the axis, from each
    rank's part: ``mx`` its row maxima of the scores (``-1e30`` where it
    holds no visible key), ``total`` its sums of ``exp(s - mx)`` and
    ``acc`` (``total``'s shape plus one dim) its sums of ``exp(s - mx) v``.
    The log-sum-exp merge: the maximum over the ranks, then one sum of the
    parts rescaled to it; f32 in, f32 out."""
    top = all_reduce_max(ax, mx)
    w = torch.exp(mx - top)
    both = all_reduce_sum(ax, torch.cat([acc * w[..., None],
                                         (total * w)[..., None]], -1))
    return both[..., :-1] / both[..., -1:]


def gather_shards(mesh, t: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor whose block under ``spec`` (a spec tuple,
    ``sharding.shard_slices``) this rank holds as ``t``: each sharded dim's
    blocks gathered over its axes, the minor axis first. Every rank of the
    axes involved calls it; an unsharded ``t`` comes back as it is."""
    from .sharding import _flat_axes

    for d, entry in enumerate(spec):
        for a in reversed(_flat_axes(entry)):
            parts = all_gather(Axis(mesh, a), t)
            t = torch.cat(parts.unbind(0), dim=d)
    return t


def gather_to(mesh, t: torch.Tensor, spec: tuple, dst: int):
    """The whole tensor whose block under ``spec`` this rank holds as
    ``t``, assembled on the host of global rank ``dst`` (returned there,
    ``None`` on the other ranks). Each distinct block crosses once, as one
    point-to-point message from the rank that holds it at coordinate 0 of
    the axes ``spec`` does not split over (staged through the host where
    the group is gloo). Every rank of ``mesh`` calls it."""
    import itertools
    import math

    from .sharding import _flat_axes, shard_slices

    names = mesh.mesh_dim_names
    grid = mesh.mesh  # the global ranks, in the mesh's shape
    sizes = dict(zip(names, grid.shape))
    used = {a for e in spec for a in _flat_axes(e)}
    full = tuple(n * math.prod(sizes[a] for a in _flat_axes(
        spec[d] if d < len(spec) else None)) for d, n in enumerate(t.shape))
    owners = []
    for idx in itertools.product(*(range(n) for n in grid.shape)):
        coords = dict(zip(names, idx))
        if all(coords[a] == 0 for a in names if a not in used):
            owners.append((int(grid[idx]), coords))
    me = dist.get_rank()
    staged = dist.get_backend() == "gloo" and t.is_cuda
    if me != dst:
        if any(r == me for r, _ in owners):
            b = _bytes(t.contiguous())
            dist.send(b.cpu() if staged else b, dst=dst)
        return None
    out = torch.empty(full, dtype=t.dtype)
    for r, coords in owners:
        if r == me:
            block = t
        else:
            block = torch.empty(t.shape, dtype=t.dtype,
                                device="cpu" if staged else t.device)
            dist.recv(_bytes(block), src=r)
        out[shard_slices(spec, full, mesh, coords)] = block.cpu()
    return out


def all_reduce_axes(mesh, axes: tuple[str, ...], t: torch.Tensor
                    ) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes`` (one axis after the
    other), as a new tensor."""
    out = t
    for a in axes:
        out = all_reduce_sum(Axis(mesh, a), out)
    return out if axes else t.detach().clone()


class AllReduceSum(torch.autograd.Function):
    """``psum`` of a rank-local tensor whose sum every rank then holds.
    Backward: the reference's shard_map divides a replicated output's
    cotangent by the axis size, and ``psum`` transposes to ``psum``, so the
    cotangent is the axis mean of the ranks' cotangents (the cotangent
    itself where every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        return all_reduce_sum(ax, t)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ctx.ax, ct) / ctx.ax.n, None


class ShardRows(torch.autograd.Function):
    """Coordinate ``me``'s block of rows of a tensor replicated over the
    axis. Backward gathers the blocks' cotangents, as a replicated input of
    shard_map collects its shards' cotangents."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        rows = t.shape[0] // ax.n
        return t[ax.me * rows:(ax.me + 1) * rows]

    @staticmethod
    def backward(ctx, ct):
        g = all_gather(ctx.ax, ct)
        return g.reshape(-1, *ct.shape[1:]), None


class GatherRows(torch.autograd.Function):
    """The axis's row blocks concatenated in coordinate order, replicated
    on every rank. Backward keeps this coordinate's block of the
    cotangent."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        return all_gather(ax, t).reshape(-1, *t.shape[1:])

    @staticmethod
    def backward(ctx, ct):
        rows = ct.shape[0] // ctx.ax.n
        return ct[ctx.ax.me * rows:(ctx.ax.me + 1) * rows], None


# ---------------------------------------------------------------------------
# tensor parallelism over ``model`` and sums over the data ranks, for training
# ---------------------------------------------------------------------------
def _sum_f32(ax: Axis, t: torch.Tensor) -> torch.Tensor:
    """The sum over the axis of ``t`` taken in f32, back in ``t``'s dtype:
    one rounding of the whole sum, whatever the ranks' dtype."""
    return all_reduce_sum(ax, t.float()).to(t.dtype)


class EnterModel(torch.autograd.Function):
    """The input of a column-parallel product (Megatron's ``f``): the same
    tensor on every model rank; backward sums the ranks' cotangents, each
    of which reaches only the rank's own columns."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return _sum_f32(ctx.ax, ct), None


class LeaveModel(torch.autograd.Function):
    """The output of a row-parallel product (Megatron's ``g``): the sum of
    the ranks' partial products, summed in f32 and rounded once to the
    partials' dtype; backward passes the cotangent, which every rank holds
    whole, to each partial."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        return _sum_f32(ax, t)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class GatherModel(torch.autograd.Function):
    """The model ranks' column blocks of a tensor, concatenated along
    ``dim`` in coordinate order. Every rank then uses the whole tensor for
    its own part of a sum that a ``LeaveModel`` closes, so backward sums
    the ranks' cotangents and keeps this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, ax: Axis, dim: int):
        ctx.ax, ctx.dim, ctx.width = ax, dim, t.shape[dim]
        parts = all_gather(ax, t)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, ct):
        total = _sum_f32(ctx.ax, ct)
        return (total.narrow(ctx.dim, ctx.ax.me * ctx.width,
                             ctx.width).contiguous(), None, None)


class LeaveReplicated(torch.autograd.Function):
    """The exit of a region whose output every model rank computes whole:
    identity forward; backward divides the cotangent by the number of
    ranks, so that the sums of ``EnterModel``/``GatherModel`` count the
    ranks' equal cotangents once."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.ax.n, None


class SumOverRanks(torch.autograd.Function):
    """``psum`` over an axis whose ranks hold different rows of the batch
    and whose gradients ``train.optim.DataParallel`` averages: backward is
    psum's transpose, the sum of the ranks' cotangents, so that the mean
    of the ranks' gradients is the gradient of the global function."""

    @staticmethod
    def forward(ctx, t, ax: Axis):
        ctx.ax = ax
        return all_reduce_sum(ax, t)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ctx.ax, ct), None


class TensorParallel:
    """This rank's view of a training mesh, for the models' forward (read
    through ``shardctx.tensor_parallel``): the ``model`` axis over which
    the parameters' ``heads``/``kv_heads``/``mlp``/``vocab``/``experts``
    dims are split (tensor parallelism, ``m`` ranks, this one at ``me``),
    and the data axes ``row_axes`` over which the batch's rows are split
    (``n_rows`` ranks, this one at ``row_index``; a MoE layer's capacity,
    ranks and load-balance loss are the global batch's).

    A dim of whole size ``full`` is split iff ``split(full)``: the rule of
    ``dist.sharding`` (the size divides it). Every rank runs the same
    graph and holds the same loss; ``enter``, ``leave``, ``gather`` and
    ``leave_replicated`` keep each rank's gradients those of its blocks of
    that one loss. With no mesh (one process, serving) there is one model
    rank and one row rank, and every operator is the identity: the layers
    run one code path, which is the one-process function there."""

    def __init__(self, mesh=None, row_axes: tuple[str, ...] = ()):
        import math

        sizes = (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else {})
        self.model = Axis(mesh, "model") if sizes.get("model", 1) > 1 else None
        self.m = self.model.n if self.model else 1
        self.me = self.model.me if self.model else 0
        self.rows = tuple(Axis(mesh, a) for a in row_axes)
        self.n_rows = math.prod(ax.n for ax in self.rows)
        idx = 0
        for ax in self.rows:  # the major axis first
            idx = idx * ax.n + ax.me
        self.row_index = idx

    # ------------------------------------------------------------ model
    def split(self, full: int) -> bool:
        return self.m > 1 and full % self.m == 0

    def over(self, *fulls: int) -> "TensorParallel":
        """This view where the rule splits one of the dims ``fulls`` (a
        layer's leaves), else ``ONE_RANK``: a layer none of whose leaves
        is split runs whole on every rank, as one process runs it."""
        return self if any(self.split(f) for f in fulls) else ONE_RANK

    def block(self, full: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of whole size ``full`` (the
        whole dim where it is not split)."""
        if not self.split(full):
            return 0, full
        w = full // self.m
        return self.me * w, (self.me + 1) * w

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.model is None else EnterModel.apply(t, self.model)

    def leave(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.model is None else LeaveModel.apply(t, self.model)

    def leave_replicated(self, t: torch.Tensor) -> torch.Tensor:
        return (t if self.model is None
                else LeaveReplicated.apply(t, self.model))

    def close(self, t: torch.Tensor, full: int) -> torch.Tensor:
        """The exit of a region's part whose dim ``full`` the rank holds
        its block of: ``leave`` where ``split(full)``, else
        ``leave_replicated`` (every rank computed the part whole)."""
        return self.leave(t) if self.split(full) else self.leave_replicated(t)

    def gather(self, t: torch.Tensor, full: int, dim: int = -1
               ) -> torch.Tensor:
        """The whole of a tensor whose dim ``dim`` (whole size ``full``)
        this rank holds its block of where ``split(full)``, for use inside
        a region that a ``leave`` or ``leave_replicated`` closes; an
        unsplit tensor (a replicated leaf, a product with one) enters the
        region through ``enter``."""
        if not self.split(full):
            return self.enter(t)
        return GatherModel.apply(t, self.model, dim % t.dim())

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the model ranks (no gradient)."""
        t = t.detach()
        return t if self.model is None else all_reduce_max(self.model, t)

    # ----------------------------------------------------- serving caches
    def cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' blocks of ``t`` concatenated along ``dim`` in
        coordinate order (no gradient; serving)."""
        if self.model is None:
            return t
        return torch.cat(all_gather(self.model, t).unbind(0), dim=dim)

    def seq_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a cache's sequence (dim 1), which
        ``dist.sharding.CACHE_RULES`` splits over ``model``. The port keeps
        every cache's sequence split on a ``model`` axis, so that a rank
        reads its block's place from its length (``seq_span``): a length
        the axis does not divide raises."""
        if self.model is None:
            return t
        S = t.shape[1]
        if S % self.m:
            raise ValueError(
                f"a cache of {S} positions does not split over the "
                f"{self.m} ranks of 'model' (CACHE_RULES' seq); serving on "
                "a mesh needs cache lengths that the model axis divides")
        w = S // self.m
        return t[:, self.me * w:(self.me + 1) * w]

    def seq_span(self, local: int) -> tuple[int, int]:
        """``(first position, whole length)`` of this rank's cache block of
        ``local`` positions (``seq_block``'s layout)."""
        if self.model is None:
            return 0, local
        return self.me * local, self.m * local

    def merge_softmax(self, acc, mx, total) -> torch.Tensor:
        """``dist.comm.merge_softmax`` over the model ranks (each holding a
        block of the keys)."""
        if self.model is None:
            return acc / total[..., None]
        return merge_softmax(self.model, acc, mx, total)

    # ------------------------------------------------------------- rows
    def rows_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of the batch's rows, differentiable
        (``SumOverRanks``)."""
        for ax in self.rows:
            t = SumOverRanks.apply(t, ax)
        return t

    def rows_before(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the row ranks before this one (zeros on
        the first; no gradient)."""
        shape = t.shape
        t = t.detach()
        for ax in reversed(self.rows):  # the minor axis first
            t = all_gather(ax, t)
        return t.reshape(self.n_rows, *shape)[:self.row_index].sum(0)


ONE_RANK = TensorParallel()
