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
