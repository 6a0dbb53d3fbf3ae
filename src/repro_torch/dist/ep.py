"""Expert-parallel MoE on ``torch.distributed``, dispatched through DPM
schedules. Twin of ``repro.dist.ep``.

``moe_apply_ep`` is the explicit-collective twin of
``models.moe.moe_apply_dense``: experts shard over the ``model`` mesh axis,
tokens over ``(data..., model)``, and the dispatch/combine exchange runs as
the rounds of ``dist.multicast.alltoall_schedule`` through
``apply_alltoall_schedule`` — DPM partition merging plans every (src, dst)
token chunk's route on the rank ring, instead of a bare all-to-all.

Rank-local form: ``x`` is the whole batch on every rank (the reference's
global array); each rank takes its block of the flattened tokens, and the
blocks' outputs are gathered back so that every rank returns the whole
``y``. The expert leaves ``wi``, ``wg``, ``wo`` are either all experts
(each rank slices its ``n_experts / n_ep``) or already this rank's slice;
the router and shared experts are whole on every rank.

Numerics: routing, dispatch ranking, the buffer, the per-row expert SwiGLU
and the combine reuse the dense path's helpers, so with a no-drop capacity
factor the EP output equals the dense output modulo f32 reduction order.
The aux load-balance loss is the mean of the per-shard losses over the
mesh axes — an unbiased estimate of the dense aux, not bit-equal.
"""
from __future__ import annotations

import math

import torch

from ..models.config import ArchConfig, MoEConfig
from ..models.moe import (
    capacity,
    combine,
    dispatch_buffer,
    dispatch_indices,
    expert_ffn,
    moe_apply_dense,
    route,
    shared_ffn,
)
from .comm import AllReduceSum, Axis, GatherRows, ShardRows
from .multicast import alltoall_schedule, apply_alltoall_schedule

EP_AXIS = "model"
_EXPERT_LEAVES = ("wi", "wg", "wo")


def _local_experts(p, ax: Axis, e_loc: int) -> dict:
    """This rank's expert slices: the leaves as given when they hold
    ``e_loc`` experts, else the rank's block of all of them."""
    return {k: p[k] if p[k].shape[0] == e_loc
            else p[k][ax.me * e_loc:(ax.me + 1) * e_loc]
            for k in _EXPERT_LEAVES}


def moe_apply_ep(
    p,
    x: torch.Tensor,
    cfg: ArchConfig,
    mesh,
    data_axes: tuple[str, ...] | None = None,
    algo: str = "DPM",
):
    """Expert-parallel MoE FFN.  x: (B, S, d) -> (y, aux_loss).

    Tokens flatten to (T, d) and shard over ``(*data_axes, EP_AXIS)``;
    each rank routes its tokens locally, packs one (E_loc, cap, d) chunk
    per expert shard, and the chunks ride the DPM all-to-all schedule out
    and back. Runs the dense path where the reference does (a single EP
    rank, ragged experts or tokens), which needs every expert here.
    """
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    names = tuple(mesh.mesh_dim_names)
    if data_axes is None:
        data_axes = tuple(a for a in ("pod", "data") if a in names)
    sizes = dict(zip(names, mesh.shape))
    n_ep = sizes.get(EP_AXIS, 1)
    n_data = math.prod(sizes[a] for a in data_axes) if data_axes else 1
    T = B * S
    if n_ep <= 1 or m.n_experts % n_ep or T % (n_data * n_ep):
        if p["wi"].shape[0] != m.n_experts:
            raise ValueError(
                f"moe_apply_ep: the dense path (n_ep={n_ep}, "
                f"{m.n_experts} experts, {T} tokens over {n_data * n_ep} "
                f"shards) needs all {m.n_experts} experts, this rank holds "
                f"{p['wi'].shape[0]}")
        return moe_apply_dense(p, x, cfg)

    e_loc = m.n_experts // n_ep
    t_loc = T // (n_data * n_ep)
    cap = capacity(m, t_loc)
    sched = alltoall_schedule(n_ep, algo, device=x.device.type)
    ep = Axis(mesh, EP_AXIS)
    # token blocks are row-major over (*data_axes, EP_AXIS): split the
    # outermost axis first
    token_axes = [Axis(mesh, a) for a in (*data_axes, EP_AXIS)]
    xt = x.reshape(T, d)
    for ax in token_axes:
        xt = ShardRows.apply(xt, ax)
    p_l = _local_experts(p, ep, e_loc)

    ids, w, aux = route(p, xt, m)
    slot, keep = dispatch_indices(ids, m, cap)
    buf = dispatch_buffer(xt, slot, keep, m.top_k, m.n_experts * cap)
    # dispatch: chunk j goes to expert shard j over the DPM schedule
    chunks = buf.reshape(n_ep, e_loc * cap, d)
    recv = apply_alltoall_schedule(chunks, sched, mesh, EP_AXIS)
    xe = (
        recv.reshape(n_ep, e_loc, cap, d)
        .transpose(0, 1)
        .reshape(e_loc, n_ep * cap, d)
    )
    ye = expert_ffn(p_l, xe)
    # combine: same schedule back (all-to-all is its own inverse here)
    back = (
        ye.reshape(e_loc, n_ep, cap, d)
        .transpose(0, 1)
        .reshape(n_ep, e_loc * cap, d)
    )
    outb = apply_alltoall_schedule(back, sched, mesh, EP_AXIS)
    y = combine(outb.reshape(m.n_experts * cap, d), slot, keep, w, m.top_k)
    if m.n_shared:
        y = y + shared_ffn(p, xt)
    for ax in reversed(token_axes):
        y = GatherRows.apply(y, ax)
        aux = AllReduceSum.apply(aux, ax)
    aux = aux / math.prod(ax.n for ax in token_axes)
    return y.reshape(B, S, d), aux
