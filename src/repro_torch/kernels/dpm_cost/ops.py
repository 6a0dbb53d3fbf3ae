"""Batched DPM planning: the cost-table kernels plus Algorithm 1's greedy
merge, in PyTorch. Twin of ``repro.kernels.dpm_cost.ops``.

``dpm_plan(dest_mask, src_xy)`` returns, batched over packets, the final
partition selection of Algorithm 1 under the MU cost model: a (P, 24) bool
matrix of chosen candidates. ``dpm_plan_exact`` is the batched planner's
full Definition 2 objective (``core.batch_planner``).

The entry points take ``device=`` (default the card; a missing card raises)
and move their inputs there. The cost tables dispatch by the device of the
tensors: CUDA tensors launch the kernels of ``dpm_cost.py`` or raise, CPU
tensors run the plain versions of ``ref.py``. Nothing falls back.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.partition import candidate_ids_for, wedge_patterns
from ...device import resolve_device
from .dpm_cost import BIG, EMPTY_KEY, dpm_cost_table, dpm_cost_table_weighted
from .ref import dpm_cost_table_ref, dpm_cost_table_weighted_ref

# order sentinel: "never picked by the merge loop" (leftover singles sort
# after every real pick round; see _greedy_merge_ordered)
NO_ORDER = 2**30


@functools.lru_cache(maxsize=None)
def _cand_bits(np_: int) -> np.ndarray:
    """candidate -> bitmask over the ``np_`` basic partitions (np_ <= 30)."""
    return np.array(
        [sum(1 << i for i in ids) for ids in candidate_ids_for(np_)],
        dtype=np.int32,
    )


def _on(device, *xs) -> tuple:
    dev = resolve_device(device)
    return (dev, *(torch.as_tensor(x, device=dev) for x in xs))


def _cost_table(dest_mask, src_xy, **kw):
    """``dpm_cost_table`` by device: the kernel on CUDA, ``ref.py`` on the
    CPU."""
    if dest_mask.device.type == "cuda":
        return dpm_cost_table(dest_mask.to(torch.int32).contiguous(),
                              src_xy.to(torch.int32).contiguous(), **kw)
    if dest_mask.device.type == "cpu":
        return dpm_cost_table_ref(dest_mask, src_xy, **kw)
    raise ValueError(f"no dpm_cost engine for device {dest_mask.device}")


def _cost_table_weighted(dest_mask, src_xy, dist, weight, **kw):
    """``dpm_cost_table_weighted`` by device, as ``_cost_table``."""
    if dest_mask.device.type == "cuda":
        return dpm_cost_table_weighted(
            dest_mask.to(torch.int32).contiguous(),
            src_xy.to(torch.int32).contiguous(),
            dist.to(torch.float32).contiguous(),
            weight.to(torch.float32).contiguous(), **kw,
        )
    if dest_mask.device.type == "cpu":
        return dpm_cost_table_weighted_ref(dest_mask, src_xy, dist, weight,
                                           **kw)
    raise ValueError(f"no dpm_cost engine for device {dest_mask.device}")


def dpm_plan(
    dest_mask,  # (P, NN)
    src_xy,  # (P, 2)
    *,
    n: int,
    m: int | None = None,
    wrap: bool = False,
    include_source_leg: bool = True,
    device: torch.device | str = "cuda",
):
    """Algorithm 1 (greedy partition merging), batched. Returns
    (chosen (P,24) bool, costs (P,24) int32, reps (P,24) int32).
    ``wrap=True`` plans on torus geometry (toroidal distances/partitions).
    One ``dpm_cost_table`` launch on the card."""
    _, dest_mask, src_xy = _on(device, dest_mask, src_xy)
    costs, reps = _cost_table(
        dest_mask, src_xy, n=n, m=m, wrap=wrap,
        include_source_leg=include_source_leg,
    )
    # greedy merge (Definition 3 savings + tie-breaks) shared with the
    # weighted path — int32 costs keep the original integer arithmetic
    return _greedy_merge(costs, reps), costs, reps


def total_plan_cost(chosen, costs):
    return torch.where(chosen, costs, 0).sum(1, dtype=costs.dtype)


def _greedy_merge(costs, reps, np_: int = 8):
    """Algorithm 1's greedy merge over an already-computed candidate table.

    Shared by the hop-count, weighted, and generic-topology paths; ``costs``
    may be int32 (hop counting) or float32 (weighted objectives) — savings
    stay in the input dtype and the host tie-break is reproduced exactly in
    either. ``np_`` is the basic-partition count (8 wedges in 2-D, 26 in
    3-D); the candidate axis is ``3 * np_``.
    """
    return _greedy_merge_ordered(costs, reps, np_)[0]


def _greedy_merge_ordered(costs, reps, np_: int = 8):
    """Greedy merge that also reports *pick order*: ``(chosen, order)``.

    ``order[p, ci]`` is the merge round (0-based) at which candidate ``ci``
    won, or ``NO_ORDER`` for unpicked candidates and leftover singles. The
    host planner emits partitions in greedy pick order followed by leftover
    singles in ascending index, which the batched decoder
    (``core.batch_planner``) reproduces from the rounds.
    """
    cands = candidate_ids_for(np_)
    NC = len(cands)
    dev = costs.device
    cand_bits = torch.as_tensor(_cand_bits(np_), device=dev)
    P = costs.shape[0]
    nonempty = reps >= 0  # (P, NC)

    split_cost = torch.zeros_like(costs)
    for ci, ids in enumerate(cands):
        if len(ids) == 1:
            continue
        split_cost[:, ci] = sum(costs[:, i] for i in ids)
    merged = torch.arange(NC, device=dev) >= np_
    saving = torch.where(
        merged[None, :] & nonempty,
        torch.clamp(split_cost - costs, min=0),
        torch.zeros((), dtype=costs.dtype, device=dev),
    )

    # host tie-break (dpm_partition): max saving, then fewer merged
    # partitions, then smaller candidate index — a two-step argmax/argmin,
    # so exact ties survive float32 savings
    prio_adj = (
        torch.tensor([len(ids) for ids in cands], dtype=torch.int32,
                     device=dev) * 128
        + torch.arange(NC, dtype=torch.int32, device=dev)
    )
    rows = torch.arange(P, device=dev)
    chosen = torch.zeros((P, NC), dtype=torch.bool, device=dev)
    covered = torch.zeros((P,), dtype=torch.int32, device=dev)
    order = torch.full((P, NC), NO_ORDER, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=costs.dtype, device=dev)
    # every winning merge covers >= 2 uncovered partitions, so np_ // 2
    # rounds always reach the fixed point
    for rnd in range(np_ // 2):
        overlap = (cand_bits[None, :] & covered[:, None]) != 0
        saving = torch.where(overlap, zero, saving)
        smax = saving.max(1, keepdim=True).values
        is_best = (saving == smax) & (saving > 0)
        best = torch.argmin(
            torch.where(is_best, prio_adj[None, :], EMPTY_KEY), 1
        )
        has = smax[:, 0] > 0
        covered = torch.where(has, covered | cand_bits[best], covered)
        chosen[rows, best] = chosen[rows, best] | has
        order[rows, best] = torch.where(
            has, torch.clamp(order[rows, best], max=rnd), order[rows, best]
        )
    single_bit = 1 << torch.arange(np_, dtype=torch.int32, device=dev)
    leftover = nonempty[:, :np_] & ((covered[:, None] & single_bit[None, :]) == 0)
    chosen[:, :np_] |= leftover
    return chosen, order


def dpm_plan_weighted(
    dest_mask,  # (P, NN)
    src_xy,  # (P, 2)
    dist,  # (NN, NN) provider-route hop counts
    weight,  # (NN, NN) provider-route prices
    *,
    n: int,
    m: int | None = None,
    wrap: bool = False,
    overhead: float = 0.0,
    include_source_leg: bool = True,
    device: torch.device | str = "cuda",
):
    """Algorithm 1 batched under an arbitrary route-cost tensor.

    ``(dist, weight, overhead)`` come from
    ``repro_torch.core.routefn.route_cost_matrices``. Returns (chosen
    (P,24) bool, costs (P,24) f32, reps (P,24) i32). One
    ``dpm_cost_table_weighted`` launch on the card.
    """
    _, dest_mask, src_xy, dist, weight = _on(
        device, dest_mask, src_xy, dist, weight
    )
    costs, reps = _cost_table_weighted(
        dest_mask, src_xy, dist, weight, n=n, m=m, wrap=wrap,
        overhead=overhead, include_source_leg=include_source_leg,
    )
    return _greedy_merge(costs, reps), costs, reps


# ---------------------------------------------------------------------------
# Generic-topology path: the geometry enters as host-built lookup tables
# instead of the closed-form 2-D coordinate math of the kernels above.
# ---------------------------------------------------------------------------
def partition_membership(g, srcs) -> np.ndarray:
    """(len(srcs), NN) int32 wedge id of every node w.r.t. each source.

    Entry ``[p, v]`` is the basic-partition index of node ``v`` under
    packet ``p``'s source (``core.partition.wedge_patterns`` order over
    sign patterns of ``Topology.delta``), or -1 at the source itself.
    """
    nodes = g.nodes()
    ndim = len(nodes[0])
    index = {p: i for i, p in enumerate(wedge_patterns(ndim))}
    out = np.full((len(srcs), g.num_nodes), -1, np.int32)
    for pi, src in enumerate(srcs):
        for v in nodes:
            dv = g.delta(src, v)
            sign = tuple((x > 0) - (x < 0) for x in dv)
            out[pi, g.idx(v)] = index.get(sign, -1)
    return out


def snake_labels(g) -> np.ndarray:
    """(NN,) int32 boustrophedon label per node, ``Topology.idx`` order."""
    return np.array([g.label(*c) for c in g.nodes()], np.int32)


def _representatives(sel, dsrc, labels):
    """Definition 1 representative of every row: the selected node of least
    ``(dist-to-src, label)``; ``argmin`` keeps the first index on ties as
    ``jnp.argmin`` does (keys of selected nodes are unique)."""
    key = torch.where(sel, dsrc * BIG + labels[None], EMPTY_KEY)
    return torch.argmin(key, 1).to(torch.int32)


def dpm_plan_topo(
    part_of,  # (P, NN) int32 membership (partition_membership), -1 masked
    src_idx,  # (P,) int32 Topology.idx of each source
    labels,  # (NN,) int32 snake labels (snake_labels)
    dist,  # (NN, NN) provider-route hop counts
    weight,  # (NN, NN) provider-route prices
    *,
    np_: int,
    overhead: float = 0.0,
    include_source_leg: bool = True,
    device: torch.device | str = "cuda",
):
    """Algorithm 1 batched on any registered topology, the geometry as data:
    wedge membership (non-destinations masked with -1), snake labels and
    the route-cost tensors. Plain PyTorch (the reference computes it in
    jnp). Returns (chosen (P, 3*np_) bool, costs (P, 3*np_) f32,
    reps (P, 3*np_) i32)."""
    _, part_of, src_idx, labels, dist, weight = _on(
        device, part_of, src_idx, labels, dist, weight
    )
    cands = candidate_ids_for(np_)
    dist = dist.to(torch.int32)
    weight = weight.to(torch.float32)
    src = src_idx.long()
    dsrc = dist[src]  # (P, NN)
    w_src = weight[src]
    costs, reps = [], []
    for ids in cands:
        sel = part_of == ids[0]
        for i in ids[1:]:
            sel = sel | (part_of == i)
        any_sel = sel.any(1)
        rep = _representatives(sel, dsrc, labels)
        w_rep = weight[rep.long()]  # (P, NN) prices from rep
        cnt = sel.to(torch.float32).sum(1)
        ct = torch.where(sel, w_rep, 0.0).sum(1)
        ct = ct + torch.clamp(cnt - 1.0, min=0.0) * float(overhead)
        if include_source_leg:
            ct = ct + w_src.gather(1, rep.long()[:, None])[:, 0]
        costs.append(torch.where(any_sel, ct, 0.0))
        reps.append(torch.where(any_sel, rep, -1))
    costs = torch.stack(costs, 1)
    reps = torch.stack(reps, 1)
    return _greedy_merge(costs, reps, np_), costs, reps


def _chain_cost(sel_l, bound, ascending, label_order, w_flat, rep, NN):
    """Price one dual-path chain side for every (packet, position).

    ``sel_l`` is the selection reordered to label rank; the side's members
    are the selected ranks strictly beyond ``bound`` (the representative's
    label) in the walk direction. Each member's predecessor is the running
    max of selected ranks before it (``torch.cummax``, as
    ``jax.lax.cummax``), or the representative when none. Returns
    (side cost (B,), side nonempty (B,)).
    """
    pos = torch.arange(NN, dtype=torch.int32, device=sel_l.device)
    if ascending:
        active = sel_l & (pos[None, :] > bound[:, None])
        walk = active
        order_nodes = label_order
    else:
        active = sel_l & (pos[None, :] < bound[:, None])
        walk = torch.flip(active, (1,))
        order_nodes = torch.flip(label_order, (0,))
    idx_seq = torch.where(walk, pos[None, :], -1)
    run = torch.cummax(idx_seq, 1).values
    prev = torch.cat([torch.full_like(run[:, :1], -1), run[:, :-1]], 1)
    prev_node = torch.where(
        prev >= 0, order_nodes[prev.clamp(min=0).long()], rep[:, None]
    )
    cur_node = order_nodes[None, :]
    contrib = w_flat[(prev_node * NN + cur_node).long()]
    return torch.where(walk, contrib, 0.0).sum(1), active.any(1)


def dpm_plan_exact(
    dest_mask,  # (B, NN) bool destination sets
    src_idx,  # (B,) int32 Topology.idx of each source
    part_of,  # (B, NN) int32 wedge membership (all nodes), -1 at the source
    labels,  # (NN,) int32 snake labels
    label_order,  # (NN,) int32 node index at each label rank
    dist,  # (NN, NN) provider-route hop counts
    w_uni,  # (NN, NN) unicast-route prices (C_t terms)
    w_high,  # (NN, NN) HIGH-subnetwork label-route prices
    w_low,  # (NN, NN) LOW-subnetwork label-route prices
    *,
    np_: int,
    overhead: float = 0.0,
    include_source_leg: bool = True,
    device: torch.device | str = "cuda",
):
    """Algorithm 1 batched with the full Definition 2 objective: C_t and
    C_p per candidate (C_p by the label-chain prefix scan of
    ``_chain_cost``), the MU/DP mode choice and the greedy pick order —
    everything the host decode needs to rebuild each ``MulticastPlan``
    bit-identically (``core.batch_planner``; exactness conditions in
    ``batch_support`` there). Plain PyTorch in float32 (the reference
    computes it in jnp; sums of the dyadic prices ``batch_support`` admits
    are exact in any order). Returns ``(chosen, order, reps, mode_mu,
    costs)``, all ``(B, 3 * np_)`` over the ``candidate_ids_for`` axis.
    """
    (dev, dest_mask, src_idx, part_of, labels, label_order, dist, w_uni,
     w_high, w_low) = _on(device, dest_mask, src_idx, part_of, labels,
                          label_order, dist, w_uni, w_high, w_low)
    cands = candidate_ids_for(np_)
    NC = len(cands)
    B, NN = dest_mask.shape
    dist = dist.to(torch.int32)
    w_uni = w_uni.to(torch.float32)
    wh_flat = w_high.to(torch.float32).reshape(-1)
    wl_flat = w_low.to(torch.float32).reshape(-1)
    src = src_idx.long()
    dsrc = dist[src]  # (B, NN)
    # All candidates evaluated as one stacked (NC * B, NN) problem through
    # a static candidate->wedge incidence table. ``part_of`` is -1 at the
    # source; like the reference's ``jnp.take``, that index reads the last
    # wedge's column, which matters only for a source listed as its own
    # destination.
    inc = np.zeros((NC, np_), bool)
    for ci, ids in enumerate(cands):
        inc[ci, list(ids)] = True
    inc = torch.as_tensor(inc, device=dev)
    member = inc[:, part_of.long() % np_]  # (NC, B, NN)
    sel = (dest_mask.to(torch.bool)[None] & member).reshape(NC * B, NN)
    any_sel = sel.any(1)
    rep = _representatives(sel, dsrc.repeat(NC, 1), labels)
    rep_l = rep.long()
    # C_t: one unicast worm per non-representative destination
    w_rep = w_uni[rep_l]  # (NC * B, NN) prices from rep
    cnt = sel.to(torch.float32).sum(1)
    cost_mu = torch.where(sel, w_rep, 0.0).sum(1)
    cost_mu = cost_mu + torch.clamp(cnt - 1.0, min=0.0) * float(overhead)
    # C_p: label-ordered chains from the representative, one per side
    rep_lab = labels[rep_l]
    sel_l = sel[:, label_order.long()]
    hi, any_h = _chain_cost(sel_l, rep_lab, True, label_order, wh_flat, rep, NN)
    lo, any_l = _chain_cost(sel_l, rep_lab, False, label_order, wl_flat, rep, NN)
    cost_dp = hi + lo + (
        any_h.to(torch.float32) + any_l.to(torch.float32)
    ) * float(overhead)
    # ties prefer MU (the paper: D_H/D_L computation is then skipped)
    mode_mu = cost_mu <= cost_dp
    cost = torch.minimum(cost_mu, cost_dp)
    if include_source_leg:
        cost = cost + w_uni[src.repeat(NC), rep_l]
    costs = torch.where(any_sel, cost, 0.0).reshape(NC, B).T.contiguous()
    reps = torch.where(any_sel, rep, -1).reshape(NC, B).T.contiguous()
    modes = (mode_mu | ~any_sel).reshape(NC, B).T.contiguous()
    chosen, order = _greedy_merge_ordered(costs, reps, np_)
    return chosen, order, reps, modes, costs
