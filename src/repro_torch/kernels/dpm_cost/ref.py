"""Plain PyTorch versions of the two ``dpm_cost`` kernels: the CPU engine
and the kernels' oracle on the card. Twin of ``repro.kernels.dpm_cost.ref``,
the same arithmetic on torch tensors of any device."""
from __future__ import annotations

import torch

from .dpm_cost import BIG, CANDS, EMPTY_KEY, _ring_delta


def _geometry(dest_mask, src_xy, n, m, wrap):
    """Snake labels, per-candidate selections and the source displacement
    of a batch: ``(xs, ys, blabel, dm, sx, sy, parts, dxs, dys)``."""
    P, NN = dest_mask.shape
    node = torch.arange(NN, dtype=torch.int32, device=dest_mask.device)
    xs, ys = node % n, node // n
    blabel = torch.where(ys % 2 == 0, ys * n + xs, ys * n + (n - 1 - xs))
    dm = dest_mask.to(torch.int32)
    src_xy = src_xy.to(torch.int32)
    sx, sy = src_xy[:, 0:1], src_xy[:, 1:2]
    dxs = _ring_delta(xs[None] - sx, n, wrap)
    dys = _ring_delta(ys[None] - sy, m, wrap)
    gx, lx, ex = dxs > 0, dxs < 0, dxs == 0
    gy, ly, ey = dys > 0, dys < 0, dys == 0
    # P0..P7 counter-clockwise from the upper-right quadrant (Fig. 2a)
    parts = [
        gx & gy, ex & gy, lx & gy, lx & ey,
        lx & ly, ex & ly, gx & ly, gx & ey,
    ]
    return xs, ys, blabel, dm, sx, sy, parts, dxs, dys


def _selection(dm, parts, ids):
    cm = parts[ids[0]]
    for i in ids[1:]:
        cm = cm | parts[i]
    return (dm > 0) & cm


def dpm_cost_table_ref(
    dest_mask, src_xy, *, n, m=None, wrap=False, include_source_leg=True
):
    """``(costs (P, 24) int32, reps (P, 24) int32)``: the Definition 1
    representative (``argmin dist * 2^20 + snake label``) and C_t of each
    of the 24 candidates, plus the S->R leg; an empty candidate gives cost
    0 and rep -1."""
    m = m or n
    xs, ys, blabel, dm, sx, sy, parts, dxs, dys = _geometry(
        dest_mask, src_xy, n, m, wrap
    )
    dsrc = dxs.abs() + dys.abs()
    costs, reps = [], []
    for ids in CANDS:
        sel = _selection(dm, parts, ids)
        any_sel = sel.any(1)
        key = torch.where(sel, dsrc * BIG + blabel[None], EMPTY_KEY)
        rep = torch.argmin(key, 1).to(torch.int32)
        rx, ry = rep % n, rep // n
        drep = _ring_delta(xs[None] - rx[:, None], n, wrap).abs() + _ring_delta(
            ys[None] - ry[:, None], m, wrap
        ).abs()
        ct = torch.where(sel, drep, 0).sum(1, dtype=torch.int32)
        if include_source_leg:
            ct = ct + _ring_delta(rx - sx[:, 0], n, wrap).abs() + _ring_delta(
                ry - sy[:, 0], m, wrap
            ).abs()
        costs.append(torch.where(any_sel, ct, 0))
        reps.append(torch.where(any_sel, rep, -1))
    return torch.stack(costs, 1), torch.stack(reps, 1)


def dpm_cost_table_weighted_ref(
    dest_mask, src_xy, dist, weight, *, n, m=None, wrap=False,
    overhead=0.0, include_source_leg=True,
):
    """``(costs (P, 24) float32, reps (P, 24) int32)`` over dense
    ``(NN, NN)`` route tensors: reps from ``dist`` (truncated to int32),
    C_t and the leg from ``weight`` rows, plus ``overhead`` per destination
    beyond the representative. Rows are gathered by indexing, never by a
    matrix product."""
    m = m or n
    xs, ys, blabel, dm, sx, sy, parts, dxs, dys = _geometry(
        dest_mask, src_xy, n, m, wrap
    )
    dist = dist.to(torch.float32)
    weight = weight.to(torch.float32)
    src_idx = (sy[:, 0] * n + sx[:, 0]).long()
    dsrc = dist[src_idx].to(torch.int32)
    w_src = weight[src_idx]
    costs, reps = [], []
    for ids in CANDS:
        sel = _selection(dm, parts, ids)
        any_sel = sel.any(1)
        key = torch.where(sel, dsrc * BIG + blabel[None], EMPTY_KEY)
        rep = torch.argmin(key, 1).to(torch.int32)
        w_rep = weight[rep.long()]
        cnt = sel.to(torch.float32).sum(1)
        ct = torch.where(sel, w_rep, 0.0).sum(1)
        ct = ct + torch.clamp(cnt - 1.0, min=0.0) * float(overhead)
        if include_source_leg:
            ct = ct + w_src.gather(1, rep.long()[:, None])[:, 0]
        costs.append(torch.where(any_sel, ct, 0.0))
        reps.append(torch.where(any_sel, rep, -1))
    return torch.stack(costs, 1), torch.stack(reps, 1)
