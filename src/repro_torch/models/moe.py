"""Mixture-of-Experts FFN: softmax top-k router + sort-based dispatch. Twin
of ``repro.models.moe``.

Routed (token, expert) pairs are sorted by expert id, ranked within their
expert and copied into an ``(E * cap, d)`` buffer; a pair ranked at or past
the capacity ``cap`` is dropped. Every expert then runs its SwiGLU over its
``cap`` rows (padding rows included), and each kept pair's output comes
back weighted by its router weight. The reference has no kernel here: its
expert products are ``jnp.einsum`` outside any Pallas call, as they are
``torch.einsum`` here.

Slots, drops and ranks equal the reference's exactly: tokens are flattened
row-major over ``(B, S)`` then over the k choices, the sort is stable, and
the top-k order is ``lax.top_k``'s (ties to the lower expert id). Padding
tokens are routed and take capacity, as in the reference.

In training on a mesh (``shardctx.tensor_parallel``) the layer computes
the global batch's function from each rank's rows: the capacity comes from
the global token count, a pair's rank within its expert is the count of
that expert's pairs on the ranks before this one (the batch's rows are in
rank order) plus its rank here, and the load-balance loss's ``f`` and
``pbar`` are global means. Each rank fills its own rows' slots. The
gradient of the global ``aux`` reaches each rank's rows alone, so its
``pbar`` sums over the ranks with psum's transpose (``SumOverRanks``):
after ``DataParallel`` averages the ranks' gradients the aux term is the
reference's, not 1/n of it. Over ``model`` the experts are split (the
reference constrains the buffer to ``("experts", None, None)``): a rank
runs its experts' FFN on its slice of the buffer and combines their
pairs, the shared expert runs as a split MLP, the router's logits are
gathered whole, and the ranks' partial outputs are summed. Outside
training on a mesh the view has one rank of each kind
(``dist.comm.ONE_RANK``) and the same code is the one-process layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..shardctx import tensor_parallel
from .config import ArchConfig, MoEConfig
from .layers import Params, Specs, dense_init, normal, split


def moe_init(gen, cfg: ArchConfig,
             device: torch.device) -> tuple[Params, Specs]:
    m: MoEConfig = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    leaves = {
        "router": dense_init(gen, d, E, "embed", "experts", device),
        # stacked expert weights: (E, d, ff) / (E, ff, d)
        "wi": (normal(gen, (E, d, f), d**-0.5, device),
               ("experts", "embed", "expert_mlp")),
        "wg": (normal(gen, (E, d, f), d**-0.5, device),
               ("experts", "embed", "expert_mlp")),
        "wo": (normal(gen, (E, f, d), f**-0.5, device),
               ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared:
        fs = m.n_shared * f
        leaves["shared_wi"] = (normal(gen, (d, fs), d**-0.5, device),
                               ("embed", "mlp"))
        leaves["shared_wg"] = (normal(gen, (d, fs), d**-0.5, device),
                               ("embed", "mlp"))
        leaves["shared_wo"] = (normal(gen, (fs, d), f**-0.5, device),
                               ("mlp", "embed"))
    return split(leaves)


def route(p: Params, x: torch.Tensor, m: MoEConfig, tp=None):
    """Router: f32 softmax over experts, top-k with renormalised weights.

    ``x``: (T, d). Returns (expert ids (T, k) int64, weights (T, k) f32, the
    Switch-style load-balance loss of training). On a training mesh
    (``tp``, a ``dist.comm.TensorParallel``; one process's by default) the
    logits are whole on every model rank and the loss's means are over the
    rows of every row rank.
    """
    if tp is None:
        from ..dist.comm import ONE_RANK

        tp = ONE_RANK
    E = m.n_experts
    router = p["router"]["w"]
    logits = (tp.gather(x.float() @ router.float(), E) if tp.split(E)
              else x.float() @ tp.enter(router).float())
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    # a stable descending sort is lax.top_k's order: ties to the lower id
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, : m.top_k], ids[:, : m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    assign = torch.zeros((x.shape[0], E), dtype=torch.float32,
                         device=x.device)
    assign.scatter_add_(1, ids, torch.ones_like(weights))
    T = x.shape[0] * tp.n_rows
    f = tp.rows_sum(assign.sum(0)) / T / m.top_k
    aux = E * torch.sum(f * (tp.rows_sum(probs.sum(0)) / T))
    return ids, weights, aux


def capacity(m: MoEConfig, tokens: int) -> int:
    c = int(tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, (c + 7) // 8 * 8)


def dispatch_indices(ids: torch.Tensor, m: MoEConfig, cap: int,
                     before: torch.Tensor | None = None):
    """Sort-based dispatch plan.

    ``ids``: (T, k) expert choices. Returns (slot (T*k,), keep (T*k,)):
    ``slot`` indexes an (E*cap,) buffer; dropped pairs get slot 0 / keep
    False. ``before`` (E,) counts each expert's pairs ranked ahead of these
    (other ranks' rows): a pair is kept iff its global rank is below
    ``cap``, and takes its slot from its rank among these pairs.
    """
    Tk = ids.numel()
    flat = ids.reshape(Tk)
    order = torch.argsort(flat, stable=True)  # group by expert
    sorted_e = flat[order]
    pos = torch.arange(Tk, device=ids.device)
    # rank within expert = position - first position of that expert
    first = torch.full((m.n_experts,), Tk, dtype=pos.dtype, device=ids.device)
    first.scatter_reduce_(0, sorted_e, pos, "amin")
    ranked = torch.empty_like(pos)
    ranked[order] = pos - first[sorted_e]
    keep = ranked < cap if before is None else ranked + before[flat] < cap
    slot = torch.where(keep, flat * cap + ranked, 0)
    return slot, keep


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, cap, d) -> (E, cap, d) SwiGLU per expert."""
    dt = xe.dtype
    h = torch.einsum("ecd,edf->ecf", xe, p["wi"].to(dt))
    g = torch.einsum("ecd,edf->ecf", xe, p["wg"].to(dt))
    return torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"].to(dt))


def shared_ffn(p: Params, xt: torch.Tensor) -> torch.Tensor:
    """The shared (always-on) experts' SwiGLU over every token: (T, d)."""
    dt = xt.dtype
    h = xt @ p["shared_wi"].to(dt)
    g = xt @ p["shared_wg"].to(dt)
    return (F.silu(g) * h) @ p["shared_wo"].to(dt)


def dispatch_buffer(xt: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
                    k: int, n: int) -> torch.Tensor:
    """The ``(n, d)`` expert buffer: slot ``slot[i]`` holds the token of
    routed pair ``i`` (pairs flattened over (token, choice)), the rest are
    zero. Kept slots are unique and dropped pairs all write a spare last
    entry, so the buffer is a gather of 0 + token (``xt + 0.0`` turns -0.0
    into +0.0), which is what the reference's ``.at[slot].add`` onto zeros
    holds, with no atomics."""
    Tk = slot.shape[0]
    pair = torch.full((n + 1,), Tk, device=xt.device)
    pair.scatter_(0, torch.where(keep, slot, n),
                  torch.arange(Tk, device=xt.device))
    pair = pair[:n]
    return torch.where((pair < Tk)[:, None],
                       (xt + 0.0)[pair.clamp(max=Tk - 1) // k], 0)


def combine(ye: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            w: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's kept pairs' expert outputs (rows of the ``(n, d)``
    buffer ``ye``) weighted by their router weights and summed: (T, d)."""
    gathered = torch.where(keep[:, None], ye[slot], 0)  # (T*k, d)
    d = ye.shape[-1]
    return (gathered.reshape(-1, k, d) * w[..., None].to(ye.dtype)).sum(1)


def moe_apply_dense(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """Token-major in, (E, cap, d) expert compute, combine; on a training
    mesh the global batch's function from this rank's rows and ``model``
    blocks (module docstring).

    x: (B, S, d). Returns (y, aux_loss).
    """
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    tp = tensor_parallel()
    xt = tp.enter(x.reshape(T, d))
    ids, w, aux = route(p, xt, m, tp)
    cap = capacity(m, T * tp.n_rows)
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    slot, keep = dispatch_indices(ids, m, cap, tp.rows_before(counts))
    # this rank's experts: its slice of the buffer
    e0, e1 = tp.block(E)
    flat = ids.reshape(-1)
    mine = keep & (flat >= e0) & (flat < e1)
    slot = torch.where(mine, slot - e0 * cap, 0)
    rows = (e1 - e0) * cap
    experts = {n: p[n] for n in ("wi", "wg", "wo")}
    if not tp.split(E):
        experts = {n: tp.enter(t) for n, t in experts.items()}
    buf = dispatch_buffer(xt, slot, mine, k, rows)
    ye = expert_ffn(experts, buf.reshape(e1 - e0, cap, d))
    parts = [(combine(ye.reshape(rows, d), slot, mine, w, k), E)]
    if m.n_shared:
        width = m.n_shared * m.d_expert
        shared = {n: p[n] for n in ("shared_wi", "shared_wg", "shared_wo")}
        if not tp.split(width):
            shared = {n: tp.enter(t) for n, t in shared.items()}
        parts.append((shared_ffn(shared, xt), width))
    # the parts that the ranks split are summed over them, those computed
    # whole counted once
    partial = [y for y, full in parts if tp.split(full)]
    whole = [y for y, full in parts if not tp.split(full)]
    y = tp.leave(sum(partial)) if partial else 0
    if whole:
        y = y + tp.leave_replicated(sum(whole))
    return y.reshape(B, S, d), tp.leave_replicated(aux)
