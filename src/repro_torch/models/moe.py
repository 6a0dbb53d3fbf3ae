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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def route(p: Params, x: torch.Tensor, m: MoEConfig):
    """Router: f32 softmax over experts, top-k with renormalised weights.

    ``x``: (T, d). Returns (expert ids (T, k) int64, weights (T, k) f32, the
    Switch-style load-balance loss of training).
    """
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    # a stable descending sort is lax.top_k's order: ties to the lower id
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, : m.top_k], ids[:, : m.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = m.n_experts
    assign = torch.zeros((x.shape[0], E), dtype=torch.float32,
                         device=x.device)
    assign.scatter_add_(1, ids, torch.ones_like(weights))
    f = assign.mean(0) / m.top_k
    aux = E * torch.sum(f * probs.mean(0))
    return ids, weights, aux


def capacity(m: MoEConfig, tokens: int) -> int:
    c = int(tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, (c + 7) // 8 * 8)


def dispatch_indices(ids: torch.Tensor, m: MoEConfig, cap: int):
    """Sort-based dispatch plan.

    ``ids``: (T, k) expert choices. Returns (slot (T*k,), keep (T*k,)):
    ``slot`` indexes an (E*cap,) buffer; dropped pairs get slot 0 / keep
    False.
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
    keep = ranked < cap
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
    """Token-major in, (E, cap, d) expert compute, combine.

    x: (B, S, d). Returns (y, aux_loss).
    """
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    T, k = B * S, m.top_k
    xt = x.reshape(T, d)
    ids, w, aux = route(p, xt, m)
    cap = capacity(m, T)
    slot, keep = dispatch_indices(ids, m, cap)
    buf = dispatch_buffer(xt, slot, keep, k, m.n_experts * cap)
    ye = expert_ffn(p, buf.reshape(m.n_experts, cap, d))
    y = combine(ye.reshape(m.n_experts * cap, d), slot, keep, w, k)
    if m.n_shared:
        y = y + shared_ffn(p, xt)
    return y.reshape(B, S, d), aux
