"""GQA attention (full or sliding window) for prefill and decode. Twin of
the GQA half of ``repro.models.attention``.

Prefill attention goes through ``kernels.flash_attention.ops.
flash_attention``: the CUDA kernel when the tensors are on the card, the
plain version on the CPU. It computes the function of the reference's
``chunked_attention`` (the jnp path), which the reference meant the Pallas
kernel to replace on its accelerator. Decode attends one query against a
contiguous KV cache in plain PyTorch, as the reference does in jnp; the
port writes the new token into the cache in place.

MLA and the int8 KV cache are not ported yet (ROADMAP.md, queue 1, item 6
step 3).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from .config import ArchConfig, RunConfig
from .layers import Params, dense_apply, dense_init
from .rope import apply_mrope, apply_rope

NEG_INF = -1e30
LATER = "ROADMAP.md, queue 1, item 6 step 3"


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, D)
    valid: torch.Tensor,  # (S,) or (B, S) bool
) -> torch.Tensor:
    B, _, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qf = q.reshape(B, KH, G, D).float() * D**-0.5
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    if valid.dim() == 1:
        valid = valid[None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def gqa_init(gen, cfg: ArchConfig, device: torch.device) -> Params:
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = cfg.qkv_bias
    return {
        "wq": dense_init(gen, d, H * Dh, device, bias=b),
        "wk": dense_init(gen, d, KH * Dh, device, bias=b),
        "wv": dense_init(gen, d, KH * Dh, device, bias=b),
        "wo": dense_init(gen, H * Dh, d, device),
    }


def _positions_3d(positions: torch.Tensor) -> torch.Tensor:
    """Text-only stand-in for M-RoPE ids: (B,S) -> (B,S,3) equal sections."""
    return positions[..., None].expand(*positions.shape, 3)


def _rope_q_k(q, k, positions, cfg: ArchConfig):
    if cfg.pos == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos == "mrope":
        p3 = _positions_3d(positions)
        return (apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections))
    return q, k  # sinusoidal/none handled at the embedding


def gqa_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    run: RunConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    window: int | None = None,
    return_kv: bool = False,
):
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_apply(p["wq"], x).reshape(B, S, H, Dh)
    k = dense_apply(p["wk"], x).reshape(B, S, KH, Dh)
    v = dense_apply(p["wv"], x).reshape(B, S, KH, Dh)
    q, k = _rope_q_k(q, k, positions, cfg)
    out = flash_attention(q, k, v, causal=True, window=window,
                          device=x.device)
    out = dense_apply(p["wo"], out.reshape(B, S, H * Dh))
    if return_kv:
        return out, (k, v)
    return out


def gqa_init_cache(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
                   window: int | None, device: torch.device) -> dict:
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    S = min(max_len, window) if window else max_len
    dt = getattr(torch, run.kv_cache_dtype)
    return {
        "k": torch.zeros((batch, S, KH, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, S, KH, Dh), dtype=dt, device=device),
    }


def gqa_decode(
    p: Params,
    cache: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    run: RunConfig,
    pos: int,  # tokens already in the cache
    *,
    window: int | None = None,
):
    """One decode step; writes the new K/V into ``cache`` in place and
    returns ``(out, cache)``."""
    B = x.shape[0]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = cache["k"].shape[1]
    q = dense_apply(p["wq"], x).reshape(B, 1, H, Dh)
    k = dense_apply(p["wk"], x).reshape(B, 1, KH, Dh)
    v = dense_apply(p["wv"], x).reshape(B, 1, KH, Dh)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rope_q_k(q, k, positions, cfg)
    slot = pos % S if window else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    idx = torch.arange(S, device=x.device)
    if window:
        # ring cache: every slot is valid once the cache has wrapped. RoPE
        # used absolute positions, so slot order does not matter for scores.
        valid = (idx <= slot) | (pos >= S)
    else:
        valid = idx <= pos
    out = decode_attention(q, cache["k"], cache["v"], valid)
    out = dense_apply(p["wo"], out.reshape(B, 1, H * Dh))
    return out, cache
