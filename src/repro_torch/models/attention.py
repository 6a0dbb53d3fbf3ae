"""Attention for training, prefill and decode: GQA (full or sliding window)
and DeepSeek-V2 multi-head latent attention (MLA). Twin of
``repro.models.attention``.

Training and prefill attention go through ``kernels.flash_attention.ops.
flash_attention``: the CUDA kernels when the tensors are on the card, the
plain versions on the CPU. It computes the function of the reference's
``chunked_attention`` (the jnp path, which the reference meant the Pallas
kernel to replace on its accelerator) and, under autograd, its gradient:
the reference's hand-written backward ``_flash_bwd_impl``, on the card the
backward kernel. MLA's values (head dim 128) are
zero-padded to the query/key head dim (192) for the kernel, which has one
head dim for q, k and v, and the output is sliced back: the padded columns
are zeros and the scale ``D**-0.5`` is MLA's ``(nope + rope)**-0.5``.
The backward kernel does not take D = 192, so MLA trains on the CPU only
(on the card a call under grad raises).

Decode attends one query against a contiguous KV cache in plain PyTorch, as
the reference does in jnp; the port writes the new token into the cache in
place. A GQA cache is bf16 (or the run's ``kv_cache_dtype``) or int8 with
one f32 scale per token and head; MLA caches the compressed latent
(``ckv``, ``krope``), bf16 under int8, and decodes with the absorbed
matmuls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from .config import ArchConfig, MLAConfig, RunConfig
from .layers import (
    Params, Specs, dense_apply, dense_init, norm_apply, norm_init, split,
)
from .rope import apply_mrope, apply_rope

NEG_INF = -1e30


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


# ---------------------------------------------------------------------------
# int8 KV cache helpers (per-token-per-head scales)
# ---------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, KH, D) -> int8 values + (B, S, KH, 1) f32 scales.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    qv = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return qv, scale


def dequantize_kv(qv: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (qv.float() * scale).to(dtype)


def latent_cache_dtype(run: RunConfig) -> torch.dtype:
    """MLA's cache type: the run's, bf16 under int8 (the latent is not
    quantized)."""
    if run.kv_cache_dtype == "int8":
        return torch.bfloat16
    return getattr(torch, run.kv_cache_dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------
def gqa_init(gen, cfg: ArchConfig,
             device: torch.device) -> tuple[Params, Specs]:
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b = cfg.qkv_bias
    return split({
        "wq": dense_init(gen, d, H * Dh, "embed", "heads", device, bias=b),
        "wk": dense_init(gen, d, KH * Dh, "embed", "kv_heads", device,
                         bias=b),
        "wv": dense_init(gen, d, KH * Dh, "embed", "kv_heads", device,
                         bias=b),
        "wo": dense_init(gen, H * Dh, d, "heads", "embed", device),
    })


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
    cache = {
        "k": torch.zeros((batch, S, KH, Dh), dtype=dt, device=device),
        "v": torch.zeros((batch, S, KH, Dh), dtype=dt, device=device),
    }
    if run.kv_cache_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, S, KH, 1), dtype=torch.float32,
                                      device=device)
    return cache


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
    if run.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            qv, sc = quantize_kv(t)
            cache[name][:, slot] = qv[:, 0]
            cache[f"{name}_scale"][:, slot] = sc[:, 0]
        kk = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        vv = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        kk, vv = cache["k"], cache["v"]
    idx = torch.arange(S, device=x.device)
    if window:
        # ring cache: every slot is valid once the cache has wrapped. RoPE
        # used absolute positions, so slot order does not matter for scores.
        valid = (idx <= slot) | (pos >= S)
    else:
        valid = idx <= pos
    out = decode_attention(q, kk, vv, valid)
    out = dense_apply(p["wo"], out.reshape(B, 1, H * Dh))
    return out, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg: ArchConfig,
             device: torch.device) -> tuple[Params, Specs]:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return split({
        "wdq": dense_init(gen, d, m.q_lora_rank, "embed", "q_lora", device),
        "wuq": dense_init(gen, m.q_lora_rank,
                          H * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                          "q_lora", "heads", device),
        "wdkv": dense_init(gen, d, m.kv_lora_rank, "embed", "kv_lora",
                           device),
        "wukv": dense_init(gen, m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim),
                           "kv_lora", "heads", device),
        "wkr": dense_init(gen, d, m.qk_rope_head_dim, "embed", "qk_rope",
                          device),
        "wo": dense_init(gen, H * m.v_head_dim, d, "heads", "embed", device),
        # the reference names a norm's one dim "embed" whatever its width
        "qnorm": norm_init(m.q_lora_rank, device),
        "kvnorm": norm_init(m.kv_lora_rank, device),
    })


def _mla_qkv(p: Params, x: torch.Tensor, cfg: ArchConfig,
             positions: torch.Tensor):
    """Full (naive) MLA q/k/v for prefill, and the latent to cache."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H, nope, rope = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = norm_apply(p["qnorm"], dense_apply(p["wdq"], x))
    q = dense_apply(p["wuq"], cq).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    ckv = norm_apply(p["kvnorm"], dense_apply(p["wdkv"], x))
    kv = dense_apply(p["wukv"], ckv).reshape(B, S, H, nope + m.v_head_dim)
    k_nope, v = kv.split([nope, m.v_head_dim], dim=-1)
    k_rope = dense_apply(p["wkr"], x).reshape(B, S, 1, rope)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    return q_full, k_full, v, ckv, k_rope[:, :, 0]


def mla_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    run: RunConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    return_kv: bool = False,
):
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    q, k, v, ckv, krope = _mla_qkv(p, x, cfg, positions)
    Dv = v.shape[-1]
    # one head dim for q, k and v: v zero-padded to q's, output sliced back
    v = F.pad(v, (0, q.shape[-1] - Dv))
    out = flash_attention(q, k, v, causal=True, device=x.device)[..., :Dv]
    out = dense_apply(p["wo"], out.reshape(B, S, cfg.n_heads * m.v_head_dim))
    if return_kv:
        return out, (ckv, krope)
    return out


def mla_init_cache(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
                   device: torch.device) -> dict:
    m: MLAConfig = cfg.mla
    dt = latent_cache_dtype(run)
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                           device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt,
                             device=device),
    }


def mla_decode(
    p: Params,
    cache: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    run: RunConfig,
    pos: int,  # tokens already in the cache
):
    """Absorbed-matmul MLA decode, attending in the latent space; writes the
    new latent into ``cache`` in place and returns ``(out, cache)``.

    q_eff = q_nope @ W_uk (absorb the key up-projection); scores = q_eff .
    c_kv + q_rope . k_rope; out = ((attn @ c_kv) @ W_uv) @ W_o (absorb the
    value up-projection). ``wukv`` is read in f32, as the reference does.
    """
    m: MLAConfig = cfg.mla
    B = x.shape[0]
    H, nope, rope = cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cq = norm_apply(p["qnorm"], dense_apply(p["wdq"], x))
    q = dense_apply(p["wuq"], cq).reshape(B, 1, H, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_new = norm_apply(p["kvnorm"], dense_apply(p["wdkv"], x))  # (B,1,L)
    krope_new = apply_rope(
        dense_apply(p["wkr"], x).reshape(B, 1, 1, rope), positions,
        cfg.rope_theta).reshape(B, 1, rope)
    cache["ckv"][:, pos] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][:, pos] = krope_new[:, 0].to(cache["krope"].dtype)
    S = cache["ckv"].shape[1]
    wukv = p["wukv"]["w"].float().reshape(m.kv_lora_rank, H,
                                          nope + m.v_head_dim)
    w_uk, w_uv = wukv[:, :, :nope], wukv[:, :, nope:]
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), w_uk)
    ckv_f = cache["ckv"].float()
    s = torch.einsum("bhl,bsl->bhs", q_eff, ckv_f)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                         cache["krope"].float())
    valid = torch.arange(S, device=x.device) <= pos
    s = torch.where(valid[None, None, :], s * (nope + rope) ** -0.5, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhs,bsl->bhl", prob, ckv_f)  # (B, H, L)
    out = torch.einsum("bhl,lhd->bhd", out_lat, w_uv)
    out = out.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    return dense_apply(p["wo"], out), cache
