"""Attention for training, prefill and decode: GQA (full or sliding window)
and DeepSeek-V2 multi-head latent attention (MLA). Twin of
``repro.models.attention``.

Training and prefill attention go through ``kernels.flash_attention.ops.
flash_attention``: the CUDA kernels when the tensors are on the card, the
plain versions on the CPU. It computes the function of the reference's
``chunked_attention`` (the jnp path, which the reference meant the Pallas
kernel to replace on its accelerator) and, under autograd, its gradient:
the reference's hand-written backward ``_flash_bwd_impl``, on the card the
backward kernel. MLA's values keep their own head dim (128) beside the
query/key head dim (192), as in the reference's ``_flash_fwd_impl``: the
kernels, forward and backward, take that pair, and the scale ``D**-0.5``
is q's, MLA's ``(nope + rope)**-0.5``. MLA trains on the card as GQA does.

Under tensor parallelism (``shardctx.tensor_parallel``) a rank runs attention
on its own heads through the same kernels. The weights are 2-D, ``(d,
H*Dh)`` with axes ``("embed", "heads")``, and the rule splits H*Dh
wherever the model size divides it, also mid-head: where a rank's columns
are whole heads and its q heads are the groups of its kv heads, it
attends on them alone; otherwise it gathers the q/k/v columns of the heads
that its block of the output needs (``_head_span``). Either way the
rank's block of ``wo``'s rows takes its block of the output and the ranks'
partial products are summed.

Decode attends one query against a contiguous KV cache in plain PyTorch, as
the reference does in jnp; the port writes the new token into the cache in
place. A GQA cache is bf16 (or the run's ``kv_cache_dtype``) or int8 with
one f32 scale per token and head; MLA caches the compressed latent
(``ckv``, ``krope``), bf16 under int8, and decodes with the absorbed
matmuls.

Serving on a mesh (``shardctx.serving_on``) lays the caches out as
``dist.sharding.CACHE_RULES`` does: every head, and this rank's block of
the sequence over ``model`` (``TensorParallel.seq_block``). The prefill
attends on the rank's heads as training does and returns k/v of every
head (the ranks' heads gathered, or the whole k/v a head split already
gathered; MLA's latent is whole on every rank), which ``models.blocks``
cuts to the rank's block. A decode step projects with the rank's blocks,
gathers q (MLA: the absorbed query) of every head, attends over its own
block of the cache and merges the ranks' parts (``merge_softmax``); only
the rank whose block holds the new token's slot writes it. The
``attn_stream_bf16`` option streams the prefill's and training's
attention in bf16 (``kernels.flash_attention.ops``).
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import flash_attention
from .config import ArchConfig, MLAConfig, RunConfig
from ..shardctx import tensor_parallel
from .layers import (
    Params, Specs, dense_apply, dense_init, norm_apply, norm_init,
    row_parallel, split, tp_project, tree_map,
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


def _softmax_parts(s: torch.Tensor, valid: torch.Tensor, vals, spec: str):
    """This rank's part of a softmax-weighted sum over its keys (the last
    dim of the scores ``s``, ``valid`` broadcast to them): ``(acc, row
    max, row total)`` for ``TensorParallel.merge_softmax``; ``spec`` is
    the einsum of the weights with ``vals``."""
    s = torch.where(valid, s, NEG_INF)
    mx = s.amax(-1)
    e = torch.where(valid, torch.exp(s - mx[..., None]), 0.0)
    return torch.einsum(spec, e, vals), mx, e.sum(-1)


def _decode_attention_tp(tp, q, k, v, valid) -> torch.Tensor:
    """``decode_attention`` with the keys split over the model ranks: this
    rank's block of the cache, all heads, the parts merged."""
    B, _, H, D = q.shape
    KH = k.shape[2]
    if tp.model is None:
        return decode_attention(q, k, v, valid)
    qf = q.reshape(B, KH, H // KH, D).float() * D**-0.5
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    valid = (valid[None, :] if valid.dim() == 1 else valid)[:, None, None]
    parts = _softmax_parts(s, valid, v.float(), "bhgs,bshd->bhgd")
    return tp.merge_softmax(*parts).reshape(B, 1, H, D).to(q.dtype)


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
    G = H // KH
    tp = tensor_parallel().over(H * Dh)
    xe = tp.enter(x)
    if H % tp.m == 0 and KH % tp.m == 0:
        # whole heads on every rank, its q heads the groups of its kv heads
        q = dense_apply(p["wq"], xe).reshape(B, S, H // tp.m, Dh)
        k = dense_apply(p["wk"], xe).reshape(B, S, KH // tp.m, Dh)
        v = dense_apply(p["wv"], xe).reshape(B, S, KH // tp.m, Dh)
        q, k = _rope_q_k(q, k, positions, cfg)
        out = flash_attention(q, k, v, causal=True, window=window,
                              stream_bf16=run.attn_stream_bf16,
                              device=x.device)
        out = out.reshape(B, S, -1)
        if return_kv:  # the cache holds every head: the ranks' gathered
            k, v = tp.cat(k, 2), tp.cat(v, 2)
    else:
        # a head split: the rank's columns are not whole heads, or its q
        # heads are not the groups of its kv heads. Each rank gathers the
        # q/k/v columns (whole tensors, then the heads of its span) of the
        # heads that its block of the output needs; heads on a block's
        # edge are computed by both ranks, each keeping its columns.
        lo, hi = tp.block(H * Dh)
        h0, h1 = _head_span(lo, hi, Dh, G)
        g0, g1 = h0 // G, (h1 - 1) // G + 1
        q = tp_project(tp, p["wq"], xe, H * Dh).reshape(B, S, H, Dh)
        k = tp_project(tp, p["wk"], xe, KH * Dh).reshape(B, S, KH, Dh)
        v = tp_project(tp, p["wv"], xe, KH * Dh).reshape(B, S, KH, Dh)
        # k roped whole: its span attends, all of it goes to a cache
        q, k = _rope_q_k(q[:, :, h0:h1], k, positions, cfg)
        out = flash_attention(q, k[:, :, g0:g1].contiguous(),
                              v[:, :, g0:g1].contiguous(), causal=True,
                              window=window,
                              stream_bf16=run.attn_stream_bf16,
                              device=x.device)
        out = out.reshape(B, S, -1)[..., lo - h0 * Dh:hi - h0 * Dh]
    y = row_parallel(tp, p["wo"], out)
    if return_kv:
        return y, (k, v)
    return y


def _head_span(lo: int, hi: int, dh: int, group: int) -> tuple[int, int]:
    """The q heads ``[h0, h1)`` that columns ``[lo, hi)`` of the attention
    output (``dh`` a head) lie in, widened to whole kv groups of ``group``
    q heads where they reach into more than one, so that local q head
    ``i`` reads local kv head ``i // group`` (inside one group the span
    reads its one kv head)."""
    h0, h1 = lo // dh, -(-hi // dh)
    g0, g1 = h0 // group, (h1 - 1) // group + 1
    if g1 - g0 > 1:
        h0, h1 = g0 * group, g1 * group
    return h0, h1


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
    returns ``(out, cache)``. On a mesh ``cache`` is this rank's block of
    the sequence (module docstring)."""
    B = x.shape[0]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = tensor_parallel()
    tw = tp.over(H * Dh)
    xe = tw.enter(x)
    q = tp_project(tw, p["wq"], xe, H * Dh).reshape(B, 1, H, Dh)
    k = tp_project(tw, p["wk"], xe, KH * Dh).reshape(B, 1, KH, Dh)
    v = tp_project(tw, p["wv"], xe, KH * Dh).reshape(B, 1, KH, Dh)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rope_q_k(q, k, positions, cfg)
    first, S = tp.seq_span(cache["k"].shape[1])
    slot = pos % S if window else pos
    i = slot - first  # the slot in this rank's block, if it holds it
    mine = 0 <= i < cache["k"].shape[1]
    if run.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            qv, sc = quantize_kv(t)
            if mine:
                cache[name][:, i] = qv[:, 0]
                cache[f"{name}_scale"][:, i] = sc[:, 0]
        kk = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        vv = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        if mine:
            cache["k"][:, i] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, i] = v[:, 0].to(cache["v"].dtype)
        kk, vv = cache["k"], cache["v"]
    idx = first + torch.arange(cache["k"].shape[1], device=x.device)
    if window:
        # ring cache: every slot is valid once the cache has wrapped. RoPE
        # used absolute positions, so slot order does not matter for scores.
        valid = (idx <= slot) | (pos >= S)
    else:
        valid = idx <= pos
    out = _decode_attention_tp(tp, q, kk, vv, valid)
    lo, hi = tw.block(H * Dh)
    out = row_parallel(tw, p["wo"], out.reshape(B, 1, H * Dh)[..., lo:hi])
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


def mla_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    run: RunConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    return_kv: bool = False,
):
    """Full (naive) MLA for prefill and training, on this rank's heads:
    the latents and the shared rope key are computed whole (their leaves
    are replicated), the up-projections and ``wo`` split by heads. With
    ``return_kv``, also the latent and the rope key to cache (whole on
    every rank)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H, nope, rope, dv = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim)
    tp = tensor_parallel().over(H * (nope + rope), H * (nope + dv), H * dv)
    cq = tp.enter(norm_apply(p["qnorm"], dense_apply(p["wdq"], x)))
    ckv = norm_apply(p["kvnorm"], dense_apply(p["wdkv"], x))
    k_rope = tp.enter(dense_apply(p["wkr"], x).reshape(B, S, 1, rope))
    lo, hi = tp.block(H * dv)
    if H % tp.m == 0:  # whole heads in wuq, wukv and wo
        h = H // tp.m
        q = dense_apply(p["wuq"], cq).reshape(B, S, h, nope + rope)
        kv = dense_apply(p["wukv"], tp.enter(ckv)).reshape(B, S, h,
                                                           nope + dv)
        h0 = lo // dv
    else:
        # a head split: gather the q/kv columns, keep the heads that this
        # rank's block of the output lies in
        h0, h1 = _head_span(lo, hi, dv, 1)
        q = tp_project(tp, p["wuq"], cq, H * (nope + rope)).reshape(
            B, S, H, nope + rope)[:, :, h0:h1]
        kv = tp_project(tp, p["wukv"], tp.enter(ckv), H * (nope + dv)
                        ).reshape(B, S, H, nope + dv)[:, :, h0:h1]
        h = h1 - h0
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    k_nope, v = kv.split([nope, dv], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, rope)], dim=-1)
    out = flash_attention(q, k, v, causal=True,
                          stream_bf16=run.attn_stream_bf16, device=x.device)
    out = out.reshape(B, S, h * dv)[..., lo - h0 * dv:hi - h0 * dv]
    # where wo is not split every rank computed every head: its replicated
    # product is counted once
    wo = p["wo"] if tp.split(H * dv) else tree_map(tp.enter, p["wo"])
    y = tp.close(out @ wo["w"].to(out.dtype), H * dv)
    if return_kv:
        return y, (ckv, k_rope[:, :, 0])
    return y


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
    On a mesh each rank absorbs with its heads' block of ``wukv``, gathers
    the absorbed query of every head, attends over its block of the
    latent, merges the ranks' parts and takes its heads' block of the
    merged latent output into ``wo``'s rows; heads split mid-head over
    ``model`` are refused.
    """
    m: MLAConfig = cfg.mla
    B = x.shape[0]
    H, nope, rope, dv = (cfg.n_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim)
    tp = tensor_parallel()
    tw = tp.over(H * (nope + rope), H * (nope + dv), H * dv)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cq = norm_apply(p["qnorm"], dense_apply(p["wdq"], x))
    q = tp_project(tw, p["wuq"], tw.enter(cq), H * (nope + rope)).reshape(
        B, 1, H, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_new = norm_apply(p["kvnorm"], dense_apply(p["wdkv"], x))  # (B,1,L)
    krope_new = apply_rope(
        dense_apply(p["wkr"], x).reshape(B, 1, 1, rope), positions,
        cfg.rope_theta).reshape(B, 1, rope)
    first, _ = tp.seq_span(cache["ckv"].shape[1])
    if 0 <= pos - first < cache["ckv"].shape[1]:  # this rank holds the slot
        cache["ckv"][:, pos - first] = ckv_new[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, pos - first] = krope_new[:, 0].to(
            cache["krope"].dtype)
    h0, h1 = 0, H  # the heads of this rank's block of wukv
    if tw.split(H * (nope + dv)):
        if H % tw.m:
            raise NotImplementedError(
                f"mla_decode: {H} heads split mid-head over the {tw.m} "
                "ranks of 'model'; serving MLA on a mesh needs whole heads "
                "a rank")
        h0, h1 = tw.block(H)
    wukv = p["wukv"]["w"].float().reshape(m.kv_lora_rank, h1 - h0, nope + dv)
    w_uk, w_uv = wukv[:, :, :nope], wukv[:, :, nope:]
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0, h0:h1].float(), w_uk)
    if h1 - h0 < H:
        q_eff = tw.cat(q_eff, 1)  # every head's: (B, H, L)
    ckv_f = cache["ckv"].float()
    s = torch.einsum("bhl,bsl->bhs", q_eff, ckv_f)
    s = s + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                         cache["krope"].float())
    valid = first + torch.arange(ckv_f.shape[1], device=x.device) <= pos
    s = s * (nope + rope) ** -0.5
    if tp.model is None:
        prob = torch.softmax(torch.where(valid[None, None, :], s, NEG_INF),
                             dim=-1)
        out_lat = torch.einsum("bhs,bsl->bhl", prob, ckv_f)  # (B, H, L)
    else:
        out_lat = tp.merge_softmax(*_softmax_parts(
            s, valid[None, None, :], ckv_f, "bhs,bsl->bhl"))
    out = torch.einsum("bhl,lhd->bhd", out_lat[:, h0:h1], w_uv)
    out = out.reshape(B, 1, (h1 - h0) * dv).to(x.dtype)
    # the rank's rows of wo take its columns of the output
    lo, hi = tw.block(H * dv)
    wo = p["wo"] if tw.split(H * dv) else tree_map(tw.enter, p["wo"])
    out = out[..., lo - h0 * dv:hi - h0 * dv] @ wo["w"].to(out.dtype)
    return tw.close(out, H * dv), cache
