"""Decoder blocks for training and serving. Twin of ``repro.models.blocks``.

Kinds: ``attn_dense`` (GQA + dense MLP), ``attn_moe`` (GQA + MoE FFN),
``mla_dense`` and ``mla_moe`` (MLA + dense MLP or MoE FFN), ``ssd``
(Mamba-2, no FFN), ``hymba_g`` and ``hymba_w`` (global or sliding-window
GQA in parallel with SSD heads, then an MLP).

Each kind has init (one layer's ``(params, specs)``; ``models.model``
stacks a group) / apply
(training: ``(x, aux)``, the MoE load-balance loss or 0, no cache) /
prefill (``(x, cache)``) / init_cache / decode. The reference's
``block_apply`` returns ``(x, aux, cache)`` and builds the cache under
``collect_cache``; the port splits the two uses. Serving on a mesh
(``shardctx.serving_on``) keeps each cache's ``CACHE_RULES`` block: the
prefill's k/v (MLA's latent) of every head are laid out as in one process
(ring-truncated, grown to ``cache_len``) and cut to the rank's block of
the sequence (``TensorParallel.seq_block``) before they are quantized.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import (
    gqa_apply,
    gqa_decode,
    gqa_init,
    gqa_init_cache,
    latent_cache_dtype,
    mla_apply,
    mla_decode,
    mla_init,
    mla_init_cache,
    quantize_kv,
)
from .config import ArchConfig, RunConfig
from .layers import (
    Params, Specs, mlp_apply, mlp_init, norm_apply, norm_init, split,
)
from .moe import moe_apply_dense, moe_init
from .ssm import ssd_block_apply, ssd_block_decode, ssd_init, ssd_init_cache
from ..shardctx import tensor_parallel

KINDS = ("attn_dense", "attn_moe", "mla_dense", "mla_moe", "ssd", "hymba_g",
         "hymba_w")
_ATTN = ("attn_dense", "attn_moe")
_MLA = ("mla_dense", "mla_moe")


def _window(kind: str, cfg: ArchConfig) -> int | None:
    return cfg.window if kind.endswith("_w") else None


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


def _moe_ffn(pf: Params, xn: torch.Tensor, cfg: ArchConfig,
             run: RunConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: ``(y, aux)``. ``moe_impl="ep"`` runs expert
    parallelism (``dist.ep``, DPM-scheduled all-to-all rounds) when
    ``shardctx`` holds a mesh whose ``model`` axis divides the experts, as
    the reference does; otherwise, and for ``"dense"``, the dense path
    (which trains and serves on a mesh's ranks, ``models.moe``). Serving on
    the rank's blocks (``serving_on``) runs ``dist.ep`` on the rank's rows
    and experts (``_moe_ep_blocks``)."""
    from ..shardctx import serving_on_mesh, training_on_mesh

    if run.moe_impl == "ep" and serving_on_mesh():
        return _moe_ep_blocks(pf, xn, cfg)
    if run.moe_impl == "ep" and not training_on_mesh():
        from ..dist.comm import axis_size
        from ..dist.ep import moe_apply_ep
        from ..shardctx import _CTX

        mesh = _CTX["mesh"]
        if (mesh is not None
                and cfg.moe.n_experts % axis_size(mesh, "model") == 0):
            data_axes = tuple(
                a for a in ("pod", "data") if a in mesh.mesh_dim_names
            )
            return moe_apply_ep(pf, xn, cfg, mesh, data_axes=data_axes)
    return moe_apply_dense(pf, xn, cfg)


def _moe_ep_blocks(pf: Params, xn: torch.Tensor, cfg: ArchConfig):
    """``dist.ep`` under serving on the rank's blocks: the rank's rows
    (split over the data axes already) shard again over ``model``, the
    rank's experts are its block of them, and the router and the shared
    experts, which tensor parallelism splits, are gathered whole. Where
    that does not compose (``model`` of one rank, experts or tokens it
    does not divide), raises: ``dist.ep``'s dense path needs every
    expert on every rank."""
    from ..dist.ep import moe_apply_ep
    from ..shardctx import _CTX

    tp = tensor_parallel()
    E, T = cfg.moe.n_experts, xn.shape[0] * xn.shape[1]
    if tp.m <= 1 or E % tp.m or T % tp.m:
        raise NotImplementedError(
            f"moe_impl='ep' on the rank's blocks needs a 'model' axis of "
            f"more than one rank that divides the {E} experts and this "
            f"rank's {T} tokens (model axis: {tp.m} ranks); serve with "
            "moe_impl='dense'")
    whole = {"router": {"w": tp.cat(pf["router"]["w"], 1)}}
    if cfg.moe.n_shared:
        fs = cfg.moe.n_shared * cfg.moe.d_expert
        for n, dim in (("shared_wi", 1), ("shared_wg", 1), ("shared_wo", 0)):
            whole[n] = tp.cat(pf[n], dim) if tp.split(fs) else pf[n]
    return moe_apply_ep(dict(pf, **whole), xn, cfg, _CTX["mesh"],
                        data_axes=())


def _ffn(kind: str, pf: Params, xn: torch.Tensor, cfg: ArchConfig,
         run: RunConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFN sublayer: ``(y, aux)``, aux the MoE load-balance loss, a
    zero f32 scalar for a dense MLP."""
    if kind.endswith("_moe"):
        return _moe_ffn(pf, xn, cfg, run)
    return (mlp_apply(pf, xn, cfg.mlp, _dense_d_ff(cfg)),
            torch.zeros((), dtype=torch.float32, device=xn.device))


# ---------------------------------------------------------------- init
def block_init(kind: str, gen, cfg: ArchConfig,
               device: torch.device) -> tuple[Params, Specs]:
    """``(params, specs)`` of one layer of ``kind``."""
    _check_kind(kind)
    parts = {"norm1": norm_init(cfg.d_model, device, cfg.norm)}
    if kind in _ATTN:
        parts["attn"] = gqa_init(gen, cfg, device)
    elif kind in _MLA:
        parts["attn"] = mla_init(gen, cfg, device)
    elif kind == "ssd":
        parts["ssd"] = ssd_init(gen, cfg, device)
        return split(parts)  # mamba2 block has no FFN sublayer
    else:  # hymba
        parts["attn"] = gqa_init(gen, cfg, device)
        parts["ssd"] = ssd_init(gen, cfg, device)
        parts["bnorm_a"] = norm_init(cfg.d_model, device)
        parts["bnorm_s"] = norm_init(cfg.d_model, device)
    parts["norm2"] = norm_init(cfg.d_model, device, cfg.norm)
    if kind.endswith("_moe"):
        parts["ffn"] = moe_init(gen, cfg, device)
    else:
        parts["ffn"] = mlp_init(gen, cfg, device, _dense_d_ff(cfg))
    return split(parts)


def _dense_d_ff(cfg: ArchConfig) -> int:
    """The hidden width of a dense MLP layer (a MoE model's may differ)."""
    return cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff


# ---------------------------------------------------------------- prefill
def _grow(t: torch.Tensor, length: int) -> torch.Tensor:
    """``t`` zero-padded along dim 1 (the sequence) to ``length``."""
    pad = [0, 0] * (t.dim() - 2) + [0, length - t.shape[1]]
    return F.pad(t, pad)


def _kv_to_cache(k, v, run: RunConfig, window: int | None, cache_len=None):
    """Full-sequence K/V -> decode cache layout (ring-truncated for SWA,
    zero-padded to ``cache_len`` capacity for cache growth during decode),
    on a mesh the rank's block of the sequence, then quantized under an
    int8 cache."""
    if window:
        S = k.shape[1]
        if S >= window:
            # keep the last `window` tokens; position p lands at ring slot
            # p % window (the layout gqa_decode continues to write)
            k, v = k[:, -window:], v[:, -window:]
            shift = S % window
            if shift:
                k = torch.roll(k, shift, dims=1)
                v = torch.roll(v, shift, dims=1)
        else:
            k, v = _grow(k, window), _grow(v, window)
    elif cache_len is not None and cache_len > k.shape[1]:
        k, v = _grow(k, cache_len), _grow(v, cache_len)
    tp = tensor_parallel()
    k, v = tp.seq_block(k), tp.seq_block(v)
    if run.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    dt = getattr(torch, run.kv_cache_dtype)
    return {"k": k.to(dt), "v": v.to(dt)}


def _mixer_apply(kind, p, xn, cfg, run, positions, collect_cache,
                 cache_len=None):
    """The token-mixing sublayer. Returns (out, cache), the cache None
    unless ``collect_cache``."""
    kv = dict(return_kv=collect_cache)
    if kind in _ATTN:
        out = gqa_apply(p["attn"], xn, cfg, run, positions, **kv)
        if not collect_cache:
            return out, None
        out, (k, v) = out
        return out, _kv_to_cache(k, v, run, None, cache_len)
    if kind in _MLA:
        out = mla_apply(p["attn"], xn, cfg, run, positions, **kv)
        if not collect_cache:
            return out, None
        out, (ckv, krope) = out
        if cache_len is not None and cache_len > ckv.shape[1]:
            ckv, krope = _grow(ckv, cache_len), _grow(krope, cache_len)
        tp = tensor_parallel()
        ckv, krope = tp.seq_block(ckv), tp.seq_block(krope)
        dt = latent_cache_dtype(run)
        return out, {"ckv": ckv.to(dt), "krope": krope.to(dt)}
    ssd_kw = dict(return_state=collect_cache, chunk=run.ssd_chunk,
                  stream_bf16=run.ssd_stream_bf16)
    if kind == "ssd":
        out = ssd_block_apply(p["ssd"], xn, cfg, **ssd_kw)
        return out if collect_cache else (out, None)
    w = _window(kind, cfg)
    a = gqa_apply(p["attn"], xn, cfg, run, positions, window=w, **kv)
    s = ssd_block_apply(p["ssd"], xn, cfg, **ssd_kw)
    cache = None
    if collect_cache:
        (a, (k, v)), (s, st) = a, s
        cache = {"attn": _kv_to_cache(k, v, run, w, cache_len), "ssm": st}
    out = 0.5 * (norm_apply(p["bnorm_a"], a) + norm_apply(p["bnorm_s"], s))
    return out, cache


def _block(kind, p, x, cfg, run, positions, collect_cache, cache_len=None):
    """One layer: (x_out, aux, cache|None), the reference's
    ``block_apply``."""
    _check_kind(kind)
    mix, cache = _mixer_apply(
        kind, p,
        norm_apply(p["norm1"], x, stats_only_f32=run.norm_stats_only_f32),
        cfg, run, positions, collect_cache, cache_len,
    )
    x = x + mix
    if kind == "ssd":
        return x, torch.zeros((), dtype=torch.float32, device=x.device), cache
    xn = norm_apply(p["norm2"], x, stats_only_f32=run.norm_stats_only_f32)
    y, aux = _ffn(kind, p["ffn"], xn, cfg, run)
    return x + y, aux, cache


def block_apply(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig,
                run: RunConfig, positions: torch.Tensor):
    """One layer's training forward. Returns (x_out, aux): aux the MoE
    load-balance loss (f32 scalar), 0 for the other kinds."""
    x, aux, _ = _block(kind, p, x, cfg, run, positions, False)
    return x, aux


def block_prefill(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig,
                  run: RunConfig, positions: torch.Tensor,
                  cache_len: int | None = None):
    """One layer's prefill. Returns (x_out, cache)."""
    x, _, cache = _block(kind, p, x, cfg, run, positions, True, cache_len)
    return x, cache


# ---------------------------------------------------------------- decode
def block_init_cache(kind: str, cfg: ArchConfig, run: RunConfig, batch: int,
                     max_len: int, device: torch.device) -> dict:
    _check_kind(kind)
    if kind in _ATTN:
        return gqa_init_cache(cfg, run, batch, max_len, None, device)
    if kind in _MLA:
        return mla_init_cache(cfg, run, batch, max_len, device)
    if kind == "ssd":
        return ssd_init_cache(cfg, batch, device)
    return {
        "attn": gqa_init_cache(cfg, run, batch, max_len, _window(kind, cfg),
                               device),
        "ssm": ssd_init_cache(cfg, batch, device),
    }


def block_decode(kind: str, p: Params, cache: dict, x: torch.Tensor,
                 cfg: ArchConfig, run: RunConfig, pos: int):
    """One layer's decode step. Returns (x_out, new_cache); the KV cache
    tensors are written in place."""
    _check_kind(kind)
    xn = norm_apply(p["norm1"], x)
    if kind in _ATTN:
        mix, cache = gqa_decode(p["attn"], cache, xn, cfg, run, pos)
    elif kind in _MLA:
        mix, cache = mla_decode(p["attn"], cache, xn, cfg, run, pos)
    elif kind == "ssd":
        mix, cache = ssd_block_decode(p["ssd"], cache, xn, cfg)
    else:  # hymba
        a, ac = gqa_decode(p["attn"], cache["attn"], xn, cfg, run, pos,
                           window=_window(kind, cfg))
        s, sc = ssd_block_decode(p["ssd"], cache["ssm"], xn, cfg)
        mix = 0.5 * (norm_apply(p["bnorm_a"], a) + norm_apply(p["bnorm_s"], s))
        cache = {"attn": ac, "ssm": sc}
    x = x + mix
    if kind == "ssd":
        return x, cache
    xn = norm_apply(p["norm2"], x)
    return x + _ffn(kind, p["ffn"], xn, cfg, run)[0], cache
