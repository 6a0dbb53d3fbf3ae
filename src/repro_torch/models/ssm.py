"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060). Twin of
``repro.models.ssm``.

``ssd_scan`` is the plain chunked algorithm: within a chunk of length L the
recurrence in its quadratic "attention" dual form, across chunks a loop
carrying the (N x P) state. It is the CPU path and the plain version of
the SSD path, and on the CPU it trains through autograd, as the
reference differentiates its jnp ``ssd_scan``. On the card
``ssd_block_apply`` runs ``kernels.ssd.ops.ssd_scan_kernel`` instead: the
CUDA intra-chunk kernel, then the same inter-chunk recurrence in PyTorch;
under grad the intra-chunk pass is the autograd Function
``SsdIntraChunk``, whose backward is the CUDA kernel of ``csrc/ssd_bwd.cu``
(the recurrence stays under autograd), so hymba and mamba2 train there.

Shapes: batch B, seq S, heads H, head_dim P, groups G, state N.

Under tensor parallelism (``shardctx.tensor_parallel``) the rule splits
``in_proj``'s output, the conv's channels, the per-head leaves and
``norm_scale``, but the z/x/B/C/dt split of ``in_proj``'s output does not
fall on the blocks' edges: each rank gathers ``in_proj``'s output and
those small leaves whole and runs the block's whole scan, and its block of
``out_proj``'s rows takes its columns of the scan's output, the ranks'
partial products summed. Serving on a mesh keeps the rank's block of the
conv cache's channels (``CACHE_RULES``' "mlp") and the whole state: the
prefill returns that block of the conv window, and a decode step gathers
the blocks, runs the whole step and keeps its block of the new window.

``ssd_stream_bf16`` (``stream_bf16`` here) takes the reference's streamed
numerics in ``ssd_scan``: the operands of the intra-chunk products (C, B,
the decay-weighted matrix and x) are rounded to bf16 and the products
accumulate in f32; on the card the kernel runs on x, B and C in bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_scan_kernel
from .config import ArchConfig, SSMConfig
from ..shardctx import tensor_parallel
from .layers import (
    Params, Specs, dense_init, normal, split, tp_project, tree_map,
)

MIN_LOG = -30.0


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  (already softplus'ed)
    A: torch.Tensor,  # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, N, P) initial state
    return_state: bool = False,
    stream_bf16: bool = False,
):
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # dt=0 on padding => decay exp(0)=1 and zero state update: identity
        # steps, so h_last stays exact and padded y rows are sliced off.
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    S_real, S = S, S + pad
    nc = S // L

    xf = x.float().reshape(B_, nc, L, H, P)
    dtf = dt.float().reshape(B_, nc, L, H)
    Bf = Bm.float().reshape(B_, nc, L, G, N)
    Cf = Cm.float().reshape(B_, nc, L, G, N)
    Af = A.float()

    la = dtf * Af  # log-decay per step, negative
    cum = torch.cumsum(la, dim=2)  # within-chunk cumulative log decay

    # broadcast B,C across heads in group: head h uses group h // hpg
    Bh = torch.repeat_interleave(Bf, hpg, dim=3)  # (B, nc, L, H, N)
    Ch = torch.repeat_interleave(Cf, hpg, dim=3)

    # ---- intra-chunk quadratic form ------------------------------------
    # M[i,j] = exp(cum_i - cum_j) * (C_i . B_j) * dt_j   for j <= i
    st = (lambda t: t.to(torch.bfloat16).float()) if stream_bf16 else (
        lambda t: t)
    cb = torch.einsum("bclhn,bckhn->bchlk", st(Ch), st(Bh))  # (B,nc,H,L,L)
    ci = cum.permute(0, 1, 3, 2)  # (B,nc,H,L)
    dmat = ci[..., :, None] - ci[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    m = torch.where(tri, torch.exp(torch.clamp(dmat, min=MIN_LOG)), 0.0)
    m = m * cb * dtf.permute(0, 1, 3, 2)[..., None, :]  # * dt_j
    y_intra = torch.einsum("bchlk,bckhp->bclhp", st(m), st(xf))

    # ---- chunk-boundary states -----------------------------------------
    # state contribution of chunk c: sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    tail = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, min=MIN_LOG))
    sc = torch.einsum("bclh,bclh,bclhn,bclhp->bchnp", tail, dtf, Bh, xf)
    chunk_decay = torch.exp(torch.clamp(cum[:, :, -1, :], min=MIN_LOG))

    h = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state *entering* the chunk
        h = h * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_in = torch.stack(h_in, 1)  # (B,nc,H,N,P)

    # ---- inter-chunk contribution --------------------------------------
    inter_decay = torch.exp(torch.clamp(cum, min=MIN_LOG))  # (B,nc,L,H)
    y_inter = torch.einsum("bclhn,bchnp,bclh->bclhp", Ch, h_in, inter_decay)

    y = (y_intra + y_inter).reshape(B_, S, H, P)
    if pad:
        y = y[:, :S_real]
    if return_state:
        return y, h
    return y


def ssd_reference(x, dt, A, Bm, Cm, h0=None):
    """Naive per-step recurrence (oracle for tests and the kernel)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Bh = torch.repeat_interleave(Bm.float(), hpg, dim=2)
    Ch = torch.repeat_interleave(Cm.float(), hpg, dim=2)
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf * A.float())  # (B,S,H)
    h = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = h * a[:, t][..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t] * dtf[:, t][..., None], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    return torch.stack(ys, 1), h  # (B,S,H,P), final state


# ---------------------------------------------------------------------------
# full Mamba-2 block
# ---------------------------------------------------------------------------
def ssd_init(gen, cfg: ArchConfig,
             device: torch.device) -> tuple[Params, Specs]:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    d_in = 2 * di + 2 * s.n_groups * s.d_state + H
    return split({
        "in_proj": dense_init(gen, d, d_in, "embed", "mlp", device),
        "out_proj": dense_init(gen, di, d, "mlp", "embed", device),
        "conv_w": (normal(gen, (s.d_conv, conv_dim), 0.2, device),
                   ("conv", "mlp")),
        "conv_b": (torch.zeros((conv_dim,), device=device), ("mlp",)),
        "A_log": (torch.log(torch.linspace(1.0, 16.0, H, device=device)),
                  ("heads",)),
        "D": (torch.ones((H,), device=device), ("heads",)),
        "dt_bias": (torch.full((H,), math.log(math.expm1(1e-2)),
                               device=device), ("heads",)),
        "norm_scale": (torch.ones((di,), device=device), ("mlp",)),
    })


def _split_zxbcdt(z_x_b_c_dt, di, gn, H):
    z = z_x_b_c_dt[..., :di]
    x = z_x_b_c_dt[..., di: 2 * di]
    b = z_x_b_c_dt[..., 2 * di: 2 * di + gn]
    c = z_x_b_c_dt[..., 2 * di + gn: 2 * di + 2 * gn]
    dt = z_x_b_c_dt[..., 2 * di + 2 * gn:]
    return z, x, b, c, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv1d. xbc: (B,S,C); w: (K,C). state: (B,K-1,C)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i: i + S, :] * w[i].to(xbc.dtype) for i in range(K))
    out = out + b.to(xbc.dtype)
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return F.silu(out), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + exp(x)), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    ms = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6) * scale).to(y.dtype)


def _whole_block(tp, p: Params, x: torch.Tensor, cfg: ArchConfig):
    """``(in_proj's output, the block's leaves)`` whole on every model
    rank: the split of in_proj's output is not on the blocks' edges, so
    its output and the block's small leaves are gathered whole."""
    s: SSMConfig = cfg.ssm
    d = x.shape[-1]
    di, H = s.d_inner(d), s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    zxbcdt = tp_project(tp, p["in_proj"], tp.enter(x), conv_dim + di + H)
    p = dict(p, conv_w=tp.gather(p["conv_w"], conv_dim, 1), **{
        n: tp.gather(p[n], w, 0) for n, w in (
            ("conv_b", conv_dim), ("A_log", H), ("D", H), ("dt_bias", H),
            ("norm_scale", di))})
    return zxbcdt, p


def _out_proj(tp, p: Params, y: torch.Tensor, di: int) -> torch.Tensor:
    """The rank's rows of out_proj take its columns of ``y``; the ranks'
    partial products summed."""
    lo, hi = tp.block(di)
    w = p["out_proj"] if tp.split(di) else tree_map(tp.enter,
                                                     p["out_proj"])
    return tp.close(y[..., lo:hi] @ w["w"].to(y.dtype), di)


def _ssd_tp(d: int, s: SSMConfig):
    di, H = s.d_inner(d), s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return tensor_parallel().over(conv_dim + di + H, conv_dim, H,
                                  di), conv_dim


def ssd_block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                    return_state: bool = False, chunk: int | None = None,
                    stream_bf16: bool = False):
    s: SSMConfig = cfg.ssm
    B_, S, d = x.shape
    di, H, G, N = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    tp, conv_dim = _ssd_tp(d, s)
    zxbcdt, p = _whole_block(tp, p, x, cfg)
    z, xi, bm, cm, dt = _split_zxbcdt(zxbcdt, di, G * N, H)
    xbc = torch.cat([xi, bm, cm], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xi, bm, cm = (xbc[..., :di], xbc[..., di: di + G * N],
                  xbc[..., di + G * N:])
    dtp = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    args = (xi.reshape(B_, S, H, s.head_dim), dtp, A,
            bm.reshape(B_, S, G, N), cm.reshape(B_, S, G, N),
            chunk or s.chunk)
    if x.device.type == "cuda":
        if stream_bf16:
            args = tuple(t.to(torch.bfloat16) if i in (0, 3, 4) else t
                         for i, t in enumerate(args))
        y, h_last = ssd_scan_kernel(*args, device=x.device)
    else:
        y, h_last = ssd_scan(*args, return_state=True,
                             stream_bf16=stream_bf16)
    y = y + xi.reshape(B_, S, H, s.head_dim) * p["D"][:, None]
    y = y.reshape(B_, S, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    out = _out_proj(tp, p, y, di)
    if return_state:
        # the cache keeps the rank's block of the conv window's channels
        lo, hi = tp.block(conv_dim)
        return out, {"conv": conv_state[..., lo:hi], "state": h_last}
    return out


def ssd_init_cache(cfg: ArchConfig, batch: int, device: torch.device) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di, H, G, N = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    conv_dim = di + 2 * G * N
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
        "state": torch.zeros((batch, H, N, s.head_dim), dtype=torch.float32,
                             device=device),
    }


def ssd_block_decode(p: Params, cache: dict, x: torch.Tensor,
                     cfg: ArchConfig):
    """Single-token recurrent step. x: (B, 1, d). Returns (out, new cache);
    on a mesh the cache's conv window is the rank's block of channels."""
    s: SSMConfig = cfg.ssm
    B_, _, d = x.shape
    di, H, G, N = s.d_inner(d), s.n_heads(d), s.n_groups, s.d_state
    tp, conv_dim = _ssd_tp(d, s)
    zxbcdt, p = _whole_block(tp, p, x, cfg)
    z, xi, bm, cm, dt = _split_zxbcdt(zxbcdt, di, G * N, H)
    xbc = torch.cat([xi, bm, cm], dim=-1)
    window = tp.cat(cache["conv"], 2) if tp.split(conv_dim) else cache["conv"]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], window)
    lo, hi = tp.block(conv_dim)
    conv_state = conv_state[..., lo:hi]
    xi = xbc[..., :di].reshape(B_, H, s.head_dim)
    bm = xbc[..., di: di + G * N].reshape(B_, G, N)
    cm = xbc[..., di + G * N:].reshape(B_, G, N)
    hpg = H // G
    bh = torch.repeat_interleave(bm, hpg, dim=1).float()
    ch = torch.repeat_interleave(cm, hpg, dim=1).float()
    dtp = _softplus(dt.float() + p["dt_bias"])[:, 0]  # (B,H)
    a = torch.exp(dtp * -torch.exp(p["A_log"]))  # (B,H)
    h = cache["state"] * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bh * dtp[..., None], xi.float())
    y = torch.einsum("bhn,bhnp->bhp", ch, h) + xi.float() * p["D"][:, None]
    y = y.reshape(B_, 1, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return _out_proj(tp, p, y, di), {"conv": conv_state, "state": h}
