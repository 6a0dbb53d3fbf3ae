"""Plain PyTorch SSD intra-chunk pass: the CPU path and the CUDA kernel's
oracle.

The chunked form of the reference kernel ``repro.kernels.ssd.ssd._kernel``,
batched over (batch, chunk, head) and read from the model layout: x
``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)``, Bm and Cm ``(B, S, G, N)``,
head ``h`` in group ``h // (H / G)``. The sequence is zero-padded to whole
chunks of length L (``dt = 0`` makes padded steps identity steps). Per
chunk, in f32:

    cum     = cumsum(dt * A)                                      (L,)
    y_intra = (tril(exp(max(cum_i - cum_j, -30))) * C B^T * dt_j) X  (L, P)
    sc      = sum_j exp(max(cum_L - cum_j, -30)) dt_j B_j x_j^T      (N, P)
    dec     = exp(max(cum_L, -30))

Outputs: y ``(B, nc*L, H, P)``, sc ``(B, nc, H, N, P)``, dec ``(B, nc, H)``,
cum ``(B, nc, L, H)``, all f32.

``ssd_intra_chunk_bwd_ref`` is the pass's backward in closed form (the CPU
path of ``ops.SsdIntraChunk`` and the backward kernel's oracle). Per
chunk, with ``E_ij = exp(max(cum_i - cum_j, -30))`` on j <= i (the masked
triangle is never exponentiated, so steep decays give no 0 * inf),
``M_ij = E_ij (C_i . B_j) dt_j``, ``e_j = exp(max(cum_L - cum_j, -30))``
and ``w_j = e_j dt_j``, and the cotangents dy, dsc, ddec, dcum:

    dM_ij  = dy_i . x_j
    dx_j   = sum_i M_ij dy_i + w_j (B_j dsc)
    G_ij   = dM_ij E_ij dt_j
    dC_i   = sum_j G_ij B_j
    dB_j   = sum_i G_ij C_i + w_j (dsc x_j)
    ddt_j  = sum_i dM_ij E_ij (C_i . B_j) + e_j u_j,  u_j = B_j . (dsc x_j)
    dcum_i += sum_j dM_ij M_ij,  dcum_j -= sum_i dM_ij M_ij   (unclamped
              pairs only: max's gradient is 0 where the clamp holds)
    dcum_j -= u_j w_j,  dcum_L += sum_j u_j w_j + ddec dec  (unclamped)
    dla    = reverse cumsum of dcum;  ddt += A dla;  dA = sum dt dla

dB and dC are summed over the heads of each group; padded steps write no
gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MIN_LOG = -30.0


def pad_to_chunks(t: torch.Tensor, L: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) to a multiple of ``L``."""
    pad = (-t.shape[1]) % L
    if not pad:
        return t
    spec = [0, 0] * (t.dim() - 2) + [0, pad]
    return F.pad(t, spec)


def ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk: int):
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = chunk
    x, dt, Bm, Cm = (pad_to_chunks(t, L) for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // L
    xf = x.float().reshape(B_, nc, L, G, hpg, P)
    dtf = dt.float().reshape(B_, nc, L, H)
    Bf = Bm.float().reshape(B_, nc, L, G, N)
    Cf = Cm.float().reshape(B_, nc, L, G, N)

    cum = torch.cumsum(dtf * A.float(), dim=2)  # (B, nc, L, H)
    cb = torch.einsum("bclgn,bckgn->bcglk", Cf, Bf)  # (B, nc, G, L, L)
    ci = cum.permute(0, 1, 3, 2)  # (B, nc, H, L)
    dmat = ci[..., :, None] - ci[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    m = torch.where(tri, torch.exp(torch.clamp(dmat, min=MIN_LOG)), 0.0)
    m = m.reshape(B_, nc, G, hpg, L, L) * cb[:, :, :, None]
    m = m * dtf.permute(0, 1, 3, 2).reshape(B_, nc, G, hpg, 1, L)
    y = torch.einsum("bcgkij,bcjgkp->bcigkp", m, xf)
    y = y.reshape(B_, nc * L, H, P)

    tail = torch.exp(torch.clamp(cum[:, :, -1:] - cum, min=MIN_LOG)) * dtf
    sc = torch.einsum("bclgn,bclgk,bclgkp->bcgknp", Bf,
                      tail.reshape(B_, nc, L, G, hpg), xf)
    sc = sc.reshape(B_, nc, H, N, P)
    dec = torch.exp(torch.clamp(cum[:, :, -1], min=MIN_LOG))  # (B, nc, H)
    return y, sc, dec, cum


def ssd_intra_chunk_bwd_ref(x, dt, A, Bm, Cm, cum, dy, dsc, ddec, dcum,
                            chunk: int):
    """The gradients ``(dx (B, S, H, P), ddt (B, S, H), dA (H,), dBm
    (B, S, G, N), dCm (B, S, G, N))``, all f32, of ``ssd_intra_chunk_ref``
    at the inputs and its output ``cum``, given the cotangents of its four
    outputs (dy ``(B, nc*L, H, P)``, dsc ``(B, nc, H, N, P)``, ddec
    ``(B, nc, H)``, dcum ``(B, nc, L, H)``)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = chunk
    x, dt, Bm, Cm = (pad_to_chunks(t, L) for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // L
    xf = x.float().reshape(B_, nc, L, H, P)
    dtf = dt.float().reshape(B_, nc, L, H)
    Bh = Bm.float().reshape(B_, nc, L, G, 1, N).expand(
        B_, nc, L, G, hpg, N).reshape(B_, nc, L, H, N)
    Ch = Cm.float().reshape(B_, nc, L, G, 1, N).expand(
        B_, nc, L, G, hpg, N).reshape(B_, nc, L, H, N)
    dyf = dy.float().reshape(B_, nc, L, H, P)
    dscf = dsc.float()
    cum = cum.float()

    # the recomputed terms, (B, nc, H, L_i, L_j)
    ci = cum.permute(0, 1, 3, 2)
    dmat = ci[..., :, None] - ci[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    E = torch.where(tri, torch.exp(torch.clamp(
        dmat.masked_fill(~tri, MIN_LOG), min=MIN_LOG)), 0.0)
    live = tri & (dmat >= MIN_LOG)
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    dtj = dtf.permute(0, 1, 3, 2)[..., None, :]
    M = E * cb * dtj
    dM = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    G_ = dM * E * dtj

    # the state's terms
    cum_last = cum[:, :, -1:]
    delta = cum_last - cum  # <= 0
    e = torch.exp(torch.clamp(delta, min=MIN_LOG))
    w = e * dtf
    bd = torch.einsum("bcjhn,bchnp->bcjhp", Bh, dscf)
    xd = torch.einsum("bcjhp,bchnp->bcjhn", xf, dscf)
    u = (Bh * xd).sum(-1)  # (B, nc, L, H)

    dx = torch.einsum("bchij,bcihp->bcjhp", M, dyf) + w[..., None] * bd
    dCh = torch.einsum("bchij,bcjhn->bcihn", G_, Bh)
    dBh = torch.einsum("bchij,bcihn->bcjhn", G_, Ch) + w[..., None] * xd
    ddt = (dM * E * cb).sum(-2).permute(0, 1, 3, 2) + e * u

    q = torch.where(live, dM * M, 0.0)
    uw = torch.where(delta >= MIN_LOG, u * w, 0.0)
    d_cum = (dcum.float() + q.sum(-1).permute(0, 1, 3, 2)
             - q.sum(-2).permute(0, 1, 3, 2) - uw)
    dec = torch.exp(torch.clamp(cum_last[:, :, 0], min=MIN_LOG))
    d_last = uw.sum(2) + torch.where(cum_last[:, :, 0] >= MIN_LOG,
                                     ddec.float() * dec, 0.0)
    d_cum = torch.cat([d_cum[:, :, :-1], d_cum[:, :, -1:] + d_last[:, :, None]],
                      dim=2)
    dla = d_cum.flip(2).cumsum(2).flip(2)
    ddt = ddt + A.float() * dla
    dA = (dtf * dla).sum((0, 1, 2))

    def unpad(t):
        return t.reshape(B_, nc * L, *t.shape[3:])[:, :S]

    group = lambda t: unpad(t).reshape(B_, S, G, hpg, N).sum(3)
    return unpad(dx), unpad(ddt), dA, group(dBh), group(dCh)
