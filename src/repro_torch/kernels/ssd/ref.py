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
