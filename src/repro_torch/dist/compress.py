"""Compressed gradient all-reduce: int8 reduce-scatter + all-gather with
error feedback. Twin of ``repro.dist.compress``.

``compressed_psum`` replaces an all-reduce of large f32 gradients with two
int8 exchange stages, cutting collective bytes ~4x:

1. the error-compensated gradient (``g + err``) splits into one chunk per
   rank, each quantized to int8 with a per-chunk f32 scale; chunks
   exchange (``all_to_all_single``, the reduce-scatter) and every rank
   dequantizes and accumulates its owned chunk in f32;
2. the reduced chunk re-quantizes once and all-gathers back.

The local quantization residual from stage 1 is returned as the new
error-feedback state. The arithmetic is the reference's as XLA compiles
it: the scale ``max(amax, 1e-12) / 127`` (a product with the f32
reciprocal), ``torch.round`` rounding half to even as ``jnp.round`` does,
the clip to +-127, and the residual ``v - q * scale`` rounded once (a
fused multiply-add); so the int8 payloads, the scales and the residual
equal the reference's bit for bit, and the sum differs only in the order
of its n f32 terms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .comm import Axis, all_gather, all_to_all


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rowwise symmetric int8: returns (q int8, scale f32 keepdims).

    The scale is the reference's ``max(amax, 1e-12) / 127`` as XLA
    compiles it: the division by the constant becomes a product with its
    f32 reciprocal (1 ulp off the quotient on some rows)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = amax.clamp_min(1e-12) * inv
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh,
                    axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 RS+AG all-reduce of the rank-local ``g`` over ``axis`` of
    ``mesh`` with error-feedback state ``err`` (same shape as ``g``; start
    with zeros).

    Returns ``(sum_approx, new_err)``: ``sum_approx`` ~ the sum of ``g``
    over the axis, the same on every rank; ``new_err`` this rank's stage-1
    quantization residual, to feed into the next call."""
    ax = Axis(mesh, axis)
    n = ax.n
    flat = (g + err).float().reshape(-1)
    length = flat.shape[0]
    v = F.pad(flat, (0, (-length) % n))
    chunks = v.reshape(n, v.shape[0] // n)  # chunk j is owned by rank j

    q, scale = _quantize_int8(chunks)
    # v - q * scale with one rounding: the reference's compiled residual
    # (XLA contracts it into a fused multiply-add). The product of an int8
    # and an f32 is exact in f64, and so is the difference: |v - q*scale|
    # <= scale / 2 spans at most 31 bits
    new_err = (chunks.double() - q.double() * scale.double()).float()
    new_err = new_err.reshape(-1)[:length].reshape(g.shape).to(g.dtype)

    # reduce-scatter: every rank collects the int8 chunks addressed to it
    # (one per peer), dequantizes with the matching scales, sums in f32
    qt = all_to_all(ax, q)
    st = all_to_all(ax, scale)
    owned = torch.sum(qt.float() * st, dim=0)

    # all-gather the re-quantized reduced chunks
    q2, s2 = _quantize_int8(owned[None])
    allq = all_gather(ax, q2[0])
    alls = all_gather(ax, s2[0, 0])
    total = (allq.float() * alls[:, None]).reshape(-1)[:length]
    return total.reshape(g.shape).to(g.dtype), new_err
