"""SSD scan through the intra-chunk kernel plus the inter-chunk recurrence
in PyTorch, forward and backward. Twin of ``repro.kernels.ssd.ops.
ssd_scan_pallas``: a drop-in for ``models.ssm.ssd_scan`` (same signature
subset), which the port's ``ssd_block_apply`` calls on the card; for the
gradient, the twin of autodiff of the reference's jnp ``ssd_scan``.

``ssd_scan_kernel`` and ``ssd_intra_chunk`` take ``device=`` (default the
card; a missing card raises) and move their inputs there. With grad off,
or no input that requires grad, the intra-chunk pass runs its forward
alone (serving): CUDA tensors launch the kernel or raise, CPU tensors run
``ref.ssd_intra_chunk_ref``. Otherwise it goes through the autograd
Function ``SsdIntraChunk`` on both devices: on the card the forward kernel
and the backward kernel (``csrc/ssd_bwd.cu``), on the CPU
``ref.ssd_intra_chunk_ref`` and ``ref.ssd_intra_chunk_bwd_ref``. The
inter-chunk recurrence stays under autograd, so ``sc``, ``dec`` and
``cum`` take their cotangents from it and from ``y_inter``. Nothing falls
back.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .ref import (
    MIN_LOG, pad_to_chunks, ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref,
)
from .ssd import ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda


class SsdIntraChunk(torch.autograd.Function):
    """The intra-chunk pass whose backward recomputes ``C B^T``, the decay
    and ``dY X^T`` from the saved inputs and ``cum``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        fwd = ssd_intra_chunk_cuda if x.is_cuda else ssd_intra_chunk_ref
        y, sc, dec, cum = fwd(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, cum)
        ctx.chunk = chunk
        return y, sc, dec, cum

    @staticmethod
    def backward(ctx, dy, dsc, ddec, dcum):
        x, dt, A, Bm, Cm, cum = ctx.saved_tensors
        bwd = ssd_intra_chunk_bwd_cuda if x.is_cuda else ssd_intra_chunk_bwd_ref
        grads = bwd(x, dt, A, Bm, Cm, cum, dy, dsc, ddec, dcum, ctx.chunk)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, Cm))
                     ) + (None,)


def ssd_intra_chunk(x, dt, A, Bm, Cm, chunk: int, *,
                    device: torch.device | str = "cuda"):
    """The intra-chunk outputs ``(y, sc, dec, cum)`` of ``ref.py``'s
    contract, by device; through ``SsdIntraChunk`` when grad is on and an
    input requires it."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no SSD engine for device {dev}")
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bm, Cm))
    x, dt, A, Bm, Cm = (t.to(dev) for t in (x, dt, A, Bm, Cm))
    if dev.type == "cuda":
        dt, A = dt.float(), A.float().contiguous()
    if grad:
        return SsdIntraChunk.apply(x, dt, A, Bm, Cm, chunk)
    if dev.type == "cuda":
        return ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, chunk)
    return ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk)


def ssd_scan_kernel(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int = 256,
    *,
    device: torch.device | str = "cuda",
):
    """``(y (B, S, H, P) f32, h_last (B, H, N, P) f32)``: one intra-chunk
    launch, then the state carried across chunks."""
    dev = resolve_device(device)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = min(chunk, S)
    y, sc, dec, cum = ssd_intra_chunk(x, dt, A, Bm, Cm, L, device=dev)
    nc = sc.shape[1]

    # inter-chunk recurrence over nc (sequential, small state)
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=dev)
    h_in = torch.empty((B_, nc, H, N, P), dtype=torch.float32, device=dev)
    for c in range(nc):
        h_in[:, c] = h  # the state entering chunk c
        h = h * dec[:, c, :, None, None] + sc[:, c]

    Cf = pad_to_chunks(Cm.to(dev).float(), L).reshape(B_, nc, L, G, N)
    inter_decay = torch.exp(torch.clamp(cum, min=MIN_LOG))  # (B, nc, L, H)
    y_inter = torch.einsum("bclgn,bcgknp->bclgkp", Cf,
                           h_in.reshape(B_, nc, G, hpg, N, P))
    y_inter = y_inter.reshape(B_, nc, L, H, P) * inter_decay[..., None]
    y = (y.reshape(B_, nc, L, H, P) + y_inter).reshape(B_, nc * L, H, P)
    return y[:, :S], h
