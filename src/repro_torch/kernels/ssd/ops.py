"""SSD scan through the intra-chunk kernel plus the inter-chunk recurrence
in PyTorch. Twin of ``repro.kernels.ssd.ops.ssd_scan_pallas``: a drop-in
for ``models.ssm.ssd_scan`` (same signature subset), which the port's
``ssd_block_apply`` calls on the card.

``ssd_scan_kernel`` and ``ssd_intra_chunk`` take ``device=`` (default the
card; a missing card raises) and move their inputs there. CUDA tensors
launch the kernel or raise; CPU tensors run ``ref.ssd_intra_chunk_ref``.
Nothing falls back. The kernel has no backward yet: on the card a call
under grad, with an input that requires grad, raises (the ctypes launch
would cut the autograd graph without a word); on the CPU the plain
version is differentiable and trains.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .ref import MIN_LOG, pad_to_chunks, ssd_intra_chunk_ref
from .ssd import ssd_intra_chunk_cuda


def ssd_intra_chunk(x, dt, A, Bm, Cm, chunk: int, *,
                    device: torch.device | str = "cuda"):
    """The intra-chunk outputs ``(y, sc, dec, cum)`` of ``ref.py``'s
    contract, by device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise NotImplementedError(
            "the SSD intra-chunk kernel has no backward yet: training an SSD "
            "layer (mamba2, hymba) on the card waits for ROADMAP queue 1 "
            "item 6 step 5 (the SSD backward kernel)")
    x, dt, A, Bm, Cm = (t.to(dev) for t in (x, dt, A, Bm, Cm))
    if dev.type == "cuda":
        return ssd_intra_chunk_cuda(x, dt.float(), A.float().contiguous(),
                                    Bm, Cm, chunk)
    if dev.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD engine for device {dev}")


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
