"""Plain PyTorch attention: the CPU path and the CUDA kernel's oracle.

The math of the reference's oracle ``repro.kernels.flash_attention.ref.
attention_ref`` (f32 scores, masked with the finite ``-1e30``, softmax,
output in ``q.dtype``), in the model layout ``(B, S, H, D)`` that the
kernel takes. GQA reads KV head ``h // G`` through a reshape rather than a
repeat.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Sk: int, *, causal: bool, window: int | None,
                   q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key ``k`` is visible from query ``q_offset + q``."""
    q_pos = q_offset + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,  # (B, Sk, KH, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * D**-0.5
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
