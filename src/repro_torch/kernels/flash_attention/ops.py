"""Attention by device: the CUDA kernel on the card, the plain version on
the CPU. Twin of ``repro.kernels.flash_attention.ops`` (model layout
``(B, S, H, D)``); the port's ``gqa_apply`` calls it for prefill.

``flash_attention`` takes ``device=`` (default the card; a missing card
raises) and moves its inputs there. CUDA tensors launch the kernel or
raise; CPU tensors run ``ref.flash_attention_ref``. Nothing falls back.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .flash_attention import flash_attention_cuda
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    dev = resolve_device(device)
    q, k, v = (t.to(dev) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if dev.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    raise ValueError(f"no attention engine for device {dev}")
