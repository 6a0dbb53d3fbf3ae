"""Attention by device, forward and backward: the CUDA kernels on the card,
the plain versions on the CPU. Twin of ``repro.kernels.flash_attention.
ops`` (model layout ``(B, S, H, D)``) and, for the gradient, of the
reference's ``chunked_attention`` with its ``jax.custom_vjp``; the port's
``gqa_apply`` and ``mla_apply`` call it for prefill and for training.

``flash_attention`` takes ``device=`` (default the card; a missing card
raises) and moves its inputs there. With grad off, or no input that
requires grad, it runs the forward alone and writes no log-sum-exp
(serving). Otherwise it goes through one ``torch.autograd.Function`` on
both devices, which saves ``q, k, v, out, lse`` and runs the backward from
them: on the card the forward kernel with its LSE output and the backward
kernel, on the CPU ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``. v may have a head dim of its own (MLA: q
and k 192, v 128); the forward and the backward kernels take the same
head-dim pairs (``flash_attention.HEAD_DIM_PAIRS``). CUDA tensors launch
the kernels or raise (a pair outside them raises before anything moves to
the card); nothing falls back. ``stream_bf16`` (``RunConfig.attn_stream_bf16``)
streams the operands in bf16: on the card q, k and v are cast to bf16 and
the bf16 kernels run (the output cast back to q's type, the gradients
back through the cast), on the CPU the plain versions round the products'
operands to bf16 (``ref.py``). On ``meta`` tensors (the dry run,
``launch.dryrun``) the plain versions give the shapes and nothing runs.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .flash_attention import (
    check_pair, flash_attention_bwd_cuda, flash_attention_cuda,
)
from .ref import flash_attention_bwd_ref, flash_attention_ref


class FlashAttention(torch.autograd.Function):
    """Attention whose backward recomputes ``p`` from the saved row
    log-sum-exp, as the reference's ``_flash_bwd_rule`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, stream_bf16=False):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:  # the plain version: the CPU, or meta tensors' shapes
            kw["stream_bf16"] = stream_bf16
            out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D) — model layout
    k: torch.Tensor,  # (B, S, KH, D)
    v: torch.Tensor,  # (B, S, KH, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    stream_bf16: bool = False,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no attention engine for device {dev}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if dev.type == "cuda":
        check_pair(q.shape[-1], v.shape[-1])
    out_dtype = q.dtype
    q, k, v = (t.to(dev) for t in (q, k, v))
    if stream_bf16 and dev.type == "cuda":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if grad:
        out = FlashAttention.apply(q, k, v, causal, window, q_offset,
                                   stream_bf16)
    elif dev.type == "cuda":
        out = flash_attention_cuda(q, k, v, **kw)
    else:
        out = flash_attention_ref(q, k, v, stream_bf16=stream_bf16, **kw)
    return out.to(out_dtype)
