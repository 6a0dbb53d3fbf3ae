"""Plain PyTorch attention, forward and backward: the CPU path and the
CUDA kernels' oracles.

The forward is the math of the reference's oracle ``repro.kernels.
flash_attention.ref.attention_ref`` (f32 scores, masked with the finite
``-1e30``, softmax, output in ``q.dtype``), in the model layout
``(B, S, H, D)`` that the kernel takes; with ``return_lse`` it also returns
the row log-sum-exp of the scaled, masked scores (natural log, f32), as the
reference's ``_flash_fwd_impl`` returns it for its backward. The backward
is the math of the reference's hand-written ``_flash_bwd_impl``
(``repro/models/attention.py``) in one block, without chunks. GQA reads KV
head ``h // G`` through a reshape rather than a repeat, and sums the KV
gradients over the G query heads of each KV head.

``stream_bf16`` (``RunConfig.attn_stream_bf16``) takes the reference's
streamed numerics: the operands of every product (q, k, v, the
unnormalised probabilities; in the backward also dout, out and ds) are
rounded to bf16 and the products accumulate in f32, as
``_flash_fwd_impl``/``_flash_bwd_impl`` do with ``stream_bf16`` (here in
one block of keys: the forward's probabilities are ``exp(s - rowmax)``,
divided by their f32 row sum after the product with v).
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
    return_lse: bool = False,
    stream_bf16: bool = False,
):
    """``(B, Sq, H, D)`` in ``q.dtype``; with ``return_lse`` the pair
    ``(out, lse)``, ``lse`` ``(B, Sq, H)`` f32."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = _operand(q, stream_bf16).reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                     _operand(k, stream_bf16)) * D**-0.5
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    vf = _operand(v, stream_bf16)
    if stream_bf16:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out = torch.einsum("bhgqk,bkhd->bqhgd", _operand(p, True), vf)
        out = out / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    out = out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)  # (B, KH, G, Sq)
    return out, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def _operand(t: torch.Tensor, stream_bf16: bool) -> torch.Tensor:
    """A product's operand in f32: rounded to bf16 first when streamed."""
    return (t.to(torch.bfloat16) if stream_bf16 else t).float()


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,  # (B, Sk, KH, Dv)
    out: torch.Tensor,  # (B, Sq, H, Dv)
    lse: torch.Tensor,  # (B, Sq, H) f32
    dout: torch.Tensor,  # (B, Sq, H, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    stream_bf16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtypes, accumulated in f32:
    ``delta = rowsum(dout * out)``, ``p = exp(min(s - lse, 30))`` masked to
    0, ``dv = p^T dout``, ``ds = p (dout v^T - delta) D^-1/2``,
    ``dq = ds k``, ``dk = ds^T q``."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    st = stream_bf16
    qf = _operand(q, st).reshape(B, Sq, KH, G, D)
    kf, vf = _operand(k, st), _operand(v, st)
    dof = _operand(dout, st).reshape(B, Sq, KH, G, Dv)
    delta = (dof * _operand(out, st).reshape(B, Sq, KH, G, Dv)).sum(-1)
    scale = D**-0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    rows = lambda t: t.reshape(B, Sq, KH, G).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(torch.clamp(s - rows(lse.float()), max=30.0))
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    p = torch.where(mask, p, 0.0)  # (B, KH, G, Sq, Sk)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", _operand(p, st), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = _operand(p * (dp - rows(delta)) * scale, st)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
