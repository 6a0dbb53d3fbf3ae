"""Rotary position embeddings: standard RoPE, Qwen2-VL M-RoPE, sinusoidal.
Twin of ``repro.models.rope``."""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    return _rotate(x, ang)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,  # (..., S, 3) — temporal, height, width ids
    theta: float,
    sections: tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: frequency bands split across (t, h, w) ids.

    ``sections`` are in D/2 units. For pure-text positions the three ids
    coincide and M-RoPE == RoPE.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=sum(sections))[: d // 2]
    pos = positions.float()[..., sec_ids]  # (..., S, D/2): per-band id
    return _rotate(x, pos * freqs)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., S) -> (..., S, d) classic transformer sinusoidal embedding."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
