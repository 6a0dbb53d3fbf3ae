"""Plain PyTorch segmented minimum: the CPU engine and the kernel's oracle
on the card. Twin of ``repro.kernels.noc_step.ref`` (same contract)."""
from __future__ import annotations

import torch

from .noc_step import NOC_INF


def segmented_min_ref(
    keys: torch.Tensor, segs: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-resource minimum key by scatter-min; NOC_INF where no candidate.

    Out-of-range segment ids (the stepper's padding) are clamped into
    ``[0, num_segments)``, harmless because the padding convention gives
    them NOC_INF keys. Starting from NOC_INF (``include_self``) caps every
    result at NOC_INF, as the reference's final ``minimum`` does.
    """
    keys = keys.to(torch.int32)
    out = torch.full((num_segments,), NOC_INF, dtype=torch.int32,
                     device=keys.device)
    if num_segments == 0:
        return out
    segs = segs.to(torch.int64).clamp(0, num_segments - 1)
    return out.scatter_reduce_(0, segs, keys, "amin", include_self=True)
