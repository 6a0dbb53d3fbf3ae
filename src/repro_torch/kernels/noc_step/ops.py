"""Segmented minimum and winner masks by device: the CUDA kernel on the
card, the plain version on the CPU. Twin of ``repro.kernels.noc_step.ops``.

``arbitrate`` turns a (mask, key, resource-id) candidate set into the winner
mask of one arbitration round: per resource, the admissible candidate with
the smallest age key wins (keys are unique, so at most one winner per
resource). Both entry points take ``device=`` (default the card; a missing
card raises) and move their inputs there; CUDA tensors launch the kernel or
raise, CPU tensors run ``ref.segmented_min_ref``. There is no ``backend=``:
the device picks the engine. The reference's dense broadcast branch for
small inputs (``_DENSE_CELLS``) only beat XLA:CPU's scatter and gives the
same bits, so it has no twin here.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .noc_step import NOC_INF, segmented_min
from .ref import segmented_min_ref


def segmin(
    keys: torch.Tensor,  # (...,) int32; NOC_INF = no candidate
    segs: torch.Tensor,  # (...,) int32 resource ids in [0, num_segments)
    num_segments: int,
    *,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Per-resource minimum key, (num_segments,); NOC_INF where empty."""
    dev = resolve_device(device)
    flat_k = torch.as_tensor(keys).reshape(-1).to(dev, torch.int32)
    flat_s = torch.as_tensor(segs).reshape(-1).to(dev, torch.int32)
    if dev.type == "cuda":
        return segmented_min(flat_k.contiguous(), flat_s.contiguous(),
                             num_segments)
    if dev.type == "cpu":
        return segmented_min_ref(flat_k, flat_s, num_segments)
    raise ValueError(f"no segmented-min engine for device {dev}")


def arbitrate(
    adm: torch.Tensor,  # (...,) bool — admissible candidates
    keys: torch.Tensor,  # (...,) int32 age keys, unique among admissible
    segs: torch.Tensor,  # (...,) int32 resource ids in [0, num_segments)
    num_segments: int,
    *,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Winner mask, same shape as ``adm`` (one winner max per resource)."""
    dev = resolve_device(device)
    adm = torch.as_tensor(adm).to(dev, torch.bool)
    keys = torch.as_tensor(keys).to(dev, torch.int32)
    segs = torch.as_tensor(segs).to(dev, torch.int32)
    mkeys = torch.where(adm, keys, NOC_INF).to(torch.int32)
    seg_min = segmin(mkeys, segs, num_segments, device=dev)
    won = mkeys == seg_min[segs.to(torch.int64).clamp(0, num_segments - 1)]
    return adm & won & (mkeys < NOC_INF)
