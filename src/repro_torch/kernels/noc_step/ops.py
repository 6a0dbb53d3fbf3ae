"""Segmented minimum and winner masks by device: the CUDA kernels on the
card, the plain version on the CPU. Twin of ``repro.kernels.noc_step.ops``.

``arbitrate`` turns a (mask, key, resource-id) candidate set into the winner
mask of one arbitration round: per resource, the admissible candidate with
the smallest age key wins (keys are unique, so at most one winner per
resource). Both entry points take ``device=`` (default the card; a missing
card raises) and move their inputs there, flat, as int32 (bool for the
mask); inputs that already are so pass untouched. CUDA tensors launch the
kernels' default route, ``grid``, or raise (``arbitrate`` with its winner
test fused into the kernel); CPU tensors run
``ref.segmented_min_ref`` and, for ``arbitrate``, the torch winner test, the
kernels' oracle. There is no ``backend=``: the device picks the engine. The
reference's dense broadcast branch for small inputs (``_DENSE_CELLS``) only
beat XLA:CPU's scatter and gives the same bits, so it has no twin here.
"""
from __future__ import annotations

import torch

from ...device import resolve_device
from .noc_step import NOC_INF, arbitrate_kernel, segmented_min
from .ref import segmented_min_ref


def _device(device) -> torch.device:
    """The entry point's device, a CUDA one with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _flat(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a contiguous 1-D ``dtype`` tensor on ``dev``."""
    if (isinstance(x, torch.Tensor) and x.dtype == dtype and x.dim() == 1
            and x.device == dev and x.is_contiguous()):
        return x
    return torch.as_tensor(x).reshape(-1).to(dev, dtype).contiguous()


def segmin(
    keys: torch.Tensor,  # (...,) int32; NOC_INF = no candidate
    segs: torch.Tensor,  # (...,) int32 resource ids in [0, num_segments)
    num_segments: int,
    *,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Per-resource minimum key, (num_segments,); NOC_INF where empty."""
    dev = _device(device)
    flat_k = _flat(keys, dev, torch.int32)
    flat_s = _flat(segs, dev, torch.int32)
    if dev.type == "cuda":
        return segmented_min(flat_k, flat_s, num_segments)
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
    dev = _device(device)
    shape = adm.shape if hasattr(adm, "shape") else torch.as_tensor(adm).shape
    adm = _flat(adm, dev, torch.bool)
    keys = _flat(keys, dev, torch.int32)
    segs = _flat(segs, dev, torch.int32)
    if dev.type == "cuda":
        return arbitrate_kernel(adm, keys, segs, num_segments).reshape(shape)
    if dev.type != "cpu":
        raise ValueError(f"no segmented-min engine for device {dev}")
    mkeys = torch.where(adm, keys, NOC_INF).to(torch.int32)
    seg_min = segmented_min_ref(mkeys, segs, num_segments)
    won = mkeys == seg_min[segs.to(torch.int64).clamp(0, num_segments - 1)]
    return (adm & won & (mkeys < NOC_INF)).reshape(shape)
