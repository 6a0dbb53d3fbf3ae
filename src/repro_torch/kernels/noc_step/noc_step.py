"""Loader and wrapper of the CUDA segmented-min kernel (``csrc/noc_step.cu``).

Replaces the reference's Pallas kernel
``repro.kernels.noc_step.noc_step.segmented_min``: the per-resource minimum
age key of one arbitration round (per-directed-link flit grants, per-node
ejection grants), ``NOC_INF`` where a resource has no candidate. The
library is built at first use (``kernels.build``); ``segmented_min`` takes
CUDA tensors only and raises on anything else, and ``KERNEL.launches``
counts its launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

# Large sentinel: above every real key, far from int32 overflow when compared.
NOC_INF = 2**30

_SRC = Path(__file__).resolve().parent / "csrc" / "noc_step.cu"


class SegmentedMinKernel(CudaLibrary):
    """The built library, its build report and the launch counter."""

    def __init__(self):
        super().__init__("noc_step", _SRC)
        self.launches = 0

    def bind(self, lib: ctypes.CDLL) -> None:
        p = ctypes.c_void_p
        lib.segmented_min_launch.argtypes = [p, p, p, ctypes.c_longlong,
                                             ctypes.c_int, p]
        lib.segmented_min_launch.restype = ctypes.c_int


KERNEL = SegmentedMinKernel()


def segmented_min(
    keys: torch.Tensor,  # (N,) int32 candidate age keys (NOC_INF = none)
    segs: torch.Tensor,  # (N,) int32 resource id per candidate
    num_segments: int,
) -> torch.Tensor:
    """Per-resource minimum key through the CUDA kernel on PyTorch's current
    stream: ``(num_segments,)`` int32, ``NOC_INF`` where a resource has no
    candidate, keys above ``NOC_INF`` capped at it, candidates with a
    segment outside ``[0, num_segments)`` skipped."""
    if keys.device.type != "cuda":
        raise ValueError(f"the segmented-min kernel needs CUDA tensors, "
                         f"got {keys.device}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    (N,) = keys.shape
    check_tensor("keys", keys, torch.int32, (N,), keys.device)
    check_tensor("segs", segs, torch.int32, (N,), keys.device)
    lib = KERNEL.build()
    with torch.cuda.device(keys.device):
        out = torch.empty((num_segments,), dtype=torch.int32,
                          device=keys.device)
        if num_segments == 0:
            return out
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.segmented_min_launch(keys.data_ptr(), segs.data_ptr(),
                                       out.data_ptr(), N, num_segments,
                                       stream)
    if err != 0:
        raise RuntimeError(f"segmented_min kernel launch failed: "
                           f"cudaError {err}")
    KERNEL.launches += 1
    return out
