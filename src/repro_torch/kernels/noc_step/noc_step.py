"""Loader and wrappers of the CUDA segmented-min kernels (``csrc/noc_step.cu``).

Replace the reference's Pallas kernel
``repro.kernels.noc_step.noc_step.segmented_min`` and the winner test of
``repro.kernels.noc_step.ops.arbitrate``: the per-resource minimum age key of
one arbitration round (per-directed-link flit grants, per-node ejection
grants), ``NOC_INF`` where a resource has no candidate, and the round's
winner mask.

Two routes (``VARIANTS``):

* ``"grid"``, the default: one cooperative launch over the whole card: a
  fill, then blocks that gather their chunk of candidates' minima in shared
  memory before the global ``atomicMin`` (and, with the winner test, a last
  pass). ``arbitrate_kernel`` always takes it.
* ``"atomic"``: the first design's fill and one ``atomicMin`` per
  candidate, two launches, kept as the comparison (``variant="atomic"``).

The default is the one-launch route for every shape, chosen for the time of
a call through the wrapper, which host work dominates: one launch in place
of two. On the card alone it is faster than the pair on large rounds (xsim's
32x32 id space, a hot spot) and slower by 1.4-2.1 us on rounds of up to
about 70 K candidates, where the pair's two tiny launches finish sooner
(PERF.md, section 6).

The library is built at first use (``kernels.build``). The wrappers take
CUDA tensors only and raise on anything else. ``KERNEL.launches`` counts
the calls that launched a route's kernels, ``KERNEL.launches_by_route`` the
same by route.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

# Large sentinel: above every real key, far from int32 overflow when compared.
NOC_INF = 2**30

_SRC = Path(__file__).resolve().parent / "csrc" / "noc_step.cu"
VARIANTS = ("grid", "atomic")


class SegmentedMinKernel(CudaLibrary):
    """The built library, its build report and the launch counters."""

    def __init__(self):
        super().__init__("noc_step", _SRC)
        self.launches = 0
        self.launches_by_route = dict.fromkeys(VARIANTS, 0)
        self.atomic_fn = self.grid_fn = None

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.segmented_min_launch.argtypes = [p, p, p, ll, i, p]
        lib.segmented_min_launch.restype = i
        lib.segmin_grid_launch.argtypes = [p, p, p, p, p, ll, i, p]
        lib.segmin_grid_launch.restype = i
        self.atomic_fn = lib.segmented_min_launch
        self.grid_fn = lib.segmin_grid_launch


KERNEL = SegmentedMinKernel()


def _checked(keys, segs, num_segments, adm=None):
    """(N, device) of a round's CUDA tensors; raises on anything the
    kernels do not take."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the segmented-min kernels need CUDA tensors, "
                         f"got {dev}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    N = keys.shape[0]
    check_tensor("keys", keys, torch.int32, (N,), dev)
    check_tensor("segs", segs, torch.int32, (N,), dev)
    if adm is not None:
        check_tensor("adm", adm, torch.bool, (N,), dev)
    return N, dev


def _launch(route, keys, segs, adm, out, win, N, L) -> None:
    """One round on ``route`` on PyTorch's current stream of the tensors'
    card; raises on a CUDA error."""
    if KERNEL.grid_fn is None:
        KERNEL.build()
    dev = keys.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(route, keys, segs, adm, out, win, N, L)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "atomic":
        err = KERNEL.atomic_fn(keys.data_ptr(), segs.data_ptr(),
                               out.data_ptr(), N, L, stream)
    else:
        err = KERNEL.grid_fn(
            keys.data_ptr(), segs.data_ptr(),
            None if adm is None else adm.data_ptr(), out.data_ptr(),
            None if win is None else win.data_ptr(), N, L, stream)
    if err != 0:
        raise RuntimeError(f"segmented_min {route} launch failed: "
                           f"cudaError {err}")
    KERNEL.launches += 1
    KERNEL.launches_by_route[route] += 1


def segmented_min(
    keys: torch.Tensor,  # (N,) int32 candidate age keys (NOC_INF = none)
    segs: torch.Tensor,  # (N,) int32 resource id per candidate
    num_segments: int,
    *,
    variant: str = "grid",
) -> torch.Tensor:
    """Per-resource minimum key through the CUDA kernels on PyTorch's
    current stream: ``(num_segments,)`` int32, ``NOC_INF`` where a resource
    has no candidate, keys above ``NOC_INF`` capped at it, candidates with a
    segment outside ``[0, num_segments)`` skipped. ``variant`` is one of
    ``VARIANTS``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown segmented-min route {variant!r}; "
                         f"expected one of {VARIANTS}")
    N, dev = _checked(keys, segs, num_segments)
    out = torch.empty((num_segments,), dtype=torch.int32, device=dev)
    if num_segments > 0:
        _launch(variant, keys, segs, None, out, None, N, num_segments)
    return out


def arbitrate_kernel(
    adm: torch.Tensor,  # (N,) bool admissible candidates
    keys: torch.Tensor,  # (N,) int32 age keys, unique among admissible
    segs: torch.Tensor,  # (N,) int32 resource ids
    num_segments: int,
) -> torch.Tensor:
    """Winner mask ``(N,)`` bool of one arbitration round: ``adm & (mkeys ==
    seg_min[clip(segs, 0, L-1)]) & (mkeys < NOC_INF)`` with ``mkeys =
    where(adm, keys, NOC_INF)``, the winner test fused into the grid route's
    one launch."""
    N, dev = _checked(keys, segs, num_segments, adm)
    if num_segments < 1:
        raise ValueError("arbitrate needs num_segments >= 1")
    win = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return win
    out = torch.empty((num_segments,), dtype=torch.int32, device=dev)
    _launch("grid", keys, segs, adm, out, win, N, num_segments)
    return win
