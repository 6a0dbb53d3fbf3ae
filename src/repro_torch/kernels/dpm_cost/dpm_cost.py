"""Loader and wrappers of the two CUDA cost-table kernels (``csrc/dpm_cost.cu``).

Replace the reference's Pallas kernels
``repro.kernels.dpm_cost.dpm_cost.dpm_cost_table`` and
``dpm_cost_table_weighted``. For each multicast packet both evaluate all 24
DPM candidate partitions (8 basic wedges, 8 consecutive pairs, 8 triples):

    rep[c]  = argmin_{d in cand} (dist(S, d), label(d))        (Definition 1)
    cost[c] = sum_{d in cand} dist(rep, d) [+ |S->rep|]        (C_t of Def. 2)

``dpm_cost_table`` computes distances from coordinates (Manhattan on the
mesh, toroidal under ``wrap=True``) into int32 tables;
``dpm_cost_table_weighted`` takes them from dense ``(NN, NN)`` provider-route
tensors (``dist`` picks the representative, ``weight`` prices C_t and the
leg, plus ``overhead`` per destination beyond the representative) into
float32 costs.

Each table has two routes (``VARIANTS``): ``"warp"``, the default, gives
each packet one warp that streams its mask row once into a list of its
destinations and works over those only; ``"block"``, the first design, gives each
packet a thread block striding over all its nodes, and stays for
comparison. ``variant=`` picks one; ``dpm_plan`` and ``dpm_plan_weighted``
run the default.

The library is built at first use (``kernels.build``). Both wrappers take
CUDA tensors only and raise on anything else; ``ops.py`` dispatches CPU
tensors to the plain versions in ``ref.py``. ``KERNEL.launches`` counts the
launches of each kernel by name, ``KERNEL.variant_launches`` by name and
route (``"dpm_cost_table/warp"``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

# candidate index sets: 8 singles, 8 consecutive pairs, 8 consecutive triples
CANDS: list[tuple[int, ...]] = (
    [(i,) for i in range(8)]
    + [(i, (i + 1) % 8) for i in range(8)]
    + [(i, (i + 1) % 8, (i + 2) % 8) for i in range(8)]
)
BIG = 1 << 20
# the key of a node outside the candidate (the reference's argmin sentinel)
EMPTY_KEY = 1 << 30

_SRC = Path(__file__).resolve().parent / "csrc" / "dpm_cost.cu"
NAMES = ("dpm_cost_table", "dpm_cost_table_weighted")
VARIANTS = ("warp", "block")
# the block route keeps one byte per node in dynamic shared memory (48 KB
# without an opt-in, a few KB more taken by the reduction partials); the
# warp route two per node and packet (8 packets a block up to ~2,600 nodes,
# fewer above, one with an opt-in above ~24,000); node ids fit 16 bits
MAX_NODES = 32_768


def _ring_delta(d, size: int, wrap: bool):
    """Signed shortest displacement per ring dimension, vectorized.

    ``wrap=False`` is the identity (mesh). ``wrap=True`` maps into
    [-size//2, (size-1)//2] with half-way ties negative. torch's ``%`` on
    integer tensors is floor-mod like Python's, which keeps this equal to
    ``core.topology.ring_delta``; the CUDA kernel writes the floor-mod out.
    """
    if not wrap or size <= 1:
        return d
    return (d + size // 2) % size - size // 2


class DpmCostKernels(CudaLibrary):
    """The built library, its build report and launch counters per
    kernel (``launches["dpm_cost_table"]``, ``launches[
    "dpm_cost_table_weighted"]``) and per kernel and route
    (``variant_launches["dpm_cost_table/warp"]``)."""

    def __init__(self):
        super().__init__("dpm_cost", _SRC)
        self.reset()

    def reset(self) -> None:
        self.launches = dict.fromkeys(NAMES, 0)
        self.variant_launches = {f"{k}/{v}": 0 for k in NAMES
                                 for v in VARIANTS}

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dpm_cost_table_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.dpm_cost_table_launch.restype = ctypes.c_int
        lib.dpm_cost_table_weighted_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.dpm_cost_table_weighted_launch.restype = ctypes.c_int


KERNEL = DpmCostKernels()


def _packets(dest_mask, src_xy, n, m, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown dpm_cost variant {variant!r}")
    device = dest_mask.device
    if device.type != "cuda":
        raise ValueError(f"the dpm_cost kernels need CUDA tensors, got {device}")
    P, NN = dest_mask.shape
    if NN != n * m:
        raise ValueError(f"dest_mask has {NN} nodes, the fabric {n}x{m}")
    if P == 0:
        raise ValueError("the dpm_cost kernels need at least one packet")
    if NN > MAX_NODES:
        raise ValueError(f"{NN} nodes > {MAX_NODES}: the kernels keep "
                         "each packet's nodes in shared memory")
    check_tensor("dest_mask", dest_mask, torch.int32, (P, NN), device)
    check_tensor("src_xy", src_xy, torch.int32, (P, 2), device)
    return device, P, NN


def _launched(name: str, variant: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} ({variant}) kernel launch failed: "
                           f"cudaError {err}")
    KERNEL.launches[name] += 1
    KERNEL.variant_launches[f"{name}/{variant}"] += 1


def dpm_cost_table(
    dest_mask: torch.Tensor,  # (P, NN) int32 0/1 (row-major nodes)
    src_xy: torch.Tensor,  # (P, 2) int32
    *,
    n: int,
    m: int | None = None,
    wrap: bool = False,
    include_source_leg: bool = True,
    variant: str = "warp",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate cost tables through the CUDA kernel of route ``variant``:
    ``(costs (P, 24) int32, reps (P, 24) int32)``, the contract of
    ``ref.dpm_cost_table_ref``. Runs on PyTorch's current stream."""
    m = m or n
    device, P, NN = _packets(dest_mask, src_xy, n, m, variant)
    # every representative key dist * 2^20 + label stays below the
    # sentinel, so the empty-candidate test and the argmin agree
    far = (n // 2 + m // 2) if wrap else (n - 1 + m - 1)
    if far * BIG + NN >= EMPTY_KEY:
        raise ValueError(f"a {n}x{m} fabric overflows the int32 rep key")
    lib = KERNEL.build()
    with torch.cuda.device(device):
        costs = torch.empty((P, 24), dtype=torch.int32, device=device)
        reps = torch.empty((P, 24), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dpm_cost_table_launch(
            dest_mask.data_ptr(), src_xy.data_ptr(), costs.data_ptr(),
            reps.data_ptr(), P, n, m, int(wrap), int(include_source_leg),
            int(variant == "block"), stream,
        )
        _launched("dpm_cost_table", variant, err)
    return costs, reps


def dpm_cost_table_weighted(
    dest_mask: torch.Tensor,  # (P, NN) int32 0/1 (row-major nodes)
    src_xy: torch.Tensor,  # (P, 2) int32
    dist: torch.Tensor,  # (NN, NN) float32 provider-route hop counts
    weight: torch.Tensor,  # (NN, NN) float32 provider-route prices
    *,
    n: int,
    m: int | None = None,
    wrap: bool = False,
    overhead: float = 0.0,
    include_source_leg: bool = True,
    variant: str = "warp",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate cost tables over route tensors through the CUDA kernel of
    route ``variant``: ``(costs (P, 24) float32, reps (P, 24) int32)``,
    the contract of
    ``ref.dpm_cost_table_weighted_ref``. ``dist`` must hold hop counts
    small enough for the int32 rep key (checked: one device-to-host read
    of its maximum)."""
    m = m or n
    device, P, NN = _packets(dest_mask, src_xy, n, m, variant)
    check_tensor("dist", dist, torch.float32, (NN, NN), device)
    check_tensor("weight", weight, torch.float32, (NN, NN), device)
    if int(dist.max()) * BIG + NN >= EMPTY_KEY:
        raise ValueError("route distances overflow the int32 rep key")
    lib = KERNEL.build()
    with torch.cuda.device(device):
        costs = torch.empty((P, 24), dtype=torch.float32, device=device)
        reps = torch.empty((P, 24), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dpm_cost_table_weighted_launch(
            dest_mask.data_ptr(), src_xy.data_ptr(), dist.data_ptr(),
            weight.data_ptr(), costs.data_ptr(), reps.data_ptr(), P, n, m,
            int(wrap), int(include_source_leg), float(overhead),
            int(variant == "block"), stream,
        )
        _launched("dpm_cost_table_weighted", variant, err)
    return costs, reps
