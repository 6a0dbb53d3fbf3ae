"""Loader and wrapper of the CUDA wormhole-cycle kernel (``csrc/noc_cycle.cu``).

Replaces the reference's Pallas chunk runner
(``repro.kernels.noc_cycle.noc_cycle.make_chunk_runner``). The kernel is
built at first use with ``nvcc`` for ``sm_90a`` into ``build/kernels`` at the
root of the checkout, as a shared library with a plain C interface bound
through ``ctypes`` (seconds to build; nothing is built at import time).

``run_cycles_cuda`` launches one thread block per batch instance that runs
all ``T`` cycles and records delivery times itself. ``KERNEL.launches``
counts launches, so a caller can show that a run went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor as _check
from .ref import CycleState, init_planes

_SRC = Path(__file__).resolve().parent / "csrc" / "noc_cycle.cu"

_PLANES = CycleState._fields
# kernel-side table order (NocArgs); ``lane`` is only read by the plain
# version's child bookkeeping, which the kernel does per node instead
_TABLES = (
    "enqueue", "num_stages", "flits", "link", "vcls", "lane_seq", "chl",
    "child_pid", "child_parent", "child_rs", "child_enq", "watch_link",
    "dslot",
)
_SIZES = ("B", "P", "S", "Q", "QC", "C", "NN", "L", "V", "D", "F", "BD", "E",
          "EPL", "ND", "T", "use_smem")


class _NocArgs(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in _PLANES]
        + [(f, ctypes.c_void_p) for f in _TABLES]
        + [("node_ports", ctypes.c_void_p), ("cand_port", ctypes.c_void_p),
           ("dtime", ctypes.c_void_p), ("scratch", ctypes.c_void_p)]
        + [(f, ctypes.c_int) for f in _SIZES]
    )


class NocCycleKernel(CudaLibrary):
    """The built library, its build report and the launch counter."""

    def __init__(self):
        super().__init__("noc_cycle", _SRC)
        self.launches = 0
        self.scratch_in_smem: bool | None = None

    def bind(self, lib: ctypes.CDLL) -> None:
        lib.noc_cycle_launch.argtypes = [ctypes.POINTER(_NocArgs),
                                         ctypes.c_void_p]
        lib.noc_cycle_launch.restype = ctypes.c_int
        lib.noc_cycle_scratch_words.argtypes = [ctypes.c_int] * 3
        lib.noc_cycle_scratch_words.restype = ctypes.c_size_t
        lib.noc_cycle_smem_optin.restype = ctypes.c_int


KERNEL = NocCycleKernel()


def run_cycles_cuda(tb: dict, dslot: torch.Tensor, geom: dict, *, T: int,
                    F: int, V: int, BD: int, L: int, NN: int, ND: int,
                    EPL: int, E: int) -> tuple[CycleState, torch.Tensor]:
    """``T`` cycles from fresh planes through the CUDA kernel: the same
    contract as ``ref.run_cycles_ref``. Every tensor must lie on one CUDA
    device; the kernel runs on PyTorch's current stream."""
    device = dslot.device
    if device.type != "cuda":
        raise ValueError(f"run_cycles_cuda needs CUDA tensors, got {device}")
    B, P, S = tb["link"].shape
    Q = tb["lane_seq"].shape[2]
    QC = tb["chl"].shape[2]
    C = tb["child_parent"].shape[1]
    W = 2 * V
    D = L // NN
    CANDP = L * W + 2 * NN + 1
    shapes = {
        "enqueue": (B, P), "num_stages": (B, P), "flits": (B, P),
        "link": (B, P, S), "vcls": (B, P, S), "dslot": (B, P, S),
        "lane_seq": (B, 2 * NN, Q), "chl": (B, NN, QC),
        "child_pid": (B, C), "child_parent": (B, C), "child_rs": (B, C),
        "child_enq": (B, C), "watch_link": (B, C),
    }
    tables = dict(tb, dslot=dslot)
    for f in _TABLES:
        _check(f, tables[f], torch.int32, shapes[f], device)
    _check("node_ports", geom["node_ports"], torch.int32,
           (NN, D * W + 2), device)
    _check("cand_port", geom["cand_port"], torch.int32, (CANDP,), device)
    if B == 0 or T == 0:
        raise ValueError("run_cycles_cuda needs B > 0 instances and T > 0 cycles")

    lib = KERNEL.build()
    with torch.cuda.device(device):
        planes = init_planes(B, L, W, NN, C, E, device=device)
        dtime = torch.full((B, ND + 1), -1, dtype=torch.int32, device=device)
        words = lib.noc_cycle_scratch_words(L, W, NN)
        # static shared memory (the per-cycle counters) needs a little room
        use_smem = words * 4 + 1024 <= lib.noc_cycle_smem_optin()
        scratch = torch.empty(
            0 if use_smem else B * words, dtype=torch.int32, device=device
        )
        args = _NocArgs(
            *[p.data_ptr() for p in planes],
            *[tables[f].data_ptr() for f in _TABLES],
            geom["node_ports"].data_ptr(), geom["cand_port"].data_ptr(),
            dtime.data_ptr(), scratch.data_ptr(),
            B, P, S, Q, QC, C, NN, L, V, D, F, BD, E, EPL, ND, T,
            int(use_smem),
        )
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.noc_cycle_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"noc_cycle kernel launch failed: cudaError {err}")
        KERNEL.launches += 1
        KERNEL.scratch_in_smem = use_smem
    return planes, dtime
