"""Loader and wrapper of the CUDA SSD intra-chunk kernels (``csrc/ssd.cu``).

Replace the reference's Pallas kernel ``repro.kernels.ssd.ssd.
ssd_intra_chunk``. Two kernels, chosen by the input type (``VARIANTS``):
bf16 x, Bm and Cm run the tensor-core kernel (mma.sync tiles, the chunk
resident in shared memory; (N, P) in ``TC_SHAPES``, chunks of at most
``TC_MAX_CHUNK`` steps, 16-byte aligned rows), f32 inputs the CUDA-core
kernel; the wrapper raises on what its kernel does not take. Both read the
model layout through strides (x ``(B, S, H, P)``, dt ``(B, S, H)``, Bm and
Cm ``(B, S, G, N)``; head ``h`` reads group ``h // (H / G)``), pad the
sequence to whole chunks themselves and write the outputs of
``ref.ssd_intra_chunk_ref``. The library is built at first use
(``kernels.build``); ``ssd_intra_chunk_cuda`` takes CUDA tensors only.
``KERNEL.launches`` counts its launches, ``KERNEL.variant_launches`` each
kernel's.

The backward (``csrc/ssd_bwd.cu``, ``ssd_intra_chunk_bwd_cuda``) takes the
same inputs, the forward's ``cum`` and the cotangents of its four outputs,
and returns the gradients of ``ref.ssd_intra_chunk_bwd_ref``. Its kernels
compute in f32 on the CUDA cores for either input type (``BWD_VARIANTS``),
at the (N, P) of ``TC_SHAPES`` and chunks of at most ``TC_MAX_CHUNK``
steps. ``KERNEL_BWD`` counts its launches (one a call), by input type in
``variant_launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

_SRC = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
_BWD_SRC = Path(__file__).resolve().parent / "csrc" / "ssd_bwd.cu"
DTYPES = (torch.float32, torch.bfloat16)
# the kernel each input type runs
VARIANTS = {torch.bfloat16: "mma_bf16", torch.float32: "cuda_core_f32"}
# the backward's kernels by input type: both compute in f32 on the CUDA
# cores, reading x, Bm and Cm in their own type
BWD_VARIANTS = {torch.bfloat16: "cuda_core_bf16_in",
                torch.float32: "cuda_core_f32"}
# the (state N, head dim P) the bf16 kernel is built for: those of the
# port's models (hymba and mamba2, full and smoke width)
TC_SHAPES = ((16, 32), (32, 32), (16, 64), (128, 64))
TC_MAX_CHUNK = 256
# dynamic shared memory a block may use on an H100 (227 KB)
MAX_SMEM = 232_448


def smem_bytes(dtype: torch.dtype, L: int, N: int, P: int) -> int:
    """Shared memory of one block of ``dtype``'s kernel, as
    ``ssd_intra_chunk_smem_bytes`` in the source computes it. bf16: the
    chunk's C, B (rows of N + 8) and X (rows of P + 8) in bf16 over L
    rounded up to 16, cum, dt and w in f32, 8 warp sums; f32: the streamed
    64-row tiles, the output tile and the state in f32."""
    if dtype == torch.bfloat16:
        Lp = -(-L // 16) * 16
        return Lp * (2 * (N + 8) + (P + 8)) * 2 + 3 * Lp * 4 + 8 * 4
    return 4 * (3 * L + 64 * N + N * 65 + 64 * P + 64 * 64 + 64 * P + N * P)


def bwd_smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory of one block of the backward's tile kernel, as
    ``ssd_intra_chunk_bwd_smem_bytes`` in the source computes it: the
    64-row tiles of C, B (N rows of 65), dy and x (P rows of 65)
    transposed, the M and G tiles (64 rows of 80), cum and dt over the
    chunk, two 8 x 64 warp-sum arrays and u, all f32."""
    return 4 * (2 * N * 65 + 2 * P * 65 + 2 * 64 * 80 + 2 * L + 2 * 8 * 64
                + 64)


class SsdKernel(CudaLibrary):
    """The built library, its build report and the launch counters."""

    def __init__(self):
        super().__init__("ssd", _SRC)
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = dict.fromkeys(VARIANTS.values(), 0)

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_intra_chunk_launch.argtypes = (
            [p] * 9 + [i] * 9 + [ll] * 12 + [p]
        )
        lib.ssd_intra_chunk_launch.restype = ctypes.c_int
        lib.ssd_intra_chunk_smem_bytes.argtypes = [i] * 4
        lib.ssd_intra_chunk_smem_bytes.restype = ctypes.c_size_t


KERNEL = SsdKernel()


class SsdBwdKernel(CudaLibrary):
    """The backward's library, its build report and the launch counters."""

    def __init__(self):
        super().__init__("ssd_bwd", _BWD_SRC)
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = dict.fromkeys(BWD_VARIANTS.values(), 0)

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_intra_chunk_bwd_launch.argtypes = (
            [p] * 16 + [i] * 9 + [ll] * 12 + [p]
        )
        lib.ssd_intra_chunk_bwd_launch.restype = ctypes.c_int
        lib.ssd_intra_chunk_bwd_smem_bytes.argtypes = [i] * 3
        lib.ssd_intra_chunk_bwd_smem_bytes.restype = ctypes.c_size_t


KERNEL_BWD = SsdBwdKernel()


def _check(x, dt, A, Bm, Cm) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernel takes x, Bm, Cm in {DTYPES}, got "
                        f"{x.dtype}")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and Bm {tuple(Bm.shape)} must "
                         "be (B, S, H, P) and (B, S, G, N)")
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, x.dtype, (B_, S, H, P), dev, strided=True)
    check_tensor("dt", dt, f32, (B_, S, H), dev, strided=True)
    check_tensor("A", A, f32, (H,), dev)
    check_tensor("Bm", Bm, x.dtype, (B_, S, G, N), dev, strided=True)
    check_tensor("Cm", Cm, x.dtype, (B_, S, G, N), dev, strided=True)
    if x.dtype == torch.bfloat16:
        if (N, P) not in TC_SHAPES:
            raise ValueError(f"the bf16 kernel takes (N, P) in {TC_SHAPES}, "
                             f"got ({N}, {P})")
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"{name} (strides {tuple(t.stride())}) must be 16-byte "
                    "aligned with strides in multiples of 8 for the bf16 "
                    "kernel's 16-byte copies")


def ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, chunk: int):
    """The intra-chunk pass through the CUDA kernel on PyTorch's current
    stream: ``(y (B, nc*L, H, P), sc (B, nc, H, N, P), dec (B, nc, H),
    cum (B, nc, L, H))``, all f32, the contract of
    ``ref.ssd_intra_chunk_ref``."""
    _check(x, dt, A, Bm, Cm)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = chunk
    nc = -(-S // L)
    bf16 = x.dtype == torch.bfloat16
    if bf16 and L > TC_MAX_CHUNK:
        raise ValueError(f"the bf16 kernel takes chunks of at most "
                         f"{TC_MAX_CHUNK} steps, got {L}")
    lib = KERNEL.build()
    smem = lib.ssd_intra_chunk_smem_bytes(int(bf16), L, N, P)
    if smem > MAX_SMEM:
        raise ValueError(f"L={L}, N={N}, P={P} needs {smem} bytes of shared "
                         f"memory, over {MAX_SMEM}")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        y = torch.empty((B_, nc * L, H, P), **f32)
        sc = torch.empty((B_, nc, H, N, P), **f32)
        dec = torch.empty((B_, nc, H), **f32)
        cum = torch.empty((B_, nc, L, H), **f32)
        if y.numel() == 0:
            return y, sc, dec, cum
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_intra_chunk_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), sc.data_ptr(), dec.data_ptr(),
            cum.data_ptr(), int(bf16), B_, S, H, G, N,
            P, L, nc, *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
            *Cm.stride()[:3], stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: "
                           f"cudaError {err}")
    KERNEL.launches += 1
    KERNEL.variant_launches[VARIANTS[x.dtype]] += 1
    return y, sc, dec, cum


def ssd_intra_chunk_bwd_cuda(x, dt, A, Bm, Cm, cum, dy, dsc, ddec, dcum,
                             chunk: int):
    """The intra-chunk pass's backward through the CUDA kernels on
    PyTorch's current stream: ``(dx (B, S, H, P), ddt (B, S, H), dA (H,),
    dBm (B, S, G, N), dCm (B, S, G, N))``, all f32, the contract of
    ``ref.ssd_intra_chunk_bwd_ref``. dB and dC come from the kernels per
    head and dA per (batch, chunk, head); torch sums them over a group's
    heads and over batch and chunks."""
    _check(x, dt, A, Bm, Cm)
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = chunk
    nc = -(-S // L)
    if (N, P) not in TC_SHAPES:
        raise ValueError(f"the SSD backward takes (N, P) in {TC_SHAPES}, "
                         f"got ({N}, {P})")
    if L > TC_MAX_CHUNK:
        raise ValueError(f"the SSD backward takes chunks of at most "
                         f"{TC_MAX_CHUNK} steps, got {L}")
    dev, f32 = x.device, torch.float32
    dy, dsc, ddec, dcum = (t.float().contiguous() for t in (dy, dsc, ddec,
                                                              dcum))
    check_tensor("cum", cum, f32, (B_, nc, L, H), dev)
    check_tensor("dy", dy, f32, (B_, nc * L, H, P), dev)
    check_tensor("dsc", dsc, f32, (B_, nc, H, N, P), dev)
    check_tensor("ddec", ddec, f32, (B_, nc, H), dev)
    check_tensor("dcum", dcum, f32, (B_, nc, L, H), dev)
    lib = KERNEL_BWD.build()
    smem = lib.ssd_intra_chunk_bwd_smem_bytes(N, P, L)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"L={L}, N={N}, P={P} needs {smem} bytes of shared "
                         f"memory, over {MAX_SMEM}")
    out = dict(dtype=f32, device=dev)
    with torch.cuda.device(dev):
        dx = torch.empty((B_, S, H, P), **out)
        ddt = torch.empty((B_, S, H), **out)
        dA_part = torch.empty((B_, nc, H), **out)
        dBh = torch.empty((B_, S, H, N), **out)
        dCh = torch.empty((B_, S, H, N), **out)
        scratch = torch.empty((4, B_, H, nc, L), **out)
        if dx.numel():
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ssd_intra_chunk_bwd_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), cum.data_ptr(), dy.data_ptr(), dsc.data_ptr(),
                ddec.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dA_part.data_ptr(), dBh.data_ptr(),
                dCh.data_ptr(), scratch.data_ptr(),
                int(x.dtype == torch.bfloat16), B_, S, H, G, N, P, L, nc,
                *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                *Cm.stride()[:3], stream,
            )
            if err != 0:
                raise RuntimeError(f"ssd_intra_chunk_bwd kernel launch "
                                   f"failed: cudaError {err}")
            KERNEL_BWD.launches += 1
            KERNEL_BWD.variant_launches[BWD_VARIANTS[x.dtype]] += 1
        hpg = H // G
        dA = dA_part.sum((0, 1))
        dBm = dBh.view(B_, S, G, hpg, N).sum(3)
        dCm = dCh.view(B_, S, G, hpg, N).sum(3)
    return dx, ddt, dA, dBm, dCm
