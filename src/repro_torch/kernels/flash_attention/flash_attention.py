"""Loader and wrapper of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``).

Replace the reference's Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``:
causal GQA attention (KV head ``h // G``) with an optional sliding
``window`` and a ``q_offset``, f32 softmax inside, output in ``q.dtype``.
Two kernels, chosen by the input type (``VARIANTS``): bf16 inputs run the
Hopper kernel (wgmma on the tensor cores, K/V tiles by TMA), f32 inputs the
CUDA-core kernel in f32. Both read the model layout ``(B, S, H, D)`` through
strides, so the reference wrapper's transposes are gone; the TMA maps of
the bf16 kernel need 16-byte aligned tensors whose strides are multiples of
8 elements, and the wrapper raises on any other. v has a head dim Dv of its
own, as the reference's ``_flash_fwd_impl`` lets it (MLA: q and k 192, v
128); the kernels take the pairs ``HEAD_DIM_PAIRS`` and raise on any other.
The library is built at first use (``kernels.build``);
``flash_attention_cuda`` takes CUDA tensors only. ``KERNEL.launches``
counts its launches, ``KERNEL.variant_launches`` each kernel's,
``KERNEL.head_dim_launches`` those at each head-dim pair ``(D, Dv)``. With
``return_lse`` the forward also writes the row log-sum-exp that the
backward reads; without it the kernel gets a null pointer and writes none
(serving).

The backward replaces the reference's hand-written jnp backward
``repro.models.attention._flash_bwd_impl``; the JAX package has no Pallas
backward. ``flash_attention_bwd_cuda`` takes a ``route`` (``BWD_ROUTES``)
for bf16 inputs: ``"wgmma"``, the default
(``csrc/flash_attention_bwd_wgmma.cu``, ``BWD_WGMMA_LIB``: wgmma on
TMA-fed tiles, variant ``wgmma_bf16``), or ``"mma_sync"``
(``csrc/flash_attention_bwd.cu``, ``BWD_KERNEL``'s library: the first
design's mma.sync m16n8k16 kernels, kept as the comparison, variant
``mma_bf16``). f32 inputs run the CUDA-core kernels of
``flash_attention_bwd.cu`` (``cuda_core_f32``) whatever the route. The
forward's head-dim pairs ``HEAD_DIM_PAIRS``. One call launches three
kernels (delta = rowsum(dout * out), then dK/dV, then dQ) and counts as one
launch in ``BWD_KERNEL.launches``, ``variant_launches`` and
``head_dim_launches``. It reads every tensor as a contiguous ``(B, S,
heads, width)`` array and makes
its inputs so (autograd's ``dout`` may come with other strides); the wgmma
route's TMA maps also need 16-byte aligned bases and raise on any other.
An unknown route raises, and neither route gives way to the other or to
the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 192)
# (q/k head dim, v head dim) of every kernel, forward and backward: v as
# wide as q and k, and MLA's v of 128 beside q and k of 192 (the sources'
# FLASH_HEAD_DIM_PAIRS / BWD_HEAD_DIM_PAIRS)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)
# the kernel each input type runs
VARIANTS = {torch.bfloat16: "wgmma_bf16", torch.float32: "cuda_core_f32"}
# the bf16 kernel's tiles: query rows per block, keys per K/V tile
TC_BQ, TC_BK = 128, 64
_BWD_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
_BWD_WGMMA_SRC = (Path(__file__).resolve().parent / "csrc"
                  / "flash_attention_bwd_wgmma.cu")
BWD_ROUTES = ("wgmma", "mma_sync")
# the kernels each route runs for each input type
BWD_VARIANTS = {
    "wgmma": {torch.bfloat16: "wgmma_bf16", torch.float32: "cuda_core_f32"},
    "mma_sync": {torch.bfloat16: "mma_bf16", torch.float32: "cuda_core_f32"},
}
BWD_VARIANT_NAMES = ("wgmma_bf16", "mma_bf16", "cuda_core_f32")
# the mma_sync and f32 kernels' tiles: keys per dK/dV block and query rows
# per dQ block, each walking the other side in tiles of the same size
BWD_BLOCK = 64
# the wgmma kernels: tiles of BWD_TILE rows (wgmma's M; the keys a dQ
# block streams), blocks of BWD_WGS consumer warpgroups (BWD_WGS x BWD_TILE
# keys of a dK/dV block, query rows of a dQ block); a dK/dV block streams
# query tiles of bwd_query_tile(D, Dv) rows
BWD_TILE, BWD_WGS = 64, 2
_MAX_SMEM = 232_448  # a block's shared memory on an H100


def check_pair(D: int, Dv: int) -> None:
    """Raise unless the kernels, forward and backward, take the head-dim
    pair ``(D, Dv)``: the card has no other engine."""
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {D}, v {Dv}): the flash kernels "
                         f"take the pairs {HEAD_DIM_PAIRS}")


def smem_bytes(dtype: torch.dtype, D: int, Dv: int) -> int:
    """Dynamic shared memory of one block of ``dtype``'s kernel at the
    head-dim pair ``(D, Dv)``, as ``flash_attention_smem_bytes`` in the
    source computes it. bf16: 1 KB to align the swizzled tiles, the Q tile,
    the stages of K and V (2 at D = 128, 4 at (192, 128), else 3) and the
    mbarriers; f32: the Q, K^T, V and P tiles of 64 rows."""
    check_pair(D, Dv)
    if dtype == torch.bfloat16:
        stages = 2 if D == 128 else 4 if (D, Dv) == (192, 128) else 3
        return 1024 + TC_BQ * D * 2 + stages * TC_BK * (D + Dv) * 2 + 128
    return 4 * (64 * D + D * 65 + 64 * Dv + 64 * 64)


def bwd_query_tile(D: int, Dv: int) -> int:
    """Query rows of a tile that a wgmma dK/dV block streams at ``(D, Dv)``
    (``Pair::QT`` in the source): 64 while a consumer thread's dK, dV and
    tile products fit setmaxnreg's 240 registers (D + Dv <= 256), 32 up to
    D + Dv = 320 (MLA's (192, 128)), else 16."""
    return 64 if D + Dv <= 256 else 32 if D + Dv <= 320 else 16


def check_bwd_route(route: str) -> None:
    if route not in BWD_ROUTES:
        raise ValueError(f"unknown backward route {route!r}: one of "
                         f"{BWD_ROUTES}")


def bwd_smem_bytes(dtype: torch.dtype, D: int, Dv: int, part: str, *,
                   route: str = "wgmma") -> int:
    """Dynamic shared memory of one block of the backward's ``part``
    (``"dkdv"`` or ``"dq"``) at the head-dim pair ``(D, Dv)`` on ``route``,
    as the sources compute it (``flash_attention_bwd_wgmma_smem_bytes``,
    ``flash_attention_bwd_smem_bytes``). bf16 ``wgmma``: 1 KB to align the
    swizzled tiles, the resident tiles of 128 rows (K and V; Q and dO), the
    stages of streamed tiles (dK/dV: Q and dO tiles of
    ``bwd_query_tile(D, Dv)`` rows with the tile's lse and delta, f32, 3
    stages of 64 rows or 6 of fewer; dQ: K and V tiles of 64 rows, 3 stages
    where they fit, else 2) and the mbarriers. bf16 ``mma_sync``: rows
    padded by 8 elements (16 bytes) so that the mma fragments' 32-bit loads
    meet no bank twice; dK/dV holds K, V, Q, dO and the transposed Q and dO
    of 64 rows, dQ holds Q, dO, K, V and the transposed K; both the tile's
    lse and delta in f32. f32 (either route): tiles of width + 1 columns;
    dK/dV holds K, V, Q, dO, P and dS, dQ holds Q, dO, K, V and dS."""
    check_bwd_route(route)
    check_pair(D, Dv)
    if dtype == torch.bfloat16 and route == "wgmma":
        res = BWD_WGS * BWD_TILE * (D + Dv) * 2
        if part == "dkdv":
            qt = bwd_query_tile(D, Dv)
            stage = qt * (D + Dv) * 2 + 2 * qt * 4
            return 1024 + res + (3 if qt == BWD_TILE else 6) * stage + 128
        stage = BWD_TILE * (D + Dv) * 2
        stages = 3 if 1024 + res + 3 * stage + 128 <= _MAX_SMEM else 2
        return 1024 + res + stages * stage + 128
    n = BWD_BLOCK
    if dtype == torch.bfloat16:
        rows = 2 * ((D + 8) + (Dv + 8)) * 2 * n  # K, V, Q, dO, padded rows
        cols = (n + 8) * 2  # a transposed tile's row of 64 (plus 8)
        if part == "dkdv":  # Q^T, dO^T, lse and delta
            return rows + (D + Dv) * cols + 2 * n * 4
        return rows + D * cols  # K^T
    tiles = 4 * n * 2 * ((D + 1) + (Dv + 1))
    pt = 4 * n * (n + 1)
    if part == "dkdv":
        return tiles + 2 * pt + 2 * n * 4
    return tiles + pt


def bwd_live_key_tiles(q0: int, rows: int, Sq: int, Sk: int, *,
                       causal: bool, window: int | None,
                       q_offset: int) -> range:
    """The key tiles (of ``BWD_TILE`` keys) that the wgmma dQ block of the
    real query rows ``[q0, min(q0 + rows, Sq))`` walks, as ``live_key_tiles``
    in the source computes them: the keys visible from those rows form one
    run, from the first row's window edge to the last row's diagonal."""
    qa, qb = q_offset + q0, q_offset + min(q0 + rows, Sq) - 1
    kmin = max(0, qa - window + 1) if window else 0
    kmax = min(Sk - 1, qb) if causal else Sk - 1
    if kmin > kmax:
        return range(0)
    return range(kmin // BWD_TILE, kmax // BWD_TILE + 1)


def bwd_live_query_tiles(k0: int, keys: int, Sq: int, Sk: int, *,
                         causal: bool, window: int | None, q_offset: int,
                         tile: int = BWD_TILE) -> range:
    """The query tiles (of ``tile`` rows: ``bwd_query_tile(D, Dv)``) that
    the wgmma dK/dV block of the real keys ``[k0, min(k0 + keys, Sk))``
    walks for each query head, as ``live_query_tiles`` in the source
    computes them: rows from the first key's diagonal to the last key's
    window edge."""
    kb = min(k0 + keys, Sk) - 1
    rmin = max(0, k0 - q_offset) if causal else 0
    rmax = min(Sq - 1, kb + window - 1 - q_offset) if window else Sq - 1
    if rmin > rmax:
        return range(0)
    return range(rmin // tile, rmax // tile + 1)


class FlashAttentionKernel(CudaLibrary):
    """The built library, its build report and the launch counters."""

    def __init__(self):
        super().__init__("flash_attention", _SRC)
        self.launches = 0
        self.variant_launches = dict.fromkeys(VARIANTS.values(), 0)
        self.head_dim_launches = dict.fromkeys(HEAD_DIM_PAIRS, 0)

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [p] * 5 + [i] * 8 + [ll] * 9 + [i] * 3 + [ctypes.c_float, p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int


class FlashAttentionBwdKernel(CudaLibrary):
    """The backward's library, its build report and launch counters."""

    def __init__(self):
        super().__init__("flash_attention_bwd", _BWD_SRC)
        self.launches = 0
        self.variant_launches = dict.fromkeys(BWD_VARIANT_NAMES, 0)
        self.head_dim_launches = dict.fromkeys(HEAD_DIM_PAIRS, 0)

    def reset(self) -> None:
        self.launches = 0
        self.variant_launches = dict.fromkeys(BWD_VARIANT_NAMES, 0)
        self.head_dim_launches = dict.fromkeys(HEAD_DIM_PAIRS, 0)

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [i] * 11 + [ctypes.c_float, p]
        )
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i, i]
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int


class FlashAttentionBwdWgmmaLibrary(CudaLibrary):
    """The wgmma route's library and its build report; its launches count
    in ``BWD_KERNEL``'s counters beside the other routes'."""

    def __init__(self):
        super().__init__("flash_attention_bwd_wgmma", _BWD_WGMMA_SRC)

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_wgmma_launch.argtypes = (
            [p] * 11 + [i] * 10 + [ctypes.c_float, p]
        )
        lib.flash_attention_bwd_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_wgmma_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_bwd_wgmma_smem_bytes.restype = ctypes.c_int


KERNEL = FlashAttentionKernel()
BWD_KERNEL = FlashAttentionBwdKernel()
BWD_WGMMA_LIB = FlashAttentionBwdWgmmaLibrary()


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES}, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, D), "
                         "(B, Sk, KH, D) and (B, Sk, KH, Dv)")
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    check_pair(D, Dv)
    for name, t, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Sk, KH, D)),
                           ("v", v, (B, Sk, KH, Dv))):
        check_tensor(name, t, q.dtype, shape, q.device, strided=True)
        if q.dtype == torch.bfloat16:
            check_tma(name, t)


def check_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can read ``t`` (bf16, last dim contiguous): a base
    address aligned to 16 bytes, batch, sequence and head strides that are
    multiples of 8 elements (16 bytes)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}'s data is not 16-byte aligned, which the "
                         "TMA loads of the bf16 kernel need")
    bad = [st for st in t.stride()[:3] if st % 8]
    if bad:
        raise ValueError(f"{name} has strides {tuple(t.stride())}: the TMA "
                         "loads of the bf16 kernel need multiples of 8")


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,  # (B, Sk, KH, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention through the CUDA kernel on PyTorch's current stream:
    ``(B, Sq, H, Dv)`` in ``q.dtype``, the contract of
    ``ref.flash_attention_ref``; with ``return_lse`` the pair
    ``(out, lse)``, ``lse`` ``(B, Sq, H)`` f32."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = KERNEL.build()
    with torch.cuda.device(q.device):
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
               if return_lse else None)
        if out.numel() == 0:
            return (out, lse) if return_lse else out
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, q_offset, D**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    KERNEL.launches += 1
    KERNEL.variant_launches[VARIANTS[q.dtype]] += 1
    KERNEL.head_dim_launches[D, Dv] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(
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
    route: str = "wgmma",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` through the CUDA backward kernels of ``route`` on
    PyTorch's current stream, in the inputs' dtype: the contract of
    ``ref.flash_attention_bwd_ref``. Deterministic: no atomics, each
    gradient element summed by one thread in a fixed order."""
    check_bwd_route(route)
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.float().contiguous()
    for name, t, shape in (("out", out, (B, Sq, H, Dv)),
                           ("dout", dout, (B, Sq, H, Dv))):
        check_tensor(name, t, q.dtype, shape, q.device)
    check_tensor("lse", lse, torch.float32, (B, Sq, H), q.device)
    wgmma = route == "wgmma" and q.dtype == torch.bfloat16
    if wgmma:
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            check_tma(name, t)
    lib = (BWD_WGMMA_LIB if wgmma else BWD_KERNEL).build()
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if q.numel() == 0 or k.numel() == 0:
            return dq.zero_(), dk.zero_(), dv.zero_()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if wgmma:
            # lse x log2 e and delta, (B, H, Sq rounded up to a tile)
            sq_pad = -(-Sq // BWD_TILE) * BWD_TILE
            rows = torch.empty((2, B, H, sq_pad), dtype=torch.float32,
                               device=q.device)
            err = lib.flash_attention_bwd_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), rows[0].data_ptr(),
                rows[1].data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Sq, Sk, H, KH, D, Dv, int(causal),
                window or 0, q_offset, D**-0.5, stream,
            )
        else:
            delta = torch.empty((B, Sq, H), dtype=torch.float32,
                                device=q.device)
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, D, Dv,
                int(causal), window or 0, q_offset, D**-0.5, stream,
            )
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed "
                           f"(route {route}): cudaError {err}")
    BWD_KERNEL.launches += 1
    BWD_KERNEL.variant_launches[BWD_VARIANTS[route][q.dtype]] += 1
    BWD_KERNEL.head_dim_launches[D, Dv] += 1
    return dq, dk, dv
