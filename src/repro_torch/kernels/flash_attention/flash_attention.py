"""Loader and wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the reference's Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``:
causal GQA attention (KV head ``h // G``) with an optional sliding
``window`` and a ``q_offset``, f32 inside, output in ``q.dtype``. The kernel
reads the model layout ``(B, S, H, D)`` through strides, so the reference
wrapper's transposes are gone. The library is built at first use
(``kernels.build``); ``flash_attention_cuda`` takes CUDA tensors only and
``KERNEL.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import CudaLibrary, check_tensor

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


class FlashAttentionKernel(CudaLibrary):
    """The built library, its build report and the launch counter."""

    def __init__(self):
        super().__init__("flash_attention", _SRC)
        self.launches = 0

    def bind(self, lib: ctypes.CDLL) -> None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 7 + [ll] * 9 + [i] * 3 + [ctypes.c_float, p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int


KERNEL = FlashAttentionKernel()


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES}, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must be "
                         "(B, S, H, D) and (B, Sk, KH, D)")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for name, t, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Sk, KH, D)),
                           ("v", v, (B, Sk, KH, D))):
        check_tensor(name, t, q.dtype, shape, q.device, strided=True)


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,  # (B, Sk, KH, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Attention through the CUDA kernel on PyTorch's current stream:
    ``(B, Sq, H, D)`` in ``q.dtype``, the contract of
    ``ref.flash_attention_ref``."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    lib = KERNEL.build()
    with torch.cuda.device(q.device):
        out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Sq, Sk, H, KH, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), window or 0, q_offset, D**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    KERNEL.launches += 1
    return out
