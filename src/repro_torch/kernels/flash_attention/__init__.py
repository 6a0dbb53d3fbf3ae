"""Causal GQA flash attention with an optional sliding window, forward and
backward.

Three-file pattern, as in ``repro.kernels.flash_attention``: ``ref.py``
holds the plain PyTorch attention and its backward (the CPU path and the
kernels' oracles), ``flash_attention.py`` loads and launches the CUDA
kernels in ``csrc/flash_attention.cu`` (forward) and
``csrc/flash_attention_bwd_wgmma.cu`` and ``csrc/flash_attention_bwd.cu``
(backward: the wgmma route and the mma.sync comparison route),
``ops.py`` dispatches by device and carries the gradient.
"""
from .flash_attention import (
    BWD_KERNEL, BWD_WGMMA_LIB, KERNEL, flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from .ops import FlashAttention, flash_attention
from .ref import attention_mask, flash_attention_bwd_ref, flash_attention_ref

__all__ = ["BWD_KERNEL", "BWD_WGMMA_LIB", "FlashAttention", "KERNEL",
           "attention_mask", "flash_attention", "flash_attention_bwd_cuda",
           "flash_attention_bwd_ref", "flash_attention_cuda",
           "flash_attention_ref"]
