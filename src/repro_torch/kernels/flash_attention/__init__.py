"""Causal GQA flash attention with an optional sliding window.

Three-file pattern, as in ``repro.kernels.flash_attention``: ``ref.py``
holds the plain PyTorch attention (the CPU path and the kernel's oracle),
``flash_attention.py`` loads and launches the CUDA kernel in
``csrc/flash_attention.cu``, ``ops.py`` dispatches by device.
"""
from .flash_attention import KERNEL, flash_attention_cuda
from .ops import flash_attention
from .ref import attention_mask, flash_attention_ref

__all__ = ["KERNEL", "attention_mask", "flash_attention",
           "flash_attention_cuda", "flash_attention_ref"]
