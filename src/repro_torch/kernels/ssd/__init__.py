"""Mamba-2 SSD intra-chunk kernel and the chunked scan around it.

Three-file pattern, as in ``repro.kernels.ssd``: ``ref.py`` holds the plain
PyTorch intra-chunk pass (the CPU path and the kernel's oracle), ``ssd.py``
loads and launches the CUDA kernel in ``csrc/ssd.cu``, ``ops.py``
dispatches by device and runs the inter-chunk recurrence.
"""
from .ops import ssd_intra_chunk, ssd_scan_kernel
from .ref import ssd_intra_chunk_ref
from .ssd import KERNEL, ssd_intra_chunk_cuda

__all__ = ["KERNEL", "ssd_intra_chunk", "ssd_intra_chunk_cuda",
           "ssd_intra_chunk_ref", "ssd_scan_kernel"]
