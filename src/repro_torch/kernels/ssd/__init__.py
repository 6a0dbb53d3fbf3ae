"""Mamba-2 SSD intra-chunk kernels, forward and backward, and the chunked
scan around them.

Three-file pattern, as in ``repro.kernels.ssd``: ``ref.py`` holds the plain
PyTorch intra-chunk pass and its backward (the CPU path and the kernels'
oracles), ``ssd.py`` loads and launches the CUDA kernels in
``csrc/ssd.cu`` and ``csrc/ssd_bwd.cu``, ``ops.py`` dispatches by device,
wraps the pass in an autograd Function and runs the inter-chunk
recurrence.
"""
from .ops import SsdIntraChunk, ssd_intra_chunk, ssd_scan_kernel
from .ref import ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref
from .ssd import (
    KERNEL, KERNEL_BWD, ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda,
)

__all__ = ["KERNEL", "KERNEL_BWD", "SsdIntraChunk", "ssd_intra_chunk",
           "ssd_intra_chunk_bwd_cuda", "ssd_intra_chunk_bwd_ref",
           "ssd_intra_chunk_cuda", "ssd_intra_chunk_ref", "ssd_scan_kernel"]
