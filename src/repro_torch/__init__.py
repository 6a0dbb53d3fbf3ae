"""PyTorch and CUDA port of the DPM multicast system (twin of ``repro``).

The package mirrors ``repro``'s layout, so every module has a named
reference twin. It imports ``torch`` and numpy, never ``jax`` and nothing
of ``repro``. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
