"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """Resolve an entry point's ``device=`` argument.

    The default is the card. A CUDA device on a host without one raises
    instead of running quietly on the CPU; pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch engine on the CPU"
        )
    return dev
