"""Build and load of the port's CUDA kernels (``kernels/*/csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/kernels`` at the
root of the checkout, and loaded through ``ctypes``. The library's name
carries a hash of the source and the flags, so an edited source builds anew
and an unchanged one loads the library already built. Nothing is built when
a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", ARCH)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, ``PATH``, then
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


class CudaLibrary:
    """One ``.cu`` source built into one shared library.

    ``build()`` compiles (once per source and flag set), loads the library,
    declares its functions' ctypes signatures (``bind``, which each kernel's
    subclass defines) and returns the ``ctypes.CDLL``; ``build_seconds``
    and ``build_log`` (nvcc's output, ptxas' register and spill report
    included) describe the last build.
    """

    def __init__(self, name: str, source: Path):
        self.name = name
        self.source = source
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None

    def bind(self, lib: ctypes.CDLL) -> None:
        """Set ``argtypes`` and ``restype`` of the library's functions."""

    def build(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"{self.name}_{tag}.so"
        t0 = time.monotonic()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source}:\n{self.build_log}"
                )
            tmp.replace(so)
        lib = ctypes.CDLL(str(so))
        self.bind(lib)
        self.build_seconds = time.monotonic() - t0
        self._lib = lib
        return lib


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device, *,
                 strided: bool = False) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's pointer arguments assume. With ``strided``
    (a kernel that takes the other dims' strides) only the last dim must be
    contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if strided and x.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    if not strided and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
