"""The port stands alone: no ``jax`` and nothing of ``repro`` in its import
graph or its sources, and no quiet CPU fallback when the card is missing."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.noc import NoCConfig, synthetic_workload, xsimulate
from repro_torch.noc.xsim.compile import planes_from_numpy, traffic_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, prefix="repro_torch."
        )
    )


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.noc_cycle.noc_cycle" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_sources_import_neither_jax_nor_repro():
    pat = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
        re.M,
    )
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NoCConfig(n=4)
    wl = synthetic_workload(cfg, 0.05, 10, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xsimulate(cfg, [wl], ("MU",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        traffic_from_numpy({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planes_from_numpy([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    assert repro_torch.resolve_device("cpu").type == "cpu"
