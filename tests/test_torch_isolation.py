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
from repro_torch.core import BatchPlanner, bulk_plan, grid
from repro_torch.configs import SMOKES
from repro_torch.kernels.dpm_cost import dpm_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd_scan_kernel
from repro_torch.models import RunConfig, model_init
from repro_torch.noc import NoCConfig, synthetic_workload, xsimulate
from repro_torch.serve import BatchServer, PlanServer, generate
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
    for name in ("repro_torch.kernels.noc_cycle.noc_cycle",
                 "repro_torch.kernels.dpm_cost.dpm_cost",
                 "repro_torch.core.batch_planner",
                 "repro_torch.serve.planserve",
                 "repro_torch.configs.hymba_1_5b",
                 "repro_torch.models.model",
                 "repro_torch.models.convert",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.ssd.ssd",
                 "repro_torch.serve.engine",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.noc_step.noc_step",
                 "repro_torch.kernels.noc_step.ops",
                 "repro_torch.noc.telemetry",
                 "repro_torch.noc.simulator",
                 "repro_torch.noc.trace.ir",
                 "repro_torch.noc.trace.lower",
                 "repro_torch.noc.trace.replay",
                 "repro_torch.dist.multicast",
                 "repro_torch.models.moe",
                 "repro_torch.launch.hlo",
                 "repro_torch.configs.moonshot_v1_16b",
                 "repro_torch.configs.qwen1_5_32b",
                 "repro_torch.configs.stablelm_1_6b",
                 "repro_torch.configs.starcoder2_7b",
                 "repro_torch.configs.deepseek_v2_236b",
                 "repro_torch.configs.musicgen_medium",
                 "repro_torch.configs.qwen2_vl_72b",
                 "repro_torch.train.data",
                 "repro_torch.train.optim",
                 "repro_torch.train.step",
                 "repro_torch.train.loop",
                 "repro_torch.ckpt.checkpoint",
                 "repro_torch.launch.train",
                 "repro_torch.launch.mesh",
                 "repro_torch.shardctx",
                 "repro_torch.dist.comm",
                 "repro_torch.dist.compress",
                 "repro_torch.dist.ep",
                 "repro_torch.dist.pipeline",
                 "repro_torch.dist.sharding",
                 "repro_torch.launch.specs"):
        assert name in mods
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
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
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


def test_batched_planning_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = grid(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchPlanner(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bulk_plan(g, [((0, 0), [(1, 1)])])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dpm_plan(torch.zeros((1, 16), dtype=torch.int32),
                 torch.zeros((1, 2), dtype=torch.int32), n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlanServer(g)
    assert BatchPlanner(g, device="cpu").device.type == "cpu"


def test_serving_refuses_a_missing_card(monkeypatch):
    cfg = SMOKES["smollm-135m"]
    run = RunConfig()
    params, _ = model_init(0, cfg, run, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_init(0, cfg, run)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, cfg, run, torch.zeros((1, 4), dtype=torch.int32), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(params, cfg, run)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flash_attention(q, q, q)
    x, dt = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2))
    bm = torch.zeros((1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssd_scan_kernel(x, dt, torch.zeros(2), bm, bm, 4)
    assert BatchServer(params, cfg, run, device="cpu").device.type == "cpu"


def test_moe_serving_refuses_a_missing_card(monkeypatch):
    """moonshot's init (f32 or bf16 storage) and server raise without a
    card, and so do the MLA and frame models' init and ``generate``."""
    from repro_torch.configs import get_arch

    cfg = SMOKES["moonshot-v1-16b-a3b"]
    run = RunConfig()
    params, _ = model_init(0, cfg, run, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for act in ("float32", "bfloat16"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model_init(0, cfg, RunConfig(activations_dtype=act))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(params, cfg, run)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, cfg, run, torch.zeros((1, 4), dtype=torch.int32), 2)
    for name in ("deepseek-v2-236b", "musicgen-medium", "qwen2-vl-72b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model_init(0, get_arch(name, smoke=True), run)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate(params, get_arch(name, smoke=True), run,
                     torch.zeros((1, 4, 128)), 2)


def test_trace_replay_and_calibration_refuse_a_missing_card(monkeypatch):
    from repro_torch.dist import alltoall_schedule, dp_broadcast_schedule
    from repro_torch.noc import calibrate_cost_model
    from repro_torch.noc.trace import (
        cross_validate, ep_dispatch_trace, pipeline_trace, replay_host,
        replay_xsim,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NoCConfig(n=4)
    tr = pipeline_trace(3, 2)
    for fn in (replay_host, replay_xsim, cross_validate):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(tr, cfg, "DPM")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_cost_model(cfg, synthetic_workload(cfg, 0.05, 10, seed=0),
                             name="refused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ep_dispatch_trace(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        alltoall_schedule(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_broadcast_schedule(6)
    assert replay_host(tr, cfg, device="cpu").total_cycles > 0


def test_training_refuses_a_missing_card(monkeypatch):
    """``train`` and the training CLI default to the card and raise without
    one; the same loop runs with ``device="cpu"``."""
    from repro_torch.launch.train import main as train_cli
    from repro_torch.train import LoopConfig, synthetic_batch, train

    cfg = SMOKES["smollm-135m"]
    run = RunConfig(vocab_round=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loop = LoopConfig(steps=1, batch=1, seq=8, log_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, run, loop)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli(["--arch", "smollm-135m", "--smoke", "--steps", "1"])
    assert train(cfg, run, loop, device="cpu").final_step == 1
    assert synthetic_batch(cfg, 1, 8, 0, 0)["tokens"].device.type == "cpu"
