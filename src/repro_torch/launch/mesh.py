"""Meshes of ranks for ``dist``. Twin of ``repro.launch.mesh``.

The reference's mesh is ``jax.make_mesh`` over the devices JAX sees; here a
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialised process group, one process a rank. Functions, not module
constants: importing this starts nothing.

``init_process`` joins a rank to the group and picks its device and
backend from the hardware: rank ``r`` runs on ``cuda:(r % device_count)``;
the backend is NCCL when every rank has a card of its own and gloo when
ranks share one (NCCL refuses two ranks of one communicator on one card;
gloo then stages point-to-point and all-to-all payloads through host
memory, ``dist.comm``). A backend that fails to initialise raises; nothing
switches to another. ``spawn_ranks`` starts the ranks of one host as
``spawn`` processes and takes all of them down when one fails or the time
runs out.
"""
from __future__ import annotations

import math
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

# hardware constants (roofline): NVIDIA H100 80GB HBM3 (SXM), 700 W, from
# NVIDIA's data sheet; the same figures chip_smoke.py's bounds use
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # B/s per card
NVLINK_BW = 900e9  # B/s per card, NVLink 4 (all links together)


def choose_backend(world_size: int, device_type: str = "cuda") -> str:
    """``"nccl"`` when each of the host's ``world_size`` ranks has a card
    of its own, ``"gloo"`` when ranks share a card or run on the CPU."""
    if device_type == "cpu":
        return "gloo"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device_type='cuda' but no CUDA device is visible; "
                           "pass device_type='cpu' to run the ranks on the "
                           "CPU over gloo")
    return "nccl" if world_size <= n else "gloo"


def init_process(rank: int, world_size: int, init_method: str,
                 device_type: str = "cuda",
                 timeout_s: float = 300.0) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device. Rank 0 prints the backend chosen and why."""
    backend = choose_backend(world_size, device_type)
    if device_type == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    if rank == 0:
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        print(f"[mesh] backend={backend} world={world_size} "
              f"device_type={device_type} cards={cards} "
              f"ranks_per_card={math.ceil(world_size / cards) if cards else 0}",
              flush=True)
    return device


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, which must hold ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_process "
                           "(or spawn_ranks) first")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
    for a in axes:  # every group's communicator made now, on every rank
        dist.barrier(group=mesh.get_group(a))
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks a pod; 2 pods for the multi-pod layout.

    Axes: "pod" (outer data-parallel), "data" (DP within pod), "model"
    (TP/EP within pod). Raises without a process group of that size (the
    dry run's is a ``fake`` one, with ``device_type="cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def _rank_main(rank: int, world_size: int, init_method: str,
               device_type: str, fn, args: tuple, out_dir: str,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    # the group's own timeout outlasts the caller's, which ends the run
    init_process(rank, world_size, init_method, device_type, 2 * timeout_s)
    try:
        result = fn(rank, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args: tuple = (), *, out_dir,
                device_type: str = "cuda", timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` ``spawn`` processes joined
    by a ``file://`` process group under ``out_dir``; return the ranks'
    results in rank order (each saved with ``torch.save`` and loaded back).

    ``fn`` must be importable by name. A rank that fails takes the others
    down and raises ``RuntimeError``; past ``timeout_s`` every rank is
    killed and ``TimeoutError`` raised, so a hang fails one call."""
    import multiprocessing as mp

    out = Path(out_dir).resolve()  # a file:// URL needs an absolute path
    out.mkdir(parents=True, exist_ok=True)
    init = out / "pg_init"
    if init.exists():
        init.unlink()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, f"file://{init}", device_type,
                               fn, args, str(out), timeout_s),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    t_end = time.monotonic() + timeout_s
    try:
        while any(p.exitcode is None for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with code "
                                   f"{bad[0][1]}; the others were stopped")
            if time.monotonic() > t_end:
                raise TimeoutError(f"{world_size} ranks still running after "
                                   f"{timeout_s:.0f} s; all were stopped")
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"rank {bad[0][0]} exited with code "
                               f"{bad[0][1]}")
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
            p.join(timeout=30)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


__all__ = [
    "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16", "choose_backend",
    "init_process", "make_mesh", "make_production_mesh", "spawn_ranks",
]
