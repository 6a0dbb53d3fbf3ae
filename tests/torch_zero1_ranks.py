"""The port's side of ``tests/test_torch_zero1.py`` on gloo ranks.

``four_ranks`` and ``two_ranks`` run on CPU ranks spawned by
``launch.mesh.spawn_ranks`` and return numpy. This module imports no JAX:
the ranks load it by name.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

NAME = "smollm-135m"
RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              params_dtype="float32", activations_dtype="float32",
              learning_rate=3e-3)
LOOP_KW = dict(batch=4, seq=32, seed=0, log_every=0)
STEPS = 3  # the ZeRO-1 run; it saves at CKPT_AT and at the end
CKPT_AT = 2
ON_TO = 4  # an elastic restore of step CKPT_AT trains on to here


def run_config(**kw):
    from repro_torch.models import RunConfig

    return RunConfig(**dict(RUN_KW, **kw))


def loop_config(steps: int, ckpt_dir=None, ckpt_every: int = 50):
    from repro_torch.train import LoopConfig

    return LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      **LOOP_KW)


def flat_np(tree) -> dict:
    """``{path: array}`` of a ``TrainState`` or nested dicts of tensors,
    paths as ``ckpt`` names its leaves (``.params/g0/...``)."""
    from repro_torch.ckpt.checkpoint import _leaf_paths

    return {n: t.detach().cpu().numpy().copy() for n, t in _leaf_paths(tree)}


def train_kept(cfg, run, loop, mesh) -> tuple:
    """``train`` under ``mesh`` (or none): its result and this rank's state
    as the loop's last ``save`` received it."""
    import repro_torch.train.loop as loop_mod
    from repro_torch.shardctx import clear_ctx, set_ctx

    kept = {}
    real = loop_mod.save

    def spy(ckpt_dir, step, tree, *args, **kw):
        kept[step] = flat_np(tree)
        return real(ckpt_dir, step, tree, *args, **kw)

    loop_mod.save = spy
    if mesh is not None:
        set_ctx(mesh)
    try:
        res = loop_mod.train(cfg, run, loop, device="cpu")
    finally:
        clear_ctx()
        loop_mod.save = real
    return res, kept[loop.steps]


def state_like(cfg, run):
    """A ``TrainState`` of whole-shape ``meta`` leaves: what ``restore``
    reads."""
    import torch

    from repro_torch.models import abstract_init
    from repro_torch.train import TrainState

    shapes, specs = abstract_init(cfg, dataclasses.replace(
        run, activations_dtype="float32"))
    return (TrainState(torch.empty((), dtype=torch.int32, device="meta"),
                       shapes, shapes, shapes), specs, shapes)


def restored(ckpt_dir, step: int, cfg, run, mesh, build) -> tuple:
    """This rank's blocks of checkpoint ``step`` under the spec builder
    ``build`` (``zero1_shardings`` or ``tree_shardings``) on ``mesh``: the
    state and its spec tree."""
    from repro_torch.ckpt import restore
    from repro_torch.train import TrainState

    like, specs, shapes = state_like(cfg, run)
    sh = build(specs, shapes, mesh)
    sh_state = TrainState((), sh, sh, sh)
    return restore(ckpt_dir, step, like, sh_state, mesh=mesh), sh_state


def four_ranks(rank: int, tmp: str) -> dict:
    """ZeRO-1 over (4,) ``data``: ``STEPS`` steps saving at ``CKPT_AT``;
    then ``zero1=False``; the step-``CKPT_AT`` checkpoint restored onto a
    (2, 2) ``("data", "model")`` mesh under ``tree_shardings`` and saved
    again from there; training on a mesh axis other than ``pod``/``data``/
    ``model``, which raises."""
    from repro_torch.ckpt import save
    from repro_torch.configs import SMOKES
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.shardctx import clear_ctx, set_ctx
    from repro_torch.train import train

    tmp = Path(tmp)
    cfg, run = SMOKES[NAME], run_config()
    data = make_mesh((4,), ("data",), "cpu")
    dm = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    res, kept = train_kept(cfg, run, loop_config(STEPS, str(tmp / "zero1"),
                                                 CKPT_AT), data)
    out["losses"], out["grad_norms"] = res.losses, res.grad_norms
    out["state"] = kept
    res, kept = train_kept(cfg, run_config(zero1=False),
                           loop_config(2, str(tmp / "nozero1")), data)
    out["nozero1_losses"], out["nozero1_state"] = res.losses, kept
    out["nozero1_grad_norms"] = res.grad_norms
    state, sh = restored(tmp / "zero1", CKPT_AT, cfg, run, dm, tree_shardings)
    out["dm_restore"] = flat_np(state)
    # saved again from the (2, 2) blocks: one writer, whole leaves
    save(tmp / "dm_resave", CKPT_AT, state, shardings=sh, mesh=dm)
    set_ctx(make_mesh((4,), ("pipe",), "cpu"))
    try:
        train(cfg, run, loop_config(1), device="cpu")
        out["other_axis_error"] = ""
    except NotImplementedError as e:
        out["other_axis_error"] = str(e)
    finally:
        clear_ctx()
    return out


def two_ranks(rank: int, tmp: str) -> dict:
    """On (2,) ``data``: the four ranks' step-``CKPT_AT`` checkpoint and the
    reference's restored under ``zero1_shardings``; then training on from
    the former to ``ON_TO``."""
    from repro_torch.configs import SMOKES
    from repro_torch.dist.sharding import zero1_shardings
    from repro_torch.launch.mesh import make_mesh

    tmp = Path(tmp)
    cfg, run = SMOKES[NAME], run_config()
    data = make_mesh((2,), ("data",), "cpu")
    out = {key: flat_np(restored(tmp / name, CKPT_AT, cfg, run, data,
                                 zero1_shardings)[0])
           for key, name in (("restore", "elastic2"),
                             ("ref_restore", "ref_ckpt"))}
    res, kept = train_kept(cfg, run, loop_config(ON_TO, str(tmp / "elastic2"),
                                                 CKPT_AT), data)
    out["losses"], out["resumed_from"] = res.losses, res.resumed_from
    out["state"] = kept
    return out


def rank_and_world(rank: int) -> tuple:
    import torch.distributed as dist

    return rank, dist.get_world_size()
