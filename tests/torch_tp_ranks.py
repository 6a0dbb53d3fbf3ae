"""The port's side of ``tests/test_torch_tp.py`` on gloo ranks.

``mesh_ranks`` runs on four CPU ranks spawned by
``launch.mesh.spawn_ranks`` and returns plain Python and numpy. This
module imports no JAX: the ranks load it by name.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

NAMES = ("smollm-135m", "stablelm-1.6b", "starcoder2-7b", "qwen1.5-32b",
         "musicgen-medium", "qwen2-vl-72b", "moonshot-v1-16b-a3b",
         "deepseek-v2-236b", "mamba2-1.3b", "hymba-1.5b")
# the reference's jitted step covers these (smollm for 3 steps)
REF_NAMES = ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
             "mamba2-1.3b")
SSD_NAMES = ("mamba2-1.3b", "hymba-1.5b")
# vocab_round=96 pads every smoke vocabulary (512 -> 576, 256 -> 288), so
# the padded columns fall in the last model block
RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=96,
              params_dtype="float32", activations_dtype="float32",
              learning_rate=3e-3)
LOOP_KW = dict(batch=4, seq=32, seed=0, log_every=0)
STEPS = {"smollm-135m": 3}
# the 4-rank model axis: smollm's 6 q / 2 kv heads of 16 split mid-head
M4_NAME = "smollm-135m"
# gradient accumulation on the mesh: each rank's rows of each microbatch
ACCUM_NAME = "moonshot-v1-16b-a3b"
# a 3-rank model axis splits what 3 divides and keeps the rest whole:
# smollm's q mid-head (k/v whole; a rank's span reaching into two kv groups
# widens to both), deepseek's wuq mid-head (wukv, wo whole: every rank
# computes every head), moonshot's vocabulary (its 8 experts and shared
# expert whole), hymba's in_proj and conv (out_proj whole)
M3_NAMES = ("smollm-135m", "deepseek-v2-236b", "moonshot-v1-16b-a3b",
            "hymba-1.5b")


def steps_of(name: str) -> int:
    return STEPS.get(name, 1)


def run_config(**kw):
    from repro_torch.models import RunConfig

    return RunConfig(**dict(RUN_KW, **kw))


def loop_config(steps: int, ckpt_dir=None, accum: int = 1):
    from repro_torch.train import LoopConfig

    return LoopConfig(steps=steps, ckpt_dir=ckpt_dir, accum=accum,
                      **LOOP_KW)


def one_process(name: str, ckpt_dir, accum: int = 1) -> tuple:
    """``train`` in one process: its result and its final parameters
    (``{path: array}``, read back from its last checkpoint)."""
    from repro_torch.configs import SMOKES
    from repro_torch.train import train

    res = train(SMOKES[name], run_config(), loop_config(
        steps_of(name), str(ckpt_dir), accum), device="cpu")
    return res, ckpt_params(Path(ckpt_dir), steps_of(name))


def ckpt_params(ckpt_dir: Path, step: int) -> dict:
    """The whole ``.params`` leaves of a checkpoint, by path."""
    arrays = ckpt_dir / f"step_{step:08d}" / "arrays"
    return {f.stem[len(".params__"):].replace("__", "/"): np.load(f)
            for f in arrays.glob(".params__*.npy")}


def _is_param(t) -> bool:
    """A parameter leaf of the forward or a view of one (a layer of a
    stacked leaf)."""
    base = t._base if t._base is not None else t
    return base.is_leaf and base.requires_grad


def traced_train(name: str, mesh, ckpt_dir: Path, accum: int = 1,
                 **run_kw) -> dict:
    """``train`` under ``mesh`` in ``shardctx``, recording the shapes of the
    parameters that the first forward receives and every tensor gathered
    over ``model`` (a parameter leaf or an activation)."""
    import repro_torch.train.step as step_mod
    from repro_torch.configs import SMOKES
    from repro_torch.dist.comm import TensorParallel
    from repro_torch.models.layers import tree_flatten
    from repro_torch.shardctx import clear_ctx, set_ctx
    from repro_torch.train import train

    seen, gathers = {}, []
    real_loss, real_gather = step_mod.loss_fn, TensorParallel.gather

    def loss_spy(params, *args, **kw):
        if not seen:
            seen.update((k, tuple(t.shape)) for k, t in tree_flatten(params))
        return real_loss(params, *args, **kw)

    def gather_spy(self, t, full, dim=-1):
        if self.split(full):
            gathers.append({"shape": tuple(t.shape), "param": _is_param(t)})
        return real_gather(self, t, full, dim)

    step_mod.loss_fn, TensorParallel.gather = loss_spy, gather_spy
    set_ctx(mesh)
    try:
        res = train(SMOKES[name], run_config(**run_kw),
                    loop_config(steps_of(name), str(ckpt_dir), accum),
                    device="cpu")
    finally:
        clear_ctx()
        step_mod.loss_fn, TensorParallel.gather = real_loss, real_gather
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "forward_shapes": seen, "gathers": gathers}


def mesh_ranks(rank: int, tmp: str, names: tuple = NAMES) -> dict:
    """``names`` (all ten configurations) on a (2, 2) ``("data",
    "model")`` mesh, then ``M4_NAME`` on a (4,) ``model`` mesh and on the
    (2, 2) mesh under ``remat="block"``, and ``ACCUM_NAME`` on (2, 2) in 2
    microbatches, each with ZeRO-1 (the run config's default) and a final
    gathered checkpoint under ``tmp``."""
    from repro_torch.launch.mesh import make_mesh

    tmp = Path(tmp)
    dm = make_mesh((2, 2), ("data", "model"), "cpu")
    m4 = make_mesh((4,), ("model",), "cpu")
    out = {name: traced_train(name, dm, tmp / "dm" / name) for name in names}
    out["m4"] = traced_train(M4_NAME, m4, tmp / "m4")
    # each layer recomputed in the backward, its collectives run again
    out["remat"] = traced_train(M4_NAME, dm, tmp / "remat", remat="block")
    # 2 microbatches: a MoE layer's capacity and slots are each global
    # microbatch's
    out["accum"] = traced_train(ACCUM_NAME, dm, tmp / "accum", accum=2)
    out["coords"] = {a: dm.get_local_rank(a) for a in ("data", "model")}
    return out



def m3_ranks(rank: int, tmp: str) -> dict:
    """``M3_NAMES`` on a (3,) ``model`` mesh."""
    from repro_torch.launch.mesh import make_mesh

    m3 = make_mesh((3,), ("model",), "cpu")
    return {name: traced_train(name, m3, Path(tmp) / "m3" / name)
            for name in M3_NAMES}
