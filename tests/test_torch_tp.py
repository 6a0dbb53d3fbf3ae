"""Training on a mesh with a ``model`` axis (tensor parallelism) and MoE
models over data ranks, against one process and against the reference.

The port runs on four gloo ranks on the CPU, once for the module
(``launch.mesh.spawn_ranks``; the rank code is ``tests/torch_tp_ranks.py``,
which imports no JAX), the reference in a subprocess of this file with 4
forced host devices on a mesh with Auto axes, as
``tests/test_torch_zero1.py`` builds it (``jax.make_mesh``'s Explicit axes
break the reference's step under JAX 0.9). Every run is a smoke config in
f32 (``RUN_KW``: the vocabulary padded to a multiple of 96, so that the
last vocabulary block holds padding) from the port's seeded
``model_init``, on ``synthetic_batch`` (bit-equal in the two packages),
B = 4, S = 32, through ``train`` with ZeRO-1 and a final gathered
checkpoint.

- **(2, 2) ``("data", "model")``**: all ten configurations, one step each
  (smollm three), equal ``train`` in one process: losses and grad norms
  within 1e-5, the gathered parameters under the rule of
  ``tests/test_torch_train.py``'s one step (max diff at most 2 lr, at most
  1e-3 of the elements beyond 1e-6).
- **The reference**: smollm (3 steps), moonshot (MoE over the data ranks,
  experts over ``model``), deepseek (MLA + MoE) and mamba2 (SSD) against
  the reference's jitted ``build_train_step`` under
  ``launch.specs.train_cell``'s ZeRO-1 shardings on the Auto (2, 2) mesh,
  under the same tolerances.
- **A 4-rank ``model`` axis**: smollm, whose 6 q and 2 kv heads of 16 then
  split mid-head, equals one process; so do smollm, deepseek, moonshot
  and hymba on a 3-rank ``model`` axis, which leaves whole what 3 does
  not divide (smollm's k/v, MLA's heads split mid-head in ``wuq`` alone,
  the experts, the SSD's ``out_proj``), smollm on (2, 2) under
  ``remat="block"`` and moonshot in 2 microbatches; one process resumed
  from the (2, 2) ranks' checkpoint equals its uninterrupted run.
- **Blocks**: each rank's forward receives its ``model`` block of every
  leaf that ``tree_shardings`` splits over ``model``; no parameter leaf is
  gathered over ``model`` except the SSD block's small leaves (its
  ``in_proj`` split does not fall on the z/x/B/C/dt edges), and
  activations are gathered only where heads split (the q/k/v columns) and
  for the MoE router's logits and the SSD ``in_proj`` output.
"""
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the reference's side, in its own process
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 300
LR = R.RUN_KW["learning_rate"]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


# --------------------------------------------------------------- reference
def _reference(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import SMOKES
    from repro.launch.specs import train_cell
    from repro.models.config import ShapeConfig
    from repro.train import build_train_step, cosine_lr, init_state
    from repro.train import synthetic_batch

    assert jax.device_count() == 4, jax.devices()
    tmp = Path(tmp)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    shape = ShapeConfig("tp", "train", R.LOOP_KW["seq"], R.LOOP_KW["batch"])
    out = {}
    for name in R.REF_NAMES:
        cfg, steps = SMOKES[name], R.steps_of(name)
        cell = train_cell(cfg, shape, mesh, run_overrides=R.RUN_KW)
        init = dict(np.load(tmp / f"init_{name}.npz"))
        state = init_state(jax.tree.map(jnp.asarray, _nest(init)))
        step = jax.jit(build_train_step(cfg, cell.run, lr_fn=cosine_lr(
            cell.run, warmup=2, total=steps)),
            in_shardings=cell.in_shardings,
            out_shardings=cell.out_shardings, donate_argnums=0)
        losses, norms = [], []
        for s in range(steps):
            batch = synthetic_batch(cfg, R.LOOP_KW["batch"], R.LOOP_KW["seq"],
                                    R.LOOP_KW["seed"], s)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/grad_norms"] = np.array(norms)
        for path, x in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            key = "/".join(str(k.key) for k in path)
            out[f"{name}/params/{key}"] = np.asarray(x)
    np.savez(tmp / "ref.npz", **out)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess beside the four ranks, then the
    one-process runs."""
    import torch

    from repro_torch.configs import SMOKES
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_flatten

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_tp")
    for name in R.REF_NAMES:
        params, _ = model_init(R.LOOP_KW["seed"], SMOKES[name],
                               R.run_config(), device="cpu")
        np.savez(tmp / f"init_{name}.npz", **{
            k: t.numpy() for k, t in tree_flatten(params)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        ranks = spawn_ranks(R.mesh_ranks, 4, (str(tmp),),
                            out_dir=tmp / "ranks", device_type="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
        m3 = spawn_ranks(R.m3_ranks, 3, (str(tmp),), out_dir=tmp / "m3r",
                         device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
        one = {name: R.one_process(name, tmp / "one" / name)
               for name in R.NAMES}
        one["accum"] = R.one_process(R.ACCUM_NAME, tmp / "one" / "accum",
                                     accum=2)
        log, _ = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    torch.set_num_threads(n_threads)
    assert ref.returncode == 0, log[-4000:]
    yield {"ref": dict(np.load(tmp / "ref.npz")), "ranks": ranks,
           "m3": m3, "one": one, "tmp": tmp}


def _assert_rule(got: dict, want: dict, what: str) -> None:
    """The rule of ``tests/test_torch_train.py``'s one step over every
    parameter leaf of ``want``."""
    assert set(got) == set(want), what
    diffs = np.concatenate([np.abs(got[k] - w).ravel()
                            for k, w in want.items()])
    assert diffs.max() <= 2 * LR * (1 + 1e-5), (what, diffs.max())
    assert (diffs > 1e-6).mean() <= 1e-3, (what, (diffs > 1e-6).mean())


def _assert_run(got: dict, losses, norms, what: str) -> None:
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=0, atol=1e-5,
                               err_msg=what)


# --------------------------------------------------------------- (2, 2)
@pytest.mark.parametrize("name", R.NAMES)
def test_each_configuration_on_a_data_model_mesh_equals_one_process(
        runs, name):
    res, params = runs["one"][name]
    for r, got in enumerate(runs["ranks"]):
        _assert_run(got[name], res.losses, res.grad_norms, f"{name} r{r}")
    whole = R.ckpt_params(runs["tmp"] / "dm" / name, R.steps_of(name))
    _assert_rule(whole, params, name)


@pytest.mark.parametrize("name", R.REF_NAMES)
def test_data_model_mesh_equals_the_references_jitted_step(runs, name):
    ref = runs["ref"]
    for r, got in enumerate(runs["ranks"]):
        _assert_run(got[name], ref[f"{name}/losses"],
                    ref[f"{name}/grad_norms"], f"{name} r{r}")
    prefix = f"{name}/params/"
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    whole = R.ckpt_params(runs["tmp"] / "dm" / name, R.steps_of(name))
    _assert_rule(whole, want, f"{name} vs reference")


# --------------------------------------------------------------- mid-head
def test_heads_split_mid_head_on_a_four_rank_model_axis(runs):
    name = R.M4_NAME
    res, params = runs["one"][name]
    for r, got in enumerate(runs["ranks"]):
        _assert_run(got["m4"], res.losses, res.grad_norms, f"m4 r{r}")
        # smollm's q (96 columns) and k/v (32) in blocks of 24 and 8: the
        # ranks gather the columns of their heads, and no parameter
        gathered = {g["shape"][-1] for g in got["m4"]["gathers"]
                    if not g["param"]}
        assert gathered == {24, 8}, gathered
        assert not any(g["param"] for g in got["m4"]["gathers"])
    _assert_rule(R.ckpt_params(runs["tmp"] / "m4", R.steps_of(name)),
                 params, "m4")


@pytest.mark.parametrize("name", R.M3_NAMES)
def test_dims_that_three_ranks_do_not_divide_stay_whole(runs, name):
    """On a 3-rank ``model`` axis the rule keeps whole what 3 does not
    divide: the regions whose output every rank computes whole (MLA's
    heads, the experts, the SSD's ``out_proj``) equal one process."""
    # (width, a parameter?) of what is gathered: smollm's q columns (96
    # of 6 x 16), deepseek's (wuq, 192 of 4 x 48), hymba's in_proj output
    # (552) and conv leaves (288 channels); moonshot gathers nothing
    want = {"smollm-135m": {(32, False)}, "deepseek-v2-236b": {(64, False)},
            "moonshot-v1-16b-a3b": set(),
            "hymba-1.5b": {(184, False), (96, True)}}[name]
    res, params = runs["one"][name]
    for r, got in enumerate(runs["m3"]):
        _assert_run(got[name], res.losses, res.grad_norms, f"m3 {name} r{r}")
        assert {(g["shape"][-1], g["param"])
                for g in got[name]["gathers"]} == want
    _assert_rule(R.ckpt_params(runs["tmp"] / "m3" / name, R.steps_of(name)),
                 params, f"m3 {name}")


def test_remat_block_on_the_mesh_equals_one_process(runs):
    """``remat="block"`` recomputes each layer, its collectives included,
    in the backward: the same function."""
    res, params = runs["one"][R.M4_NAME]
    for r, got in enumerate(runs["ranks"]):
        _assert_run(got["remat"], res.losses, res.grad_norms, f"remat r{r}")
    _assert_rule(R.ckpt_params(runs["tmp"] / "remat",
                               R.steps_of(R.M4_NAME)), params, "remat")


def test_microbatches_on_the_mesh_equal_one_process(runs):
    """``accum=2`` on the (2, 2) mesh: each rank takes its block of each
    global microbatch (``DataParallel.rows``), so a MoE layer's capacity,
    slots and load-balance loss are each microbatch's, as in one
    process."""
    res, params = runs["one"]["accum"]
    for r, got in enumerate(runs["ranks"]):
        _assert_run(got["accum"], res.losses, res.grad_norms, f"accum r{r}")
    _assert_rule(R.ckpt_params(runs["tmp"] / "accum",
                               R.steps_of(R.ACCUM_NAME)), params, "accum")


def test_a_tensor_parallel_checkpoint_resumes_in_one_process(runs):
    """The (2, 2) ranks' last checkpoint (whole leaves, gathered over
    ``model`` and ``data``) restored by ``train`` in one process and
    trained a step on equals the uninterrupted one-process run."""
    import shutil

    import repro_torch.train as T
    from repro_torch.configs import SMOKES

    name, tmp = R.M4_NAME, runs["tmp"]
    steps = R.steps_of(name)
    step_dir = f"step_{steps:08d}"
    shutil.copytree(tmp / "dm" / name / step_dir, tmp / "resumed" / step_dir)
    whole = T.train(SMOKES[name], R.run_config(),
                    R.loop_config(steps + 1, str(tmp / "whole")),
                    device="cpu")
    resumed = T.train(SMOKES[name], R.run_config(),
                      R.loop_config(steps + 1, str(tmp / "resumed")),
                      device="cpu")
    assert resumed.resumed_from == steps
    np.testing.assert_allclose(resumed.losses, whole.losses[steps:],
                               rtol=0, atol=1e-5)
    _assert_rule(R.ckpt_params(tmp / "resumed", steps + 1),
                 R.ckpt_params(tmp / "whole", steps + 1), "resumed")


# --------------------------------------------------------------- blocks
def test_each_rank_runs_on_its_model_blocks(runs):
    """For every configuration on (2, 2): the forward's parameters are the
    ``model`` blocks of ``tree_shardings`` (the data axes gathered); the
    only gathers over ``model`` are the ones the module docstring
    names."""
    from repro_torch.configs import SMOKES
    from repro_torch.dist.sharding import (abstract_mesh, shard_slices,
                                           tree_shardings)
    from repro_torch.models import abstract_init
    from repro_torch.models.layers import tree_flatten

    mesh = abstract_mesh(("data", 2), ("model", 2))
    for name in R.NAMES:
        cfg = SMOKES[name]
        shapes, specs = abstract_init(cfg, R.run_config())
        blocks = dict(tree_flatten(tree_shardings(specs, shapes, mesh)))
        split = 0
        n_moe = sum(c for k, c in cfg.layout if k.endswith("_moe"))
        n_ssd = sum(c for k, c in cfg.layout if k in ("ssd", "hymba_g",
                                                      "hymba_w"))
        for got in runs["ranks"]:
            seen = got[name]["forward_shapes"]
            assert set(seen) == set(blocks), name
            for path, t in tree_flatten(shapes):
                sl = shard_slices(blocks[path], t.shape, mesh, got["coords"])
                want = tuple(s.stop - s.start for s in sl)
                assert seen[path] == want, (name, path, seen[path], want)
                split += want != tuple(t.shape)
            gathers = got[name]["gathers"]
            params = [g for g in gathers if g["param"]]
            acts = [g for g in gathers if not g["param"]]
            steps = R.steps_of(name)
            if name in R.SSD_NAMES:
                # conv_w, conv_b, A_log, D, dt_bias, norm_scale a layer
                assert len(params) == 6 * n_ssd * steps, (name, params)
                assert all(len(g["shape"]) <= 2 for g in params), name
            else:
                assert not params, (name, params)
            # smoke heads split into whole heads on two ranks: only the MoE
            # router's logits and the SSD in_proj output are gathered
            assert len(acts) == (n_moe + n_ssd) * steps, (name, acts)
        assert split > 0, name


if __name__ == "__main__":
    _reference(sys.argv[1])
