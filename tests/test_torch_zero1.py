"""ZeRO-1 training over data ranks and the elastic re-shard of
``ckpt.restore``, against one process and against the reference.

The port runs on gloo ranks on the CPU (``launch.mesh.spawn_ranks``; the
rank code is ``tests/torch_zero1_ranks.py``, which imports no JAX), the
reference in a subprocess of this file with 4 forced host devices on a
mesh with Auto axes, as ``tests/test_torch_dist.py`` does. Everything runs
smollm-135m's smoke config in f32 (``RUN_KW``) from the port's seeded
``model_init``, which the reference's subprocess loads, on
``synthetic_batch`` (bit-equal in the two packages), B = 4, S = 32.

- **ZeRO-1**: ``train`` on a (4,) ``data`` mesh in ``shardctx`` for 3
  steps against ``train`` in one process on the global batch and against
  the reference's jitted ``build_train_step`` under
  ``launch.specs.train_cell``'s ZeRO-1 shardings: losses and grad norms
  within 1e-5; the final parameters under the rule of
  ``tests/test_torch_train.py``'s one step (max diff at most 2 lr, at most
  1e-3 of the elements beyond 1e-6). Each rank's master, ``m`` and ``v``
  blocks are the blocks that the reference's ``devices_indices_map`` gives
  its device, of the whole leaves its checkpoint gathered, bit for bit;
  its state bytes are what those blocks imply; with ``zero1=False`` every
  rank holds the whole state. A mesh axis other than ``pod``, ``data`` and
  ``model`` raises ``NotImplementedError`` (a ``model`` axis and MoE over
  data ranks train: ``tests/test_torch_tp.py``).
- **Elastic restore**: the four ranks' step-2 checkpoint restored on 2
  ranks (ZeRO-1 blocks) and onto a (2, 2) ``("data", "model")`` mesh
  (``tree_shardings``), each block equal to the reference's index map of
  the file, and a checkpoint that the reference wrote restored on 2 ranks
  the same way; training on to step 4 on 2 ranks and in one process
  equals the uninterrupted one-process run under the rule.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the reference's side, in its own process
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_zero1_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
LR = R.RUN_KW["learning_rate"]


def _nest(flat: dict) -> dict:
    """Nested dicts from ``{"a/b/c": leaf}``."""
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
    from jax.sharding import Mesh, NamedSharding

    from repro.ckpt import save
    from repro.configs import SMOKES
    from repro.dist.sharding import tree_shardings, zero1_shardings
    from repro.launch.specs import train_cell
    from repro.models import abstract_init
    from repro.models.config import ShapeConfig
    from repro.train import build_train_step, cosine_lr, init_state
    from repro.train import synthetic_batch

    assert jax.device_count() == 4, jax.devices()
    tmp = Path(tmp)
    devs = jax.devices()
    cfg = SMOKES[R.NAME]
    mesh4 = Mesh(np.array(devs[:4]), ("data",))
    shape = ShapeConfig("zero1", "train", R.LOOP_KW["seq"],
                        R.LOOP_KW["batch"])
    cell = train_cell(cfg, shape, mesh4, run_overrides=R.RUN_KW)
    run = cell.run
    init = dict(np.load(tmp / "init.npz"))
    state = init_state(jax.tree.map(jnp.asarray, _nest(init)))
    lr_fn = cosine_lr(run, warmup=2, total=R.STEPS)
    step = jax.jit(build_train_step(cfg, run, lr_fn=lr_fn),
                   in_shardings=cell.in_shardings,
                   out_shardings=cell.out_shardings, donate_argnums=0)
    out = {"losses": [], "grad_norms": []}
    for s in range(R.STEPS):
        batch = synthetic_batch(cfg, R.LOOP_KW["batch"], R.LOOP_KW["seq"],
                                R.LOOP_KW["seed"], s)
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if s + 1 == R.CKPT_AT:
            save(tmp / "ref_ckpt", R.CKPT_AT, state)
    for path, x in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"params/{key}"] = np.asarray(x)
    # each device's block of every parameter leaf: ZeRO-1 on the (4,) mesh
    # of the cell and on (2,), tree_shardings on (2, 2)
    shapes, specs = abstract_init(cfg, run)
    meshes = {
        "z4": (cell.in_shardings[0].params, 4),
        "z2": (zero1_shardings(specs, shapes, Mesh(np.array(devs[:2]),
                                                   ("data",))), 2),
        "dm": (tree_shardings(specs, shapes, Mesh(
            np.array(devs[:4]).reshape(2, 2), ("data", "model"))), 4),
    }
    for name, (tree, n) in meshes.items():
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        for path, sh in flat:
            key = "/".join(str(k.key) for k in path)
            leaf_shape = init[key].shape
            idx = sh.devices_indices_map(leaf_shape)
            for r in range(n):
                out[f"idx_{name}/{key}/r{r}"] = np.array(
                    [sl.indices(d)[:2] for sl, d in zip(idx[devs[r]],
                                                        leaf_shape)],
                    dtype=np.int64).reshape(len(leaf_shape), 2)
    np.savez(tmp / "ref.npz", **{k: np.asarray(v) for k, v in out.items()})


# --------------------------------------------------------------- fixtures
def _one_process(steps: int, ckpt_dir: Path):
    from repro_torch.configs import SMOKES

    return R.train_kept(SMOKES[R.NAME], R.run_config(),
                        R.loop_config(steps, str(ckpt_dir)), None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess (beside the four ranks), the four ranks,
    then the two ranks, and the one-process runs."""
    import torch

    from repro_torch.configs import SMOKES
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import model_init

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_zero1")
    params, _ = model_init(R.LOOP_KW["seed"], SMOKES[R.NAME],
                           R.run_config(), device="cpu")
    np.savez(tmp / "init.npz", **R.flat_np(params))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        four = spawn_ranks(R.four_ranks, 4, (str(tmp),),
                           out_dir=tmp / "ranks4", device_type="cpu",
                           timeout_s=SPAWN_TIMEOUT_S)
        log, _ = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    step_dir = f"step_{R.CKPT_AT:08d}"
    for d in ("elastic2", "elastic1"):
        shutil.copytree(tmp / "zero1" / step_dir, tmp / d / step_dir)
    two = spawn_ranks(R.two_ranks, 2, (str(tmp),), out_dir=tmp / "ranks2",
                      device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
    one = {"3": _one_process(R.STEPS, tmp / "one3"),
           "4": _one_process(R.ON_TO, tmp / "one4"),
           "resumed": _one_process(R.ON_TO, tmp / "elastic1")}
    torch.set_num_threads(n_threads)
    yield {"ref": dict(np.load(tmp / "ref.npz")), "four": four, "two": two,
           "one": one, "tmp": tmp}


def _assert_rule(got: dict, want: dict, what: str) -> None:
    """The rule of ``tests/test_torch_train.py``'s one step, over every
    parameter leaf of ``want`` (``{path: array}``)."""
    diffs = np.concatenate([np.abs(got[k] - w).ravel()
                            for k, w in want.items()])
    assert diffs.max() <= 2 * LR * (1 + 1e-5), (what, diffs.max())
    assert (diffs > 1e-6).mean() <= 1e-3, (what, (diffs > 1e-6).mean())


def _params(state: dict) -> dict:
    return {k[len(".params/"):]: v for k, v in state.items()
            if k.startswith(".params/")}


def _ckpt(tmp: Path, name: str, step: int) -> dict:
    """The whole leaves of a checkpoint, by ``ckpt`` leaf name."""
    arrays = tmp / name / f"step_{step:08d}" / "arrays"
    return {f.stem.replace("__", "/"): np.load(f)
            for f in arrays.glob("*.npy")}


def _block(full: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return full[tuple(slice(a, b) for a, b in idx)]


# --------------------------------------------------------------- ZeRO-1
def test_zero1_ranks_match_one_process_and_reference(runs):
    ref, four, tmp = runs["ref"], runs["four"], runs["tmp"]
    res3, state3 = runs["one"]["3"]
    for got in four:
        np.testing.assert_allclose(got["losses"], res3.losses, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], res3.grad_norms,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=0, atol=1e-5)
    # the whole parameters the ranks' last save gathered
    whole = _params(_ckpt(tmp, "zero1", R.STEPS))
    _assert_rule(whole, _params(state3), "ranks vs one process")
    _assert_rule(whole, {k[len("params/"):]: v for k, v in ref.items()
                         if k.startswith("params/")}, "ranks vs reference")


def test_zero1_rank_holds_only_its_blocks(runs):
    ref, four, tmp = runs["ref"], runs["four"], runs["tmp"]
    whole = _ckpt(tmp, "zero1", R.STEPS)
    split = 0
    for r, got in enumerate(four):
        state, expect_bytes = got["state"], 4  # the int32 step
        assert set(state) == set(whole)
        for name, block in state.items():
            if name == ".step":
                assert block == R.STEPS
                continue
            path = name.split("/", 1)[1]
            idx = ref[f"idx_z4/{path}/r{r}"]
            want = _block(whole[name], idx)
            np.testing.assert_array_equal(block, want, err_msg=f"{name} r{r}")
            expect_bytes += 4 * want.size
            split += block.size < whole[name].size
        assert sum(a.nbytes for a in state.values()) == expect_bytes
        assert expect_bytes < sum(a.nbytes for a in whole.values())
        # without ZeRO-1 every rank holds the whole state
        np.testing.assert_allclose(got["nozero1_losses"],
                                   got["losses"][:2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["nozero1_grad_norms"],
                                   got["grad_norms"][:2], rtol=0, atol=1e-6)
        for name, a in got["nozero1_state"].items():
            assert a.shape == whole[name].shape, name
    assert split > 0


def test_training_on_a_model_axis_or_moe_over_data_ranks_raises(runs):
    """What training on a mesh still refuses raises: an axis other than
    ``pod``, ``data`` and ``model``. (A ``model`` axis and MoE over data
    ranks train now, against one process and the reference in
    ``tests/test_torch_tp.py``.)"""
    for got in runs["four"]:
        msg = got["other_axis_error"]
        assert "training over mesh axes {'pipe': 4}" in msg, msg


# --------------------------------------------------------------- elastic
def test_checkpoint_restores_on_other_meshes(runs):
    """Four ranks' checkpoint on 2 ranks (ZeRO-1) and on a (2, 2) mesh
    (``tree_shardings``), and saved again from the (2, 2) blocks bit for
    bit; the reference's checkpoint on 2 ranks."""
    ref, tmp = runs["ref"], runs["tmp"]
    again = _ckpt(tmp, "dm_resave", R.CKPT_AT)
    first = _ckpt(tmp, "zero1", R.CKPT_AT)
    assert set(again) == set(first)
    for name, a in first.items():
        np.testing.assert_array_equal(again[name], a, err_msg=name)
        assert again[name].dtype == a.dtype
    cases = [("zero1", "dm", [g["dm_restore"] for g in runs["four"]]),
             ("zero1", "z2", [g["restore"] for g in runs["two"]]),
             ("ref_ckpt", "z2", [g["ref_restore"] for g in runs["two"]])]
    for ckpt, mesh, ranks in cases:
        whole = _ckpt(tmp, ckpt, R.CKPT_AT)
        for r, got in enumerate(ranks):
            assert set(got) == set(whole)
            assert got[".step"] == R.CKPT_AT
            for name, block in got.items():
                if name == ".step":
                    continue
                idx = ref[f"idx_{mesh}/{name.split('/', 1)[1]}/r{r}"]
                np.testing.assert_array_equal(
                    block, _block(whole[name], idx),
                    err_msg=f"{ckpt} on {mesh}: {name} r{r}")


def test_training_on_after_an_elastic_restore(runs):
    res4, state4 = runs["one"]["4"]
    res_one, state_one = runs["one"]["resumed"]
    assert res_one.resumed_from == R.CKPT_AT
    np.testing.assert_allclose(res_one.losses, res4.losses[R.CKPT_AT:],
                               rtol=0, atol=1e-5)
    _assert_rule(_params(state_one), _params(state4), "one process resumed")
    for got in runs["two"]:
        assert got["resumed_from"] == R.CKPT_AT
        np.testing.assert_allclose(got["losses"], res4.losses[R.CKPT_AT:],
                                   rtol=0, atol=1e-5)
    whole = _params(_ckpt(runs["tmp"], "elastic2", R.ON_TO))
    _assert_rule(whole, _params(state4), "two ranks resumed")


def test_spawn_ranks_takes_a_relative_out_dir(tmp_path, monkeypatch):
    """The ranks' ``file://`` rendezvous needs an absolute path: a relative
    ``out_dir`` is resolved against the working directory."""
    from repro_torch.launch.mesh import spawn_ranks

    monkeypatch.chdir(tmp_path)
    got = spawn_ranks(R.rank_and_world, 2, out_dir="ranks",
                      device_type="cpu", timeout_s=60)
    assert got == [(0, 2), (1, 2)]
    assert (tmp_path / "ranks" / "pg_init").parent.is_dir()


if __name__ == "__main__":
    _reference(sys.argv[1])
