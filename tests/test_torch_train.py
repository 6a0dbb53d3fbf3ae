"""The port's training slice (``repro_torch.models.forward``/``loss_fn``,
``repro_torch.train``, ``repro_torch.launch.train``) against the reference
on the CPU at smoke width, in f32 (``params_dtype`` and
``activations_dtype`` float32), on weights carried by ``params_from_jax``.

- ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn`` for ``smollm-135m`` (tied embeddings,
  G = 3), ``stablelm-1.6b`` (layernorm), ``moonshot-v1-16b-a3b`` (the MoE
  load-balance loss), ``hymba-1.5b`` (SSD heads beside sliding-window
  attention), ``deepseek-v2-236b`` (MLA) and ``musicgen-medium`` (frames,
  sinusoidal positions). The port's plain attention and SSD scan are the
  reference's functions summed in another order: loss and metrics within
  1e-5, each gradient leaf within 2e-5 x its largest |.| (measured up to
  4.8e-6 on hymba).
- ``cosine_lr``, ``clip_by_global_norm`` and ``adamw_update`` on identical
  inputs: both compute in f32 in the same order, within a few ulps
  (rtol 1e-6).
- One ``build_train_step`` step: loss and grad norm within 1e-5, and the
  updated parameters within 2 lr everywhere (a first Adam step moves each
  weight by about lr x sign(g), so a gradient that rounds to opposite
  signs in the two frameworks moves it 2 lr apart) and within 1e-6 on all
  but 1e-3 of the weights.
- ``train`` for 3 steps: every loss within 1e-5, every grad norm within
  the 1e-3 that the reference's log line prints.
- ``accum=4`` against the full batch (the reference's own test and its
  1e-4 tolerances); ``remat="block"`` against ``"none"`` (identical);
  ``synthetic_batch`` bit-equal to the reference's; ``abstract_init``,
  ``configs.get_shape`` and ``cells`` equal to the reference's; the CLI
  with ``--smoke --device cpu``.
"""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import RunConfig as JaxRun
from repro.models import abstract_init as jax_abstract_init
from repro.models import model_init as jax_init
from repro.models.model import loss_fn as jax_loss_fn
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_state as jax_init_state
from repro.train import optim as joptim
from repro.train import synthetic_batch as jax_batch
from repro.train import train as jax_train
from repro.train import LoopConfig as JaxLoop
from repro_torch import configs
from repro_torch.models import (
    RunConfig,
    abstract_init,
    loss_fn,
    make_train_step,
    params_from_jax,
    value_and_grad,
)
from repro_torch.models.layers import tree_flatten, tree_leaves, tree_map
from repro_torch.train import (
    LoopConfig,
    adamw_update,
    build_train_step,
    clip_by_global_norm,
    cosine_lr,
    init_state,
    synthetic_batch,
    train,
)

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["smollm-135m", "stablelm-1.6b", "moonshot-v1-16b-a3b", "hymba-1.5b",
         "deepseek-v2-236b", "musicgen-medium"]
RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              params_dtype="float32", activations_dtype="float32",
              learning_rate=3e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_paths(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pair(name: str, seed: int = 0):
    """(reference cfg, run, params; port cfg, run, params), the port's
    parameters copied from the reference's."""
    jcfg, cfg = jconfigs.SMOKES[name], configs.SMOKES[name]
    jrun, run = JaxRun(**RUN_KW), RunConfig(**RUN_KW)
    # jitted: the same kind of draws, in a third of the eager init's time
    jp = jax.jit(lambda k: jax_init(k, jcfg, jrun)[0])(
        jax.random.PRNGKey(seed))
    tp = params_from_jax(_np_tree(jp), cfg, run, device="cpu")
    return jcfg, jrun, jp, cfg, run, tp


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_leaf_match_reference(name):
    jcfg, jrun, jp, cfg, run, tp = _pair(name)
    jb = jax_batch(jcfg, 2, 32, 0, 3)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, jb, jcfg, jrun), has_aux=True))(jp)
    (tl, tm), tg = value_and_grad(
        lambda p: loss_fn(p, _torch_batch(jb), cfg, run), tp)
    assert abs(float(tl) - float(jl)) <= 1e-5
    for key in ("ce", "z_loss", "moe_aux"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5, key
    if cfg.moe:
        assert float(tm["moe_aux"]) > 0
    want = _jax_paths(jg)
    got = tree_flatten(tg)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        w = want[path]
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 2e-5 * scale, path


@pytest.mark.parametrize("name", ["smollm-135m", "musicgen-medium"])
def test_synthetic_batch_bit_equal_to_reference(name):
    for step in (0, 17):
        want = jax_batch(jconfigs.SMOKES[name], 3, 40, 5, step)
        got = synthetic_batch(configs.SMOKES[name], 3, 40, 5, step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == torch.from_numpy(w.copy()).dtype
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_cosine_lr_clip_and_adamw_match_reference():
    rng = np.random.default_rng(4)
    run, jrun = RunConfig(**RUN_KW), JaxRun(**RUN_KW)
    jlr, tlr = joptim.cosine_lr(jrun, 3, 20), cosine_lr(run, 3, 20)
    for step in range(0, 25):
        np.testing.assert_allclose(float(tlr(step)),
                                   float(jlr(jnp.int32(step))), rtol=1e-6)
    shapes = {"a": {"w": (7, 5)}, "b": (11,), "c": {"d": (3, 4, 2)}}
    mk = lambda: tree_map_np(lambda s: rng.standard_normal(s, np.float32),
                             shapes)
    params, grads = mk(), mk()
    grads["b"] *= 40.0  # a norm above 1: the clip scales
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads))
    tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, grads))
    assert float(jn) > 1
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for (path, g), w in zip(tree_flatten(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8, err_msg=path)
    jstate = joptim.init_state(jax.tree.map(jnp.asarray, params))
    tstate = init_state(tree_map(lambda a: torch.from_numpy(a.copy()),
                                 params))
    for _ in range(3):  # warm-up steps and after: bias corrections move
        jstate = joptim.adamw_update(jstate, jax.tree.map(jnp.asarray, grads),
                                     jrun, jlr)
        tstate = adamw_update(tstate, tree_map(torch.from_numpy, grads), run,
                              tlr)
        assert int(tstate.step) == int(jstate.step)
        for part in ("params", "m", "v"):
            for (path, a), b in zip(tree_flatten(getattr(tstate, part)),
                                    jax.tree.leaves(getattr(jstate, part))):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{part}/{path}")


def tree_map_np(fn, shapes):
    if isinstance(shapes, dict):
        return {k: tree_map_np(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def test_one_train_step_matches_reference():
    jcfg, jrun, jp, cfg, run, tp = _pair("smollm-135m")
    jb = jax_batch(jcfg, 4, 32, 0, 0)
    jstate, jm = jax.jit(jax_build_train_step(jcfg, jrun))(
        jax_init_state(jp), jb)
    tstate, tm = build_train_step(cfg, run)(init_state(tp), _torch_batch(jb))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    lr = float(jm["lr"])
    want = _jax_paths(jstate.params)
    diffs = np.concatenate([np.abs(p.numpy() - want[path]).ravel()
                            for path, p in tree_flatten(tstate.params)])
    assert diffs.max() <= 2 * lr * (1 + 1e-5)
    assert (diffs > 1e-6).mean() <= 1e-3, (diffs > 1e-6).mean()


def test_three_step_train_matches_reference_loss_and_grad_norm(
        capsys, monkeypatch):
    """The loops on the same weights: the port's ``train`` draws from a
    ``torch.Generator``, so its ``model_init`` is handed the reference's
    parameters (``PRNGKey(seed)``) through ``params_from_jax``."""
    import repro_torch.train.loop as loop_mod

    name = "smollm-135m"
    jcfg, jrun, jp, _, _, _ = _pair(name)
    loop = dict(steps=3, batch=4, seq=32, seed=0, log_every=1)
    jres = jax_train(jcfg, jrun, JaxLoop(**loop))
    jnorms = [float(m) for m in re.findall(r"gnorm (\S+)",
                                           capsys.readouterr().out)]
    monkeypatch.setattr(loop_mod, "model_init", lambda seed, cfg, run, device:
                        (params_from_jax(_np_tree(jp), cfg, run, device),
                         abstract_init(cfg, run)[1]))
    tres = train(configs.SMOKES[name], RunConfig(**RUN_KW), LoopConfig(**loop),
                 device="cpu")
    assert len(tres.losses) == len(jres.losses) == 3 == len(jnorms)
    np.testing.assert_allclose(tres.losses, jres.losses, atol=1e-5)
    np.testing.assert_allclose(tres.grad_norms, jnorms, atol=1e-3)
    assert len(tres.step_ms) == 3 and tres.final_step == 3


def clone_state(state):
    """A copy of ``state``: a step updates its tensors in place."""
    return type(state)(*(tree_map(torch.clone, part) for part in state))


def test_grad_accumulation_matches_full_batch():
    cfg, run = configs.SMOKES["smollm-135m"], RunConfig(**RUN_KW)
    from repro_torch.models import model_init

    state = init_state(model_init(0, cfg, run, device="cpu")[0])
    batch = synthetic_batch(cfg, 8, 32, seed=0, step=0)
    s1, m1 = build_train_step(cfg, run, accum=1)(clone_state(state), batch)
    s2, m2 = build_train_step(cfg, run, accum=4)(clone_state(state), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 1e-4


def test_remat_block_recomputes_the_same_gradients():
    _, _, _, cfg, run, tp = _pair("stablelm-1.6b")
    batch = synthetic_batch(cfg, 2, 32, 0, 1)
    outs = [value_and_grad(lambda p: loss_fn(p, batch, cfg, r), tp)
            for r in (run, dataclasses.replace(run, remat="block"))]
    (l0, _), g0 = outs[0]
    (l1, _), g1 = outs[1]
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_make_train_step_runs_the_optimizer_on_the_loss_gradients():
    _, _, _, cfg, run, tp = _pair("smollm-135m")
    batch = synthetic_batch(cfg, 2, 32, 0, 2)

    class Optimizer:
        def update(self, state, grads):
            return adamw_update(state, grads, run)

    state, metrics = make_train_step(cfg, run, Optimizer())(
        init_state(tree_map(torch.clone, tp)), batch)
    (loss, _), _ = value_and_grad(lambda p: loss_fn(p, batch, cfg, run), tp)
    assert torch.equal(metrics["loss"], loss) and int(state.step) == 1
    assert not torch.equal(state.params["embed"]["table"],
                           tp["embed"]["table"])


def test_abstract_init_shapes_and_shape_registry_match_reference():
    name = "deepseek-v2-236b"
    jshapes, _ = jax_abstract_init(jconfigs.ARCHS[name], JaxRun())
    got = tree_flatten(abstract_init(
        configs.ARCHS[name], RunConfig(activations_dtype="float32"))[0])
    want = {p: tuple(s.shape) for p, s in
            ((k, v) for k, v in _jax_shapes(jshapes).items())}
    assert {p: tuple(t.shape) for p, t in got} == want
    assert all(t.device.type == "meta" for _, t in got)
    assert configs.cells() == jconfigs.cells()
    assert configs.cells("hymba-1.5b") == jconfigs.cells("hymba-1.5b")
    for s in jconfigs.SHAPES:
        assert dataclasses.asdict(configs.get_shape(s)) == \
            dataclasses.asdict(jconfigs.get_shape(s))


def _jax_shapes(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--steps", "4", "--batch", "2", "--seq",
         "32", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr
    assert re.search(r"done: 4 steps, loss \S+ -> \S+", out.stdout), out.stdout
