"""The port's checkpoints (``repro_torch.ckpt``) and resume, against the
reference's layout.

- ``save`` / ``latest_step`` / ``restore`` round trip a ``TrainState`` bit
  for bit (async save included); a step directory without ``COMMITTED``
  is ignored.
- A checkpoint the reference writes (``repro.ckpt.save``) restores in the
  port leaf for leaf, and one the port writes restores in the reference:
  the same leaf names, files and manifest keys.
- ``train`` resumed from a copy of a step-3 checkpoint gives the losses of
  the continuous run's steps 4-6 exactly (the CPU is deterministic and
  the data a pure function of the step).
"""
import pathlib
import shutil

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import latest_step as jax_latest_step
from repro.ckpt import restore as jax_restore
from repro.ckpt import save as jax_save
from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRun
from repro.models import model_init as jax_init
from repro.train import init_state as jax_init_state
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.configs import SMOKES
from repro_torch.models import RunConfig, model_init, params_from_jax
from repro_torch.models.layers import tree_flatten
from repro_torch.train import LoopConfig, init_state, train

RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              params_dtype="float32", activations_dtype="float32",
              learning_rate=3e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(state) -> list:
    return [("step", state.step)] + [
        (f"{part}/{p}", t) for part in ("params", "m", "v")
        for p, t in tree_flatten(getattr(state, part))]


def _state(name="mamba2-1.3b"):
    cfg, run = SMOKES[name], RunConfig(**RUN_KW)
    state = init_state(model_init(0, cfg, run, device="cpu")[0])
    g = torch.Generator().manual_seed(1)
    for _, t in _leaves(state)[1:]:
        t.add_(torch.randn(t.shape, generator=g))
    return state._replace(step=torch.tensor(7, dtype=torch.int32))


@pytest.mark.parametrize("async_", [False, True])
def test_save_latest_restore_round_trip(tmp_path, async_):
    state = _state()
    save(tmp_path, 7, state, async_=async_)()
    assert latest_step(tmp_path) == 7
    back = restore(tmp_path, 7, state)
    for (name, a), (_, b) in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    meta = restore(tmp_path, 7, state._replace(
        params={"final_norm": {"scale": torch.empty(
            state.params["final_norm"]["scale"].shape, device="meta")}},
        m={}, v={}))
    assert torch.equal(meta.params["final_norm"]["scale"],
                       state.params["final_norm"]["scale"])


def test_uncommitted_step_is_ignored(tmp_path):
    state = _state("smollm-135m")
    save(tmp_path, 5, state)
    (pathlib.Path(tmp_path) / "step_00000010" / "arrays").mkdir(parents=True)
    assert latest_step(tmp_path) == 5
    assert latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, 10, state)


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    name = "stablelm-1.6b"
    jcfg, cfg = JAX_SMOKES[name], SMOKES[name]
    jrun, run = JaxRun(**RUN_KW), RunConfig(**RUN_KW)
    jp = jax.jit(lambda k: jax_init(k, jcfg, jrun)[0])(jax.random.PRNGKey(3))
    jstate = jax_init_state(jp)
    jstate = jstate._replace(m=jax.tree.map(lambda x: x + 0.5, jstate.m))
    jax_save(tmp_path / "ref", 4, jstate)
    like = init_state(params_from_jax(jax.tree.map(np.asarray, jp), cfg, run,
                                      device="cpu"))
    got = restore(tmp_path / "ref", 4, like)
    want = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert len(want) == len(_leaves(got))
    ref = {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path): np.asarray(x) for path, x in want}
    for name_, t in _leaves(got):
        np.testing.assert_array_equal(t.numpy(), ref[name_], err_msg=name_)
    # the port's checkpoint in the reference's layout: its files, manifest
    # names and the reference's restore
    save(tmp_path / "port", 4, got)
    assert jax_latest_step(tmp_path / "port") == 4
    ref_files = sorted(p.name for p in (tmp_path / "ref" / "step_00000004"
                                        / "arrays").iterdir())
    port_files = sorted(p.name for p in (tmp_path / "port" / "step_00000004"
                                         / "arrays").iterdir())
    assert port_files == ref_files
    manifests = [msgpack.unpackb((tmp_path / d / "step_00000004" /
                                  "manifest.msgpack").read_bytes())
                 for d in ("ref", "port")]
    assert [m_["name"] for m_ in manifests[0]["leaves"]] == \
        [m_["name"] for m_ in manifests[1]["leaves"]]
    back = jax_restore(tmp_path / "port", 4, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_from_a_checkpoint_gives_the_continuous_losses(tmp_path):
    cfg, run = SMOKES["smollm-135m"], RunConfig(**RUN_KW)
    loop = dict(steps=6, batch=2, seq=32, ckpt_every=3, log_every=0)
    cont = train(cfg, run, LoopConfig(ckpt_dir=str(tmp_path / "a"), **loop),
                 device="cpu")
    assert latest_step(tmp_path / "a") == 6
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train(cfg, run, LoopConfig(ckpt_dir=str(tmp_path / "b"), **loop),
                    device="cpu")
    assert resumed.resumed_from == 3 and len(resumed.losses) == 3
    assert resumed.losses == cont.losses[3:]
    a = restore(tmp_path / "a", 6, _state("smollm-135m"))
    b = restore(tmp_path / "b", 6, _state("smollm-135m"))
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), name
