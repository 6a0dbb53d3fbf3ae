"""The port's serving model (``repro_torch.models``) against ``repro.models``
at smoke width, on weights carried across by ``params_from_jax``.

- ``params_from_jax`` copies every leaf exactly and refuses a tree that
  differs.
- ``prefill`` logits and every cache tensor, for ``hymba-1.5b`` (global and
  sliding-window GQA in parallel with SSD heads), ``smollm-135m``,
  ``stablelm-1.6b`` (layernorm), ``starcoder2-7b`` (gelu MLP, QKV bias) and
  ``qwen1.5-32b`` (attention only), ``mamba2-1.3b`` (SSD only),
  ``moonshot-v1-16b-a3b`` (attention and a routed + shared MoE FFN),
  ``deepseek-v2-236b`` (MLA, a dense first layer, then MoE),
  ``musicgen-medium`` (frame inputs, sinusoidal positions, layernorm, gelu)
  and ``qwen2-vl-72b`` (frame inputs, M-RoPE, GQA). Frame models take
  seeded numpy frames (B, S, d) where token models take tokens, as the
  reference's ``tests/test_models.py`` builds its batches. In f32 the port runs the
  plain attention and ``ssd_scan`` where the reference runs its chunked
  online-softmax attention and its own ``ssd_scan``: the same functions
  summed in another order, held at atol 1e-4 (logits and caches). In the
  default bf16 activations each framework rounds its bf16 matmuls and
  elementwise ops on its own, a few bf16 ulps apart after 3-4 layers: logits
  (|logit| < 1) at atol 4e-2, caches at atol 0.1 + rtol 0.05.
- ``decode_step`` teacher-forced for 8 steps against the reference's at atol
  2e-3 (``test_models.py``'s tolerance), through the sliding-window ring of
  the smoke window 64: a 60-token prompt wraps the ring during decode, a
  70-token prompt enters decode through the prefill's rolled ring.
- The full-width parameter counts on ``torch.device("meta")`` equal
  ``count_params`` of the reference's ``abstract_init`` (moonshot
  28,888,467,456; deepseek 235,741,434,880; qwen2-vl 71,460,495,360;
  musicgen 1,362,766,848).
- ``model_init`` with bf16 activations stores the leaves that are only
  read as ``.to(x.dtype)`` in bf16 (MLA's ``wukv``, read in f32 by the
  absorbed decode, stays f32): prefill and decode logits with bf16
  activations are bit-identical to those of the f32 run's tree.
- The port serves the reference's ten configurations; an unknown one
  raises. The stream options (``attn_stream_bf16``, ``ssd_stream_bf16``)
  change only their own layers, within bf16 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRun
from repro.models import abstract_init
from repro.models import count_params as jax_count_params
from repro.models import decode_step as jax_decode
from repro.models import init_caches as jax_init_caches
from repro.models import model_init as jax_init
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCHS, SMOKES, get_arch
from repro_torch.models import (
    RunConfig,
    count_params,
    decode_step,
    init_caches,
    model_init,
    params_from_jax,
    prefill,
)
from repro_torch.models.blocks import block_init

NAMES = ["hymba-1.5b", "smollm-135m", "mamba2-1.3b", "stablelm-1.6b",
         "starcoder2-7b", "qwen1.5-32b", "moonshot-v1-16b-a3b",
         "deepseek-v2-236b", "musicgen-medium", "qwen2-vl-72b"]
# the full-width parameter counts, pinned
FULL_PARAMS = {"moonshot-v1-16b-a3b": 28_888_467_456,
               "deepseek-v2-236b": 235_741_434_880,
               "qwen2-vl-72b": 71_460_495_360,
               "musicgen-medium": 1_362_766_848}
RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              kv_cache_dtype="float32")
TOL = {"float32": dict(logits=dict(atol=1e-4), cache=dict(atol=1e-4)),
       "bfloat16": dict(logits=dict(atol=4e-2),
                        cache=dict(atol=0.1, rtol=0.05))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, B, S, seed):
    """The model's inputs as numpy: tokens (B, S), or a frame model's
    frames (B, S, d)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "frames":
        return rng.standard_normal((B, S, cfg.d_model), np.float32)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _key(cfg) -> str:
    return "tokens" if cfg.embed_input == "tokens" else "frames"


@pytest.fixture(scope="module")
def models():
    """(jax params, port params on the CPU) per smoke config."""
    out = {}
    for name in NAMES:
        cfg = JAX_SMOKES[name]
        jp = jax.jit(lambda k: jax_init(k, cfg, JaxRun(**RUN_KW))[0])(
            jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), SMOKES[name],
                             RunConfig(**RUN_KW), device="cpu")
        out[name] = (jp, tp)
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _layer_caches(jax_caches, name):
    """The reference's layer-stacked caches as the port's per-layer lists."""
    out = {}
    for g, stacked in jax_caches.items():
        n = JAX_SMOKES[name].layout[int(g[1:])][1]
        out[g] = [jax.tree.map(lambda a: np.asarray(a[i], np.float32),
                               stacked) for i in range(n)]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_copies_every_leaf(models, name):
    jp, tp = models[name]
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k, a in jl.items():
        assert tl[k].dtype == torch.float32
        np.testing.assert_array_equal(tl[k].numpy(), a, err_msg=k)
    bad = jax.tree.map(np.asarray, jp)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_jax(bad, SMOKES[name], RunConfig(**RUN_KW), device="cpu")
    if "router" in bad["g0"].get("ffn", {}):  # an expert stack's path
        bad["g0"]["ffn"]["wi"] = bad["g0"]["ffn"]["wi"][:, :-1]
        with pytest.raises(ValueError, match="g0/ffn/wi: shape"):
            params_from_jax(bad, SMOKES[name], RunConfig(**RUN_KW),
                            device="cpu")
    del bad["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, SMOKES[name], RunConfig(**RUN_KW), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_caches_match_reference(models, name, dtype):
    jp, tp = models[name]
    kw = dict(RUN_KW, activations_dtype=dtype)
    toks = _tokens(JAX_SMOKES[name], 2, 70, seed=1)
    key = _key(SMOKES[name])
    jl, jc = jax.jit(lambda p, t: jax_prefill(
        p, {key: t}, JAX_SMOKES[name], JaxRun(**kw), cache_len=80))(
        jp, jnp.asarray(toks))
    tl, tc = prefill(tp, {key: torch.from_numpy(toks)}, SMOKES[name],
                     RunConfig(**kw), cache_len=80)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype]["logits"])
    want = _layer_caches(jc, name)
    assert want.keys() == tc.keys()
    for g in want:
        assert len(tc[g]) == len(want[g])
        for i, (wc, gc) in enumerate(zip(want[g], tc[g])):
            wl, gl = dict(_leaves(wc)), dict(_leaves(gc))
            assert wl.keys() == gl.keys()
            for k, a in wl.items():
                np.testing.assert_allclose(gl[k].float().numpy(), a,
                                           err_msg=f"{g}[{i}]{k}",
                                           **TOL[dtype]["cache"])


@pytest.mark.parametrize("prompt", [60, 70])
@pytest.mark.parametrize("name", NAMES)
def test_decode_teacher_forced_matches_reference(models, name, prompt):
    jp, tp = models[name]
    kw = dict(RUN_KW, activations_dtype="float32")
    jcfg, tcfg, jrun, trun = (JAX_SMOKES[name], SMOKES[name], JaxRun(**kw),
                              RunConfig(**kw))
    steps = 8
    toks = _tokens(jcfg, 2, prompt + steps, seed=2)
    key = _key(tcfg)
    _, jc = jax.jit(lambda p, t: jax_prefill(
        p, {key: t}, jcfg, jrun, cache_len=prompt + steps))(
        jp, jnp.asarray(toks[:, :prompt]))
    _, tc = prefill(tp, {key: torch.from_numpy(toks[:, :prompt])}, tcfg,
                    trun, cache_len=prompt + steps)
    dec = jax.jit(lambda p, c, t, pos: jax_decode(
        p, c, {key: t, "pos": pos}, jcfg, jrun))
    for t in range(steps):
        pos = prompt + t
        one = toks[:, pos: pos + 1]
        jl, jc = dec(jp, jc, jnp.asarray(one), jnp.int32(pos))
        tl, tc = decode_step(tp, tc, {key: torch.from_numpy(one),
                                      "pos": pos}, tcfg, trun)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3,
                                   err_msg=f"step {t}")
    if name == "hymba-1.5b":  # the window layers' ring really wrapped
        assert prompt + steps > tcfg.window
        assert tc["g1"][0]["attn"]["k"].shape[1] == tcfg.window


@pytest.mark.parametrize("name", NAMES)
def test_init_caches_and_decode_from_zero_state(models, name):
    """``init_caches`` matches the reference's zero caches (shapes and
    dtypes), and one decode step from them matches."""
    jp, tp = models[name]
    kw = dict(RUN_KW, activations_dtype="float32")
    jc = jax_init_caches(JAX_SMOKES[name], JaxRun(**kw), 2, 16)
    tc = init_caches(SMOKES[name], RunConfig(**kw), 2, 16, device="cpu")
    for g, stacked in jc.items():
        for gc in tc[g]:
            for (k, a), (k2, b) in zip(_leaves(stacked), _leaves(gc)):
                assert k == k2 and a.shape[1:] == tuple(b.shape)
                assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
                assert not b.any()
    one = _tokens(JAX_SMOKES[name], 2, 1, seed=3)
    key = _key(SMOKES[name])
    jl, _ = jax_decode(jp, jc, {key: jnp.asarray(one), "pos": jnp.int32(5)},
                       JAX_SMOKES[name], JaxRun(**kw))
    tl, _ = decode_step(tp, tc, {key: torch.from_numpy(one), "pos": 5},
                        SMOKES[name], RunConfig(**kw))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)


@pytest.mark.parametrize("name", NAMES)
def test_full_width_param_count_equals_reference(name):
    run = RunConfig()
    shapes, _ = abstract_init(JAX_ARCHS[name], JaxRun())
    meta, _ = model_init(0, ARCHS[name], run, device="meta")
    assert count_params(meta) == jax_count_params(shapes)
    assert all(t.device.type == "meta" for _, t in _leaves(meta))
    if name in FULL_PARAMS:
        assert count_params(meta) == FULL_PARAMS[name]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_stored_params_give_bit_identical_logits(name):
    """Prefill and two decode steps with bf16 activations: the tree
    ``model_init`` stores for a bf16 run and the all-f32 tree of an f32 run
    from the same seed give the same bits."""
    cfg = SMOKES[name]
    run = RunConfig(**dict(RUN_KW, activations_dtype="bfloat16"))
    f32, _ = model_init(0, cfg, RunConfig(**dict(
        RUN_KW, activations_dtype="float32")), device="cpu")
    bf16, _ = model_init(0, cfg, run, device="cpu")
    trees = [f32, bf16]
    for (k, a), (k2, b) in zip(_leaves(f32), _leaves(bf16)):
        assert k == k2 and a.dtype == torch.float32, k
        assert b.dtype in (torch.float32, torch.bfloat16), k
        assert torch.equal(b, a.to(b.dtype)), k
    cast = {k for k, t in _leaves(bf16) if t.dtype == torch.bfloat16}
    assert ("/embed/table" in cast) == (cfg.embed_input == "tokens")
    assert "/lm_head/table" in cast or cfg.tie_embeddings
    assert not any(
        "norm" in k or "router" in k or "wukv" in k or k.rsplit("/", 1)[1] in (
            "A_log", "D", "dt_bias", "conv_w", "conv_b") for k in cast)
    toks = _tokens(cfg, 2, 20, seed=6)
    key = _key(cfg)
    outs = []
    for params in trees:
        lg, caches = prefill(params, {key: torch.from_numpy(toks)}, cfg,
                             run, cache_len=22)
        got = [lg]
        for t in range(2):
            lg, caches = decode_step(
                params, caches, {key: torch.from_numpy(toks[:, t:t + 1]),
                                 "pos": 20 + t}, cfg, run)
            got.append(lg)
        outs.append(got)
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)


def test_model_init_is_seeded():
    cfg = SMOKES["hymba-1.5b"]
    a, _ = model_init(3, cfg, RunConfig(), device="cpu")
    b, _ = model_init(3, cfg, RunConfig(), device="cpu")
    c, _ = model_init(4, cfg, RunConfig(), device="cpu")
    for (k, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y), k
    assert not torch.equal(a["g0"]["attn"]["wq"]["w"], c["g0"]["attn"]["wq"]["w"])


def test_unported_configs_and_options_raise():
    """Every configuration of the reference is served (the MLA kinds build);
    the options the port does not implement still raise."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    assert sorted(SMOKES) == sorted(JAX_SMOKES)
    for name in JAX_ARCHS:
        for smoke in (False, True):
            assert get_arch(name, smoke=smoke) is (SMOKES if smoke
                                                   else ARCHS)[name]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-7b")
    cfg = SMOKES["deepseek-v2-236b"]
    for kind in ("mla_dense", "mla_moe"):
        p, _ = block_init(kind, None, cfg, torch.device("meta"))
        assert sorted(p["attn"]) == ["kvnorm", "qnorm", "wdkv", "wdq", "wkr",
                                     "wo", "wukv", "wuq"]
        assert ("router" in p["ffn"]) == (kind == "mla_moe")
    with pytest.raises(ValueError):
        block_init("mla_sparse", None, cfg, torch.device("meta"))
    # the stream options are ported: each changes only its own layers
    # (bf16 operands, f32 sums), within bf16 rounding of the plain run
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, (2, 40)).astype(np.int32))
    for name, own in (("smollm-135m", "attn"), ("mamba2-1.3b", "ssd")):
        cfg = SMOKES[name]
        run = RunConfig(activations_dtype="float32")
        params, _ = model_init(0, cfg, run, device="cpu")
        want, _ = prefill(params, {"tokens": toks}, cfg, run)
        for opt in ("attn", "ssd"):
            srun = dataclasses.replace(run, **{f"{opt}_stream_bf16": True})
            got, _ = prefill(params, {"tokens": toks}, cfg, srun)
            err = float((got - want).abs().max())
            if opt == own:
                assert 0 < err <= 2e-2 * float(want.abs().max()), (name, err)
            else:
                assert err == 0, (name, opt, err)
            init_caches(cfg, srun, 1, 8, device="cpu")
