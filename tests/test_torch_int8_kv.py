"""The port's int8 KV cache against the reference's, on the CPU.

- ``quantize_kv`` / ``dequantize_kv`` are bit-equal to
  ``repro.models.attention``'s: int8 values, f32 scales (one per token and
  KV head) and the dequantized tensor, on random rows, all-zero rows and
  exact halves (``torch.round`` and ``jnp.round`` both round half to even).
- ``init_caches`` under ``kv_cache_dtype="int8"`` has the reference's
  leaves, shapes and dtypes (``k_scale``/``v_scale`` beside int8 ``k``/``v``;
  MLA's latent cache stays bf16).
- Prefill and teacher-forced decode under the int8 cache, for every smoke
  configuration with a GQA cache (hymba's sliding-window ring included: a
  70-token prompt enters decode through the rolled ring of the smoke window
  64) and for deepseek's MLA: the f32 logits within atol 2e-3 of the
  reference's (``test_models.py``'s decode tolerance), and the prefill's
  int8 caches equal to the reference's save where the two frameworks' f32
  keys fall on opposite sides of a rounding boundary (one quantum, on at
  most 0.1% of the values; scales rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRun
from repro.models import decode_step as jax_decode
from repro.models import init_caches as jax_init_caches
from repro.models import model_init as jax_init
from repro.models import prefill as jax_prefill
from repro.models.attention import dequantize_kv as jax_dequantize
from repro.models.attention import quantize_kv as jax_quantize
from repro_torch.configs import SMOKES
from repro_torch.models import (
    RunConfig,
    decode_step,
    init_caches,
    params_from_jax,
    prefill,
)
from repro_torch.models.attention import dequantize_kv, quantize_kv

RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              activations_dtype="float32", kv_cache_dtype="int8")
# every smoke configuration whose layers keep a GQA cache
GQA_NAMES = ["hymba-1.5b", "smollm-135m", "stablelm-1.6b", "starcoder2-7b",
             "qwen1.5-32b", "moonshot-v1-16b-a3b", "musicgen-medium",
             "qwen2-vl-72b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "frames":
        return "frames", rng.standard_normal((B, S, cfg.d_model), np.float32)
    return "tokens", rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _kv_rows():
    """Random rows, an all-zero row and rows of exact halves: with amax 127
    the scale is 1.0, so 2.5 and -3.5 sit on rounding ties."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = 0.0
    x[1, 2, 1, 0] = 127.0
    x[1, 2, 1, 1:8] = [2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    return x


def test_quantize_and_dequantize_are_bit_equal_to_reference():
    x = _kv_rows()
    qv, sc = quantize_kv(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert qv.dtype == torch.int8 and sc.dtype == torch.float32
    assert tuple(sc.shape) == (2, 9, 3, 1)
    np.testing.assert_array_equal(qv.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(js))
    assert qv[1, 2, 1, 1:8].tolist() == [2, -4, 0, 0, 2, 126, -126]
    assert not qv[0, 0, 0].any()
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_kv(qv, sc, tdt).float().numpy()
        want = np.asarray(jax_dequantize(jq, js, jdt), np.float32)
        np.testing.assert_array_equal(got, want)
    # the round trip is within half a quantum (amax / 254) of each element
    back = dequantize_kv(qv, sc, torch.float32).numpy()
    assert (np.abs(back - x)
            <= sc.numpy() / 2 * (1 + 1e-6) + np.abs(x) * 2.0**-22).all()


@pytest.mark.parametrize("name", [*GQA_NAMES, "deepseek-v2-236b"])
def test_int8_init_caches_match_reference(name):
    jc = jax_init_caches(JAX_SMOKES[name], JaxRun(**RUN_KW), 2, 16)
    tc = init_caches(SMOKES[name], RunConfig(**RUN_KW), 2, 16, device="cpu")
    for g, stacked in jc.items():
        for gc in tc[g]:
            want, got = dict(_leaves(stacked)), dict(_leaves(gc))
            assert want.keys() == got.keys()
            for k, a in want.items():
                assert a.shape[1:] == tuple(got[k].shape), k
                assert str(a.dtype) == str(got[k].dtype).removeprefix("torch.")
                assert not got[k].any()
    leaves = dict(_leaves(tc["g0"][0]))
    if name == "deepseek-v2-236b":  # MLA's latent is not quantized
        assert {t.dtype for t in leaves.values()} == {torch.bfloat16}
    else:
        assert any(k.endswith("k_scale") for k in leaves)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in [*GQA_NAMES, "deepseek-v2-236b"]:
        cfg = JAX_SMOKES[name]
        jp = jax.jit(lambda k: jax_init(k, cfg, JaxRun(**RUN_KW))[0])(
            jax.random.PRNGKey(0))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         SMOKES[name], RunConfig(**RUN_KW),
                                         device="cpu"))
    return out


@pytest.mark.parametrize("name", [*GQA_NAMES, "deepseek-v2-236b"])
def test_int8_cache_prefill_and_decode_match_reference(models, name):
    jp, tp = models[name]
    jcfg, tcfg = JAX_SMOKES[name], SMOKES[name]
    jrun, trun = JaxRun(**RUN_KW), RunConfig(**RUN_KW)
    prompt, steps = 70, 6
    key, x = _inputs(tcfg, 2, prompt + steps, seed=4)
    jl, jc = jax.jit(lambda p, t: jax_prefill(
        p, {key: t}, jcfg, jrun, cache_len=prompt + steps))(
        jp, jnp.asarray(x[:, :prompt]))
    tl, tc = prefill(tp, {key: torch.from_numpy(x[:, :prompt])}, tcfg, trun,
                     cache_len=prompt + steps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3)
    n_int8 = n_off = 0
    for g, stacked in jc.items():
        for i, gc in enumerate(tc[g]):
            want = dict(_leaves(jax.tree.map(lambda a: np.asarray(a[i]),
                                             stacked)))
            got = dict(_leaves(gc))
            assert want.keys() == got.keys()
            for k, a in want.items():
                b = got[k]
                assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
                if b.dtype == torch.int8:
                    d = np.abs(b.numpy().astype(np.int32) - a.astype(np.int32))
                    assert d.max() <= 1, (g, i, k)
                    n_int8 += d.size
                    n_off += int((d > 0).sum())
                elif k.endswith("_scale"):
                    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                               err_msg=f"{g}[{i}]{k}")
                else:  # MLA's bf16 latent
                    np.testing.assert_allclose(b.float().numpy(),
                                               a.astype(np.float32),
                                               atol=1e-2, rtol=1e-2)
    assert n_off <= max(1, n_int8 // 1000)
    assert (n_int8 > 0) == (name != "deepseek-v2-236b")
    dec = jax.jit(lambda p, c, t, pos: jax_decode(
        p, c, {key: t, "pos": pos}, jcfg, jrun))
    for t in range(steps):
        pos = prompt + t
        one = x[:, pos:pos + 1]
        jl, jc = dec(jp, jc, jnp.asarray(one), jnp.int32(pos))
        tl, tc = decode_step(tp, tc, {key: torch.from_numpy(one),
                                      "pos": pos}, tcfg, trun)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3,
                                   err_msg=f"step {t}")
    if name == "hymba-1.5b":  # the window layers' ring, int8 with scales
        ring = tc["g1"][0]["attn"]
        assert ring["k"].dtype == torch.int8
        assert ring["k"].shape[1] == ring["k_scale"].shape[1] == tcfg.window
