"""The port's multi-head latent attention, frame-model trees and M-RoPE
against the reference's, on the CPU.

- MLA prefill (``models.attention.mla_apply``) against
  ``repro.models.attention.mla_apply`` at deepseek's smoke widths, the
  weights carried across from the reference's ``mla_init``: the output and
  the latent to cache (``ckv``, ``krope``) in f32 within atol 1e-5 (the
  reference's chunked online softmax against the plain attention: the same
  function summed in another order). The port's attention call gets q and
  k of head dim nope + rope and v of its own head dim, unpadded, and the
  plain flash function there equals the reference's ``chunked_attention``.
- The gradient of ``mla_apply`` (autograd through the port's attention
  Function, whose backward is the plain ``flash_attention_bwd_ref`` on the
  CPU) against ``jax.vjp`` of the reference's, for x and every parameter
  leaf, f32 within 1e-5 x max(1, the leaf's largest |.|), on a seeded
  cotangent: a norm scale's gradient sums 144 tokens' terms of up to ~20,
  whose f32 sums in another order differ by about 1e-5 (measured 1.1e-5
  on ``kvnorm/scale``, whose largest element is 22.3).
- The absorbed-matmul decode (``mla_decode``) against the reference's for
  8 steps from the prefilled latent, f32 within atol 1e-5, and the cache
  rows it writes.
- ``mla_init_cache`` matches the reference's (bf16 under an int8 run).
- ``apply_mrope`` against the reference's with distinct (t, h, w) ids, so
  each of the three frequency sections reads its own id (text ids make
  M-RoPE equal RoPE), at qwen2-vl's smoke and full sections.
- Frame models' parameter trees: no ``embed``, an ``lm_head`` and every
  other key as the reference's, at full width on the meta device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRun
from repro.models import abstract_init
from repro.models.rope import apply_mrope as jax_mrope
from repro.models.rope import apply_rope as jax_rope
import repro_torch.models.attention as tattn
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import RunConfig, model_init
from repro_torch.models.rope import apply_mrope, apply_rope

NAME = "deepseek-v2-236b"
RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32,
              activations_dtype="float32", kv_cache_dtype="float32")
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def mla():
    """(reference MLA params, the same as torch tensors, x, positions)."""
    cfg = JAX_SMOKES[NAME]
    jp, _ = jattn.mla_init(jax.random.PRNGKey(3), cfg)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 72, cfg.d_model), np.float32)
    pos = np.tile(np.arange(72, dtype=np.int32), (2, 1))
    return jp, _to_torch(jp), x, pos


def test_mla_prefill_matches_reference(mla, monkeypatch):
    jp, tp, x, pos = mla
    jcfg, cfg, m = JAX_SMOKES[NAME], SMOKES[NAME], SMOKES[NAME].mla
    jout, (jckv, jkr) = jattn.mla_apply(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg, JaxRun(**RUN_KW),
        jnp.asarray(pos), return_kv=True)
    calls = []

    def attend(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return flash_attention_ref(q, k, v, causal=kw["causal"])

    monkeypatch.setattr(tattn, "flash_attention", attend)
    out, (ckv, kr) = tattn.mla_apply(tp, torch.from_numpy(x), cfg,
                                     RunConfig(**RUN_KW),
                                     torch.from_numpy(pos), return_kv=True)
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    (q, k, v, kw), = calls
    D = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert q.shape[-1] == k.shape[-1] == D and v.shape[-1] == m.v_head_dim
    assert kw["causal"]
    # v at its own width through the plain flash function is the
    # reference's chunked attention
    want = jattn.chunked_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, chunk_q=32, chunk_k=32)
    np.testing.assert_allclose(flash_attention_ref(q, k, v).numpy(),
                               np.asarray(want), atol=ATOL)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def test_mla_gradient_matches_reference_vjp(mla):
    """d(out . cot) for x and every leaf: the port's autograd (the plain
    attention backward on the CPU) against ``jax.vjp`` of the reference's
    ``mla_apply``."""
    jp, tp, x, pos = mla
    jcfg, cfg = JAX_SMOKES[NAME], SMOKES[NAME]
    cot = np.random.default_rng(5).standard_normal(
        (*x.shape[:2], cfg.d_model), np.float32)

    def jfwd(p, x_):
        return jattn.mla_apply(p, x_, jcfg, JaxRun(**RUN_KW), jnp.asarray(pos))

    jout, vjp = jax.vjp(jfwd, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    names = [n for n, _ in _leaves(tp)]
    leaves = [t.clone().requires_grad_(True) for _, t in _leaves(tp)]
    it = iter(leaves)
    params = jax.tree.map(lambda _: next(it), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tattn.mla_apply(params, tx, cfg, RunConfig(**RUN_KW),
                          torch.from_numpy(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    grads = torch.autograd.grad(out, [tx] + leaves, torch.from_numpy(cot))
    want = [jgx] + [a for _, a in _leaves(jax.tree.map(np.asarray, jgp))]
    assert len(grads) == len(want) == 1 + len(names) >= 9
    for name, g, w in zip(["x"] + names, grads, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.numpy(), w, atol=ATOL * max(1.0, float(np.abs(w).max())),
            err_msg=name)


def test_mla_absorbed_decode_matches_reference(mla):
    jp, tp, x, pos = mla
    jcfg, cfg = JAX_SMOKES[NAME], SMOKES[NAME]
    jrun, run = JaxRun(**RUN_KW), RunConfig(**RUN_KW)
    prompt, steps = 64, 8
    _, (jckv, jkr) = jattn.mla_apply(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x[:, :prompt]), jcfg, jrun,
        jnp.asarray(pos[:, :prompt]), return_kv=True)
    grow = [(0, 0), (0, steps), (0, 0)]
    jc = {"ckv": jnp.pad(jckv, grow), "krope": jnp.pad(jkr, grow)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    jpp = jax.tree.map(jnp.asarray, jp)
    for t in range(steps):
        p = prompt + t
        one = x[:, p:p + 1]
        jo, jc = jattn.mla_decode(jpp, jc, jnp.asarray(one), jcfg, jrun,
                                  jnp.int32(p))
        to, tc = tattn.mla_decode(tp, tc, torch.from_numpy(one), cfg, run, p)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                                   err_msg=f"step {t}")
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL, err_msg=f"{k} step {t}")


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_mla_init_cache_matches_reference(kv):
    kw = dict(RUN_KW, kv_cache_dtype=kv)
    want = jattn.mla_init_cache(JAX_SMOKES[NAME], JaxRun(**kw), 2, 40)
    got = tattn.mla_init_cache(SMOKES[NAME], RunConfig(**kw), 2, 40,
                               torch.device("cpu"))
    assert want.keys() == got.keys()
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and not got[k].any()
        assert str(got[k].dtype).removeprefix("torch.") == str(a.dtype)
    if kv == "int8":
        assert got["ckv"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["qwen2-vl-72b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_mrope_matches_reference_with_distinct_ids(name, smoke):
    cfg = (SMOKES if smoke else ARCHS)[name]
    D, sec = cfg.head_dim, cfg.mrope_sections
    assert sum(sec) == D // 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 3, D), np.float32)
    t = rng.integers(0, 4000, (2, 11)).astype(np.int32)
    ids = np.stack([t, t + 7, t + 1013], axis=-1)  # distinct t, h, w ids
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(ids),
                      cfg.rope_theta, sec)
    want = jax_mrope(jnp.asarray(x), jnp.asarray(ids), cfg.rope_theta, sec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # each section reads its own id: rotating by one id alone differs
    for j in range(3):
        alone = jax_rope(jnp.asarray(x), jnp.asarray(ids[..., j]),
                         cfg.rope_theta)
        assert np.abs(got.numpy() - np.asarray(alone)).max() > 1e-2
    # equal ids: M-RoPE is RoPE
    same = np.repeat(ids[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                    cfg.rope_theta, sec).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(ids[..., 0]),
                   cfg.rope_theta).numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["musicgen-medium", "qwen2-vl-72b",
                                  "deepseek-v2-236b"])
def test_full_width_trees_have_the_reference_keys(name):
    shapes, _ = abstract_init(JAX_ARCHS[name], JaxRun())
    meta, _ = model_init(0, ARCHS[name], RunConfig(), device="meta")

    def keys(tree, path=""):
        if isinstance(tree, dict):
            return {k for n, v in tree.items() for k in keys(v, f"{path}/{n}")}
        return {(path, tuple(tree.shape))}

    assert keys(meta) == keys(shapes)
    frames = ARCHS[name].embed_input == "frames"
    assert ("embed" in meta) != frames and "lm_head" in meta
