"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on seeded numpy inputs at ``moonshot-v1-16b-a3b``'s
smoke width (8 experts, top-2, one shared expert).

- ``route``: expert ids equal, weights and the load-balance loss at f32
  rounding; ties go to the lower expert id, as ``lax.top_k`` sends them.
- ``capacity`` and ``dispatch_indices``: equal, slot for slot, also on
  skewed choices where an expert overflows its capacity.
- ``expert_ffn`` and ``moe_apply_dense`` in f32 (atol 1e-5) and bf16
  (``tests/test_torch_models.py``'s bf16 logits tolerance, atol 4e-2), at
  the default capacity factor and at 0.25, where pairs are dropped; the
  routed ids, slots and kept pairs are equal in both dtypes.
- ``moe_impl="ep"`` without a mesh: the reference runs expert
  parallelism only under a device mesh and the dense path without one, and
  so does the port (``shardctx`` holds none here), so a block with
  ``"ep"`` equals the block with ``"dense"`` bit for bit. Under a mesh,
  ``tests/test_torch_dist.py`` holds the EP path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models.moe as tmoe
from repro.configs import SMOKES as JAX_SMOKES
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.models import RunConfig
from repro_torch.models.blocks import block_init, block_prefill

NAME = "moonshot-v1-16b-a3b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=4e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cf):
    """The reference's and the port's smoke configs at capacity factor
    ``cf``."""
    return tuple(dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
        for c in (JAX_SMOKES[NAME], SMOKES[NAME]))


@pytest.fixture(scope="module")
def params():
    """The reference's ``moe_init`` draws, as numpy, and the port's copy."""
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(3), JAX_SMOKES[NAME])
    np_p = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_p)
    return jp, tp


def _x(B, S, d, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return (jnp.asarray(x).astype(JDT[dtype]),
            torch.from_numpy(x).to(TDT[dtype]))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(params, dtype):
    jp, tp = params
    m = SMOKES[NAME].moe
    jx, tx = _x(1, 64, SMOKES[NAME].d_model, seed=1, dtype=dtype)
    jids, jw, jaux = jmoe.route(jp, jx[0], m)
    tids, tw, taux = tmoe.route(tp, tx[0], m)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_route_ties_go_to_the_lower_expert_id(params):
    """A zero token has equal probabilities over all experts: both take
    experts 0..k-1, in that order, with equal weights."""
    jp, tp = params
    m = SMOKES[NAME].moe
    d = SMOKES[NAME].d_model
    jids, jw, _ = jmoe.route(jp, jnp.zeros((3, d)), m)
    tids, tw, _ = tmoe.route(tp, torch.zeros((3, d)), m)
    np.testing.assert_array_equal(np.asarray(jids), [list(range(m.top_k))] * 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("tokens", [1, 4, 48, 1000, 8000])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25])
def test_capacity_matches_reference(tokens, cf):
    """At smoke width and at moonshot's full 64 experts top-6."""
    for m in (SMOKES[NAME].moe, ARCHS[NAME].moe):
        m = dataclasses.replace(m, capacity_factor=cf)
        assert tmoe.capacity(m, tokens) == jmoe.capacity(m, tokens)


@pytest.mark.parametrize("skew", [0.0, 0.7])
@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_dispatch_indices_match_reference(skew, cf):
    """Random expert choices, and choices where one expert takes 70% of
    the first picks (it overflows at both capacity factors)."""
    jcfg, tcfg = _cfg(cf)
    m = tcfg.moe
    rng = np.random.default_rng(7)
    T = 300
    ids = np.stack([rng.permutation(m.n_experts)[: m.top_k]
                    for _ in range(T)]).astype(np.int32)
    hot = rng.random(T) < skew
    ids[hot, 0] = 5
    ids[hot, 1] = np.where(ids[hot, 1] == 5, 6, ids[hot, 1])
    cap = tmoe.capacity(m, T)
    jslot, jkeep = jmoe.dispatch_indices(jnp.asarray(ids), jcfg.moe, cap)
    tslot, tkeep = tmoe.dispatch_indices(torch.from_numpy(ids).long(), m, cap)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    if skew or cf < 1:
        assert not tkeep.all()
    kept = tslot[tkeep]
    assert kept.unique().numel() == kept.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_reference(params, dtype):
    jp, tp = params
    m = SMOKES[NAME].moe
    jx, tx = _x(m.n_experts, 16, SMOKES[NAME].d_model, seed=2, dtype=dtype)
    want = jmoe.expert_ffn(jp, jx)
    got = tmoe.expert_ffn(tp, tx)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_dense_matches_reference(params, dtype, cf):
    jp, tp = params
    jcfg, tcfg = _cfg(cf)
    m = tcfg.moe
    jx, tx = _x(2, 40, tcfg.d_model, seed=4, dtype=dtype)
    T = 80
    jids, _, _ = jmoe.route(jp, jx.reshape(T, -1), jcfg.moe)
    tids, _, _ = tmoe.route(tp, tx.reshape(T, -1), m)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    cap = tmoe.capacity(m, T)
    jslot, jkeep = jmoe.dispatch_indices(jids, jcfg.moe, cap)
    tslot, tkeep = tmoe.dispatch_indices(tids, m, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if cf < 1:  # forced drops
        assert int((~tkeep).sum()) > 0
    want, jaux = jmoe.moe_apply_dense(jp, jx, jcfg)
    got, taux = tmoe.moe_apply_dense(tp, tx, tcfg)
    assert got.dtype == TDT[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_impl_ep_computes_the_dense_path(dtype):
    cfg = SMOKES[NAME]
    gen = torch.Generator().manual_seed(5)
    p, _ = block_init("attn_moe", gen, cfg, torch.device("cpu"))
    x = torch.randn((2, 24, cfg.d_model), generator=gen).to(TDT[dtype])
    pos = torch.arange(24, dtype=torch.int32).expand(2, 24)
    outs = [block_prefill("attn_moe", p, x, cfg,
                          RunConfig(activations_dtype=dtype, moe_impl=impl),
                          pos)
            for impl in ("dense", "ep")]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1].values(), outs[1][1].values()):
        assert torch.equal(a, b)
