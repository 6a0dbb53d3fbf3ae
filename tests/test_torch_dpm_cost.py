"""Cost-table and batched-planning parity: ``repro_torch.kernels.dpm_cost``
against ``repro.kernels.dpm_cost`` on the CPU.

The plain PyTorch cost tables (``ref.py``, the CUDA kernels' oracle on the
card) are held against the JAX package's Pallas kernels in interpret mode
and against its jnp oracles; ``dpm_plan``, ``dpm_plan_weighted``,
``dpm_plan_topo`` and ``dpm_plan_exact`` against their JAX twins. Inputs are
drawn from a numpy seed. Every comparison is exact integer or float
equality, except the weighted table's float32 sums under the non-dyadic
``energy`` prices, held to rtol 1e-6 (summation order differs between XLA
and PyTorch; the dyadic ``hops`` and ``weighted`` prices sum exactly in any
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.dpm_cost.ops as jops
from repro.kernels.dpm_cost import dpm_cost as jkern
from repro.kernels.dpm_cost import ref as jref
import repro_torch.core as tcore
import repro_torch.core.batch_planner as tbp
import repro_torch.kernels.dpm_cost.ops as tops
from repro_torch.kernels.dpm_cost import dpm_cost as tkern
from repro_torch.kernels.dpm_cost import ref as tref

ENERGY_RTOL = 1e-6


def _fabric(kind, n, m):
    make = {"mesh": jcore.grid, "torus": jcore.torus}[kind]
    return make(n, m)


def _packets(n, m, P, seed, density=0.15):
    """(mask (P, NN) int32, src_xy (P, 2) int32): random destination sets;
    packet 0 lists its own source as a destination, packet 1 has none."""
    rng = np.random.default_rng(seed)
    NN = n * m
    mask = (rng.random((P, NN)) < density).astype(np.int32)
    sxy = np.stack([rng.integers(0, n, P), rng.integers(0, m, P)], 1)
    sxy = sxy.astype(np.int32)
    mask[0, sxy[0, 1] * n + sxy[0, 0]] = 1
    mask[1] = 0
    return mask, sxy


def _eq(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x))


TABLE_CASES = [
    ("mesh", 4, 4), ("mesh", 8, 8), ("mesh", 16, 16), ("mesh", 8, 4),
    ("torus", 4, 4), ("torus", 8, 8), ("torus", 8, 4),
]


@pytest.mark.parametrize("leg", [True, False])
@pytest.mark.parametrize("kind,n,m", TABLE_CASES)
def test_cost_table_ref_matches_jax_ref(kind, n, m, leg):
    mask, sxy = _packets(n, m, 40, seed=n * m + leg)
    kw = dict(n=n, m=m, wrap=kind == "torus", include_source_leg=leg)
    jc, jr = jref.dpm_cost_table_ref(jnp.asarray(mask), jnp.asarray(sxy), **kw)
    tc, tr = tref.dpm_cost_table_ref(_t(mask), _t(sxy), **kw)
    _eq(tc.numpy(), jc, "costs")
    _eq(tr.numpy(), jr, "reps")
    assert (tr[1] == -1).all() and (tc[1] == 0).all()  # no destinations


@pytest.mark.parametrize(
    "kind,n,m,leg",
    [("mesh", 16, 16, True), ("mesh", 8, 4, False), ("torus", 8, 4, True)],
)
def test_cost_table_ref_matches_pallas_kernel(kind, n, m, leg):
    """The Pallas kernel in interpret mode, as the JAX package's tests run
    it: one tile per 16 packets, so the grid has several steps."""
    mask, sxy = _packets(n, m, 40, seed=3 * n + m + leg)
    kw = dict(n=n, m=m, wrap=kind == "torus", include_source_leg=leg)
    jc, jr = jkern.dpm_cost_table(jnp.asarray(mask), jnp.asarray(sxy), **kw,
                                  tile=16, interpret=True)
    tc, tr = tref.dpm_cost_table_ref(_t(mask), _t(sxy), **kw)
    _eq(tc.numpy(), jc, "costs")
    _eq(tr.numpy(), jr, "reps")


def _route_tensors(kind, n, m, model):
    jg = _fabric(kind, n, m)
    dist, w, oh = jcore.route_cost_matrices(jg, jcore.get_cost_model(model))
    return dist.astype(np.float32), w, oh


@pytest.mark.parametrize("model", ["hops", "weighted", "energy"])
@pytest.mark.parametrize("kind,n,m", [("mesh", 8, 8), ("torus", 8, 4),
                                      ("mesh", 8, 4)])
def test_weighted_table_ref_matches_jax_ref(kind, n, m, model):
    mask, sxy = _packets(n, m, 40, seed=n + m)
    dist, w, oh = _route_tensors(kind, n, m, model)
    kw = dict(n=n, m=m, wrap=kind == "torus", overhead=oh)
    jc, jr = jref.dpm_cost_table_weighted_ref(
        jnp.asarray(mask), jnp.asarray(sxy), jnp.asarray(dist),
        jnp.asarray(w), **kw,
    )
    tc, tr = tref.dpm_cost_table_weighted_ref(
        _t(mask), _t(sxy), _t(dist), _t(w), **kw
    )
    _eq(tr.numpy(), jr, "reps")
    if model == "energy":
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                   rtol=ENERGY_RTOL, atol=0)
    else:
        _eq(tc.numpy(), jc, "costs")


@pytest.mark.parametrize("kind,model", [("mesh", "hops"),
                                        ("torus", "weighted")])
def test_weighted_table_ref_matches_pallas_kernel(kind, model):
    n, m = 8, 4
    mask, sxy = _packets(n, m, 40, seed=17)
    dist, w, oh = _route_tensors(kind, n, m, model)
    kw = dict(n=n, m=m, wrap=kind == "torus", overhead=oh)
    jc, jr = jkern.dpm_cost_table_weighted(
        jnp.asarray(mask), jnp.asarray(sxy), jnp.asarray(dist),
        jnp.asarray(w), **kw, tile=16, interpret=True,
    )
    tc, tr = tref.dpm_cost_table_weighted_ref(
        _t(mask), _t(sxy), _t(dist), _t(w), **kw
    )
    _eq(tc.numpy(), jc, "costs")
    _eq(tr.numpy(), jr, "reps")


@pytest.mark.parametrize("kind,n,m", [("mesh", 8, 8), ("torus", 8, 8),
                                      ("mesh", 8, 4)])
def test_dpm_plan_matches_jax(kind, n, m):
    """``dpm_plan`` (the cost-table kernel's entry point; the JAX package
    interprets its Pallas kernel on the CPU) and ``total_plan_cost``."""
    mask, sxy = _packets(n, m, 48, seed=5 * n + m)
    wrap = kind == "torus"
    jout = jops.dpm_plan(jnp.asarray(mask), jnp.asarray(sxy), n=n, m=m,
                         wrap=wrap)
    tout = tops.dpm_plan(mask, sxy, n=n, m=m, wrap=wrap, device="cpu")
    for name, a, b in zip(("chosen", "costs", "reps"), tout, jout):
        _eq(a.numpy(), b, name)
    _eq(tops.total_plan_cost(tout[0], tout[1]).numpy(),
        jops.total_plan_cost(jout[0], jout[1]), "total")


@pytest.mark.parametrize("kind,model", [("mesh", "weighted"),
                                        ("torus", "hops")])
def test_dpm_plan_weighted_matches_jax(kind, model):
    n, m = 8, 8
    mask, sxy = _packets(n, m, 48, seed=23)
    dist, w, oh = _route_tensors(kind, n, m, model)
    kw = dict(n=n, m=m, wrap=kind == "torus", overhead=oh)
    jout = jops.dpm_plan_weighted(jnp.asarray(mask), jnp.asarray(sxy),
                                  jnp.asarray(dist), jnp.asarray(w), **kw)
    tout = tops.dpm_plan_weighted(mask, sxy, dist, w, **kw, device="cpu")
    for name, a, b in zip(("chosen", "costs", "reps"), tout, jout):
        _eq(a.numpy(), b, name)


def test_membership_and_labels_match_jax():
    for kind in ("mesh", "torus"):
        jg = _fabric(kind, 8, 4)
        tg = {"mesh": tcore.grid, "torus": tcore.torus}[kind](8, 4)
        _eq(tops.snake_labels(tg), jops.snake_labels(jg), "labels")
        _eq(tops.partition_membership(tg, tg.nodes()),
            jops.partition_membership(jg, jg.nodes()), "membership")


def _topo_inputs(kind, n, m, P, seed):
    jg = _fabric(kind, n, m)
    mask, sxy = _packets(n, m, P, seed)
    srcs = [tuple(map(int, s)) for s in sxy]
    part_of = jops.partition_membership(jg, srcs)
    src_idx = np.array([jg.idx(s) for s in srcs], np.int32)
    return jg, mask, part_of, src_idx


@pytest.mark.parametrize("kind,model", [("mesh", "hops"), ("torus", "energy")])
def test_dpm_plan_topo_matches_jax(kind, model):
    """The generic-topology path on 2-D fabrics."""
    jg, mask, part_of, src_idx = _topo_inputs(kind, 8, 4, 32, seed=29)
    masked = np.where(mask > 0, part_of, -1).astype(np.int32)
    labels = jops.snake_labels(jg)
    dist, w, oh = _route_tensors(kind, 8, 4, model)
    kw = dict(np_=8, overhead=oh)
    jout = jops.dpm_plan_topo(jnp.asarray(masked), jnp.asarray(src_idx),
                              jnp.asarray(labels), jnp.asarray(dist),
                              jnp.asarray(w), **kw)
    tout = tops.dpm_plan_topo(masked, src_idx, labels, dist, w, **kw,
                              device="cpu")
    _eq(tout[2].numpy(), jout[2], "reps")
    if model == "energy":
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   rtol=ENERGY_RTOL, atol=0)
    else:
        _eq(tout[1].numpy(), jout[1], "costs")
        _eq(tout[0].numpy(), jout[0], "chosen")


def _exact_pass_matches(jg, jcm, mask, src_idx):
    """Run ``dpm_plan_exact`` in both packages on the tables
    ``core.batch_planner`` builds for ``jg`` and hold all five outputs
    equal; returns the membership table and the label-chain matrices."""
    jmemb = jcore.batch_planner.membership_table(jg)
    labels = jops.snake_labels(jg)
    order = np.argsort(labels).astype(np.int32)
    dist, w_uni, oh = jcore.route_cost_matrices(jg, jcm)
    wh, wl = jcore.label_chain_matrices(jg, jcm)
    args = (mask.astype(bool), src_idx, jmemb[src_idx], labels, order, dist,
            w_uni, wh, wl)
    jout = jops.dpm_plan_exact(*map(jnp.asarray, args), np_=8, overhead=oh)
    tout = tops.dpm_plan_exact(*args, np_=8, overhead=oh, device="cpu")
    for name, a, b in zip(("chosen", "order", "reps", "modes", "costs"),
                          tout, jout):
        _eq(a.numpy(), b, name)
    return jmemb, wh, wl


@pytest.mark.parametrize("kind,model", [("mesh", "hops"), ("torus", "hops"),
                                        ("mesh", "weighted"),
                                        ("torus", "weighted")])
def test_dpm_plan_exact_matches_jax(kind, model):
    """All five outputs of the batched planner's full-objective pass, on
    the tables ``core.batch_planner`` builds. Packet 0 lists its own source
    as a destination: ``part_of`` is -1 there, which both packages read as
    the last wedge's column."""
    n, m = 4, 4
    jg, mask, _, src_idx = _topo_inputs(kind, n, m, 16, seed=31)
    jcm = jcore.get_cost_model(model)
    jmemb, wh, wl = _exact_pass_matches(jg, jcm, mask, src_idx)
    # the port builds the same host tables itself
    tg = {"mesh": tcore.grid, "torus": tcore.torus}[kind](n, m)
    tcm = tcore.get_cost_model(model)
    _eq(tbp.membership_table(tg), jmemb, "membership_table")
    for a, b in zip(tbp.label_chain_matrices(tg, tcm), (wh, wl)):
        _eq(a, b, "label_chain_matrices")


@pytest.mark.parametrize("kind,model", [("mesh", "hops"),
                                        ("torus", "weighted")])
def test_dpm_plan_exact_single_packet_matches_jax(kind, model):
    """A batch of one packet, the pass ``plan_one`` pads a lone request
    to, for several sources and destination sets."""
    n = 4
    jg = _fabric(kind, n, n)
    jcm = jcore.get_cost_model(model)
    rng = np.random.default_rng(41)
    for _ in range(4):
        mask = (rng.random((1, n * n)) < 0.3).astype(np.int32)
        src = jg.nodes()[rng.integers(n * n)]
        mask[0, jg.idx(src)] = 0
        mask[0, rng.integers(n * n)] = 1
        src_idx = np.array([jg.idx(src)], np.int32)
        _exact_pass_matches(jg, jcm, mask, src_idx)


def test_greedy_merge_order_on_float_ties():
    """Equal float32 savings resolve by fewer merged partitions, then the
    smaller candidate index, in both packages; leftover singles carry
    NO_ORDER."""
    rng = np.random.default_rng(37)
    costs = rng.integers(0, 4, (64, 24)).astype(np.float32) / 2
    reps = np.where(rng.random((64, 24)) < 0.8, 1, -1).astype(np.int32)
    jch, jord = jops._greedy_merge_ordered(jnp.asarray(costs),
                                           jnp.asarray(reps))
    tch, tord = tops._greedy_merge_ordered(_t(costs), _t(reps))
    _eq(tch.numpy(), jch, "chosen")
    _eq(tord.numpy(), jord, "order")
    assert tops.NO_ORDER == int(jops.NO_ORDER)


def test_kernel_wrappers_take_cuda_tensors_only():
    """The CUDA wrappers never run a CPU path: a CPU tensor raises before
    anything is built, and only ``ops`` sends CPU tensors to ``ref.py``."""
    mask, sxy = _packets(4, 4, 4, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.dpm_cost_table(_t(mask), _t(sxy), n=4)
    d = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tkern.dpm_cost_table_weighted(_t(mask), _t(sxy), d, d, n=4)
    assert tkern.KERNEL.launches == dict.fromkeys(tkern.NAMES, 0)
    assert set(tkern.KERNEL.variant_launches.values()) == {0}
    assert tkern._ring_delta(torch.tensor([-3, -2, 2, 3]), 4, True).tolist() \
        == [1, -2, -2, -1]
    assert [tcore.ring_delta(d, 4) for d in (-3, -2, 2, 3)] == [1, -2, -2, -1]


def test_kernel_wrappers_refuse_an_unknown_route():
    """``variant=`` names one of the two routes; anything else raises
    before a tensor is looked at, and no route is counted."""
    mask, sxy = _packets(4, 4, 4, seed=1)
    with pytest.raises(ValueError, match="variant"):
        tkern.dpm_cost_table(_t(mask), _t(sxy), n=4, variant="grid")
    d = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="variant"):
        tkern.dpm_cost_table_weighted(_t(mask), _t(sxy), d, d, n=4,
                                      variant="")
    assert tkern.VARIANTS == ("warp", "block")
    assert sorted(tkern.KERNEL.variant_launches) == sorted(
        f"{k}/{v}" for k in tkern.NAMES for v in tkern.VARIANTS)
    assert set(tkern.KERNEL.variant_launches.values()) == {0}
