"""The port's xsim keywords and its closed calibration loop
(``repro_torch.noc.telemetry.calibrate_cost_model``) on the CPU against
``repro``'s: every keyword of ``xsimulate`` that the reference takes (the
cost model, the measurement window, the telemetry epoch, padding and the
per-workload fault sets) with every output plane equal to the JAX engine's,
a small calibration loop whose ``to_dict()`` equals the reference's, and a
name registered twice never serving the first model's plans.

Models registered here are unregistered from both registries after each
test."""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.noc as jnoc
import repro_torch.core as tcore
import repro_torch.noc as tnoc
from repro_torch.noc import MeasuredContentionCost

NAME = "calibrated-test"
BROKEN = (((1, 1), (1, 2)), ((3, 0), (3, 1)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain cycle's many small ops run fastest on one thread, and the
    suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _unregister():
    yield
    for core in (jcore, tcore):
        core.unregister_cost_model(NAME)


def _cfgs(**kw):
    return jnoc.NoCConfig(**kw), tnoc.NoCConfig(**kw)


def _workloads(jcfg, tcfg, rates, cycles, seed):
    jw = [jnoc.synthetic_workload(jcfg, r, cycles, seed=seed) for r in rates]
    tw = [tnoc.synthetic_workload(tcfg, r, cycles, seed=seed) for r in rates]
    assert [[(q.time, q.src, q.dests) for q in w.requests] for w in jw] == [
        [(q.time, q.src, q.dests) for q in w.requests] for w in tw]
    return jw, tw


def _assert_same_results(got, ref):
    assert got.algos == ref.algos
    assert (got.warmup, got.cycles, got.epoch_len, got.slots) == (
        ref.warmup, ref.cycles, ref.epoch_len, ref.slots)
    np.testing.assert_array_equal(got.horizons, ref.horizons)
    assert set(got.traffic) == set(ref.traffic)
    for k, v in ref.traffic.items():
        np.testing.assert_array_equal(got.traffic[k], np.asarray(v), err_msg=k)
    for k in ("dtime", "ctr", "crel", "lutil", "rconf"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    W = len(ref.horizons)
    for w in range(W):
        for a in range(len(ref.algos)):
            assert got.avg_latency(w, a) == ref.avg_latency(w, a)
            assert got.delivered_sets(w, a) == ref.delivered_sets(w, a)
            assert got.all_drained(w, a) == ref.all_drained(w, a)


def _measured(core_noc, g, seed):
    util = np.random.default_rng(seed).integers(0, 40, g.num_nodes * 4)
    return core_noc.MeasuredContentionCost(g, util.astype(np.float64))


# (id, NoCConfig kwargs, rates, cycles, algos, xsimulate kwargs)
KEYWORD_CASES = [
    ("cost_model_contention", dict(n=4, multicast_fraction=0.5,
                                   dest_range=(2, 5), drain_grace=250),
     (0.05,), 60, ("DPM", "MU"), dict(cost_model="contention")),
    ("cost_model_measured", dict(n=6, multicast_fraction=0.5,
                                 dest_range=(3, 6), drain_grace=250),
     (0.04,), 60, ("DPM",), dict(cost_model=NAME)),
    ("window_and_epoch", dict(n=4, multicast_fraction=0.3),
     (0.03, 0.06), 80, ("MU", "DPM"),
     dict(warmup=30, drain_grace=150, epoch_len=16)),
    ("padding", dict(n=4, multicast_fraction=0.5, dest_range=(2, 5)),
     (0.05,), 50, ("NMP", "DPM"), dict(pad_packets=160, pad_stages=24,
                                       drain_grace=200)),
    ("broken_links_per_workload", dict(n=4, multicast_fraction=0.5,
                                       dest_range=(2, 5), drain_grace=300),
     (0.03, 0.05, 0.04), 50, ("DPM", "MP"),
     dict(broken_links_per_workload=[None, BROKEN, ()])),
]


@pytest.mark.parametrize("cfg_kw,rates,cycles,algos,kw",
                         [c[1:] for c in KEYWORD_CASES],
                         ids=[c[0] for c in KEYWORD_CASES])
def test_xsimulate_keyword_equals_reference(cfg_kw, rates, cycles, algos,
                                            kw):
    jcfg, tcfg = _cfgs(**cfg_kw)
    jw, tw = _workloads(jcfg, tcfg, rates, cycles, seed=3)
    if kw.get("cost_model") == NAME:
        jcore.register_cost_model(_measured(jnoc, jcfg.make_topology(), 1),
                                  name=NAME)
        tcore.register_cost_model(_measured(tnoc, tcfg.make_topology(), 1),
                                  name=NAME)
    ref = jnoc.xsimulate(jcfg, jw, algos, **kw)
    got = tnoc.xsimulate(tcfg, tw, algos, device="cpu", **kw)
    _assert_same_results(got, ref)
    if "drain_grace" in kw:
        assert got.cycles == max(w.horizon for w in tw) + kw["drain_grace"]
    if "pad_packets" in kw:
        assert got.traffic["link"].shape[1:] == (160, 24)
    if "epoch_len" in kw:
        assert got.lutil.shape[1] == -(-got.cycles // 16)


def test_compile_workload_keywords_and_their_refusals():
    cfg = tnoc.NoCConfig(n=4, multicast_fraction=0.5, dest_range=(2, 5))
    wl = tnoc.synthetic_workload(cfg, 0.05, 40, seed=1)
    from repro_torch.noc.xsim import compile_workload

    ct = compile_workload(cfg, wl, "DPM", pad_packets=200, pad_stages=30,
                          cost_model="contention", device="cpu")
    assert ct.link.shape == (200, 30)
    with pytest.raises(ValueError, match="smaller than workload"):
        compile_workload(cfg, wl, "DPM", pad_packets=3, device="cpu")
    with pytest.raises(ValueError, match="one entry per workload"):
        tnoc.xsimulate(cfg, [wl, wl], ("DPM",),
                       broken_links_per_workload=[None], device="cpu")
    curves, res = tnoc.latency_vs_rate_batched(
        cfg, [0.02, 0.04], ("MU",), cycles=40, seed=2, warmup=10,
        drain_grace=120, device="cpu")
    assert (res.warmup, res.cycles) == (10, 160)
    jcurves, _ = jnoc.latency_vs_rate_batched(
        jnoc.NoCConfig(n=4, multicast_fraction=0.5, dest_range=(2, 5)),
        [0.02, 0.04], ("MU",), cycles=40, seed=2, warmup=10, drain_grace=120)
    assert curves == jcurves


def test_calibrate_cost_model_equals_reference():
    kw = dict(n=6, warmup=0, drain_grace=300, multicast_fraction=0.4,
              dest_range=(3, 6))
    jcfg, tcfg = _cfgs(**kw)
    (jw,), (tw,) = _workloads(jcfg, tcfg, (0.06,), 60, seed=5)
    ref = jnoc.calibrate_cost_model(jcfg, jw, "DPM", name=NAME, max_iters=3)
    got = tnoc.calibrate_cost_model(tcfg, tw, "DPM", name=NAME, max_iters=3,
                                    device="cpu")
    assert got.to_dict() == ref.to_dict()
    assert got.plans_changed >= 1  # the loop moved a plan: not vacuous
    np.testing.assert_array_equal(got.model.weights, ref.model.weights)
    assert tcore.get_cost_model(NAME) is got.model
    assert (got.energy._per_hop, got.energy._per_packet) == (
        ref.energy._per_hop, ref.energy._per_packet)
    t = got.timing
    assert t["batched_plans"] + t["host_plans"] > 0
    assert t["wall_s"] >= t["signature_s"] + t["planner_s"] + t["compile_s"]


def test_a_name_registered_twice_never_serves_the_first_models_plans():
    cfg = tnoc.NoCConfig(n=6, multicast_fraction=0.6, dest_range=(3, 6))
    g = cfg.make_topology()
    wl = tnoc.synthetic_workload(cfg, 0.05, 40, seed=9)
    reqs = [(r.src, r.dests) for r in wl.requests]
    jg = jcore.make_topology("mesh", 6, 6)
    first, second = _measured(tnoc, g, 11), _measured(tnoc, g, 12)

    def run(model):
        tcore.unregister_cost_model(NAME)
        tcore.register_cost_model(model, name=NAME)
        bulk = tcore.bulk_plan(g, reqs, "DPM", cost_model=NAME, device="cpu")
        host = [tcore.plan("DPM", g, s, d, cost_model=NAME) for s, d in reqs]
        res = tnoc.xsimulate(cfg, [wl], ("DPM",), cost_model=NAME,
                             drain_grace=200, device="cpu")
        return bulk, host, res

    b1, h1, r1 = run(first)
    b2, h2, r2 = run(second)
    assert b1 == h1 and b2 == h2
    assert b1 != b2  # the second model moved at least one plan
    jcore.register_cost_model(_measured(jnoc, jg, 12), name=NAME)
    ref = [jcore.plan("DPM", jg, s, d, cost_model=NAME) for s, d in reqs]
    assert [[(p.hops, p.deliveries, p.parent) for p in x.paths] for x in b2] \
        == [[(p.hops, p.deliveries, p.parent) for p in x.paths] for x in ref]
    jres = jnoc.xsimulate(
        jnoc.NoCConfig(n=6, multicast_fraction=0.6, dest_range=(3, 6)),
        [jnoc.synthetic_workload(jnoc.NoCConfig(
            n=6, multicast_fraction=0.6, dest_range=(3, 6)), 0.05, 40,
            seed=9)],
        ("DPM",), cost_model=NAME, drain_grace=200)
    _assert_same_results(r2, jres)
    assert isinstance(tcore.get_cost_model(NAME), MeasuredContentionCost)
