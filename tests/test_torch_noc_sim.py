"""The port's host NoC (``WormholeSim``, ``simulate``, ``latency_vs_rate``)
on the CPU against ``repro``'s on the same workloads: every ``SimStats``
field, ``latencies`` element by element, every ``Telemetry`` array and the
per-packet delivery sets are identical. Then the port's own host-vs-xsim
contract, as ``tests/test_xsim.py`` states it for the reference."""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.noc as jnoc
import repro_torch.core as tcore
import repro_torch.noc as tnoc

GRACE = 800

# tests/test_xsim.py's CASES: (name, NoCConfig kwargs, rate, cycles, seed,
# algo) — mesh and torus, unicast-only and multicast-heavy, with DPM
# children, MP chains and NMP tours
CASES = [
    ("mesh-unicast-MU", dict(n=4, multicast_fraction=0.0), 0.05, 100, 1, "MU"),
    ("mesh-mcheavy-DPM", dict(n=5, multicast_fraction=0.5, dest_range=(3, 6)),
     0.04, 150, 2, "DPM"),
    ("mesh-mcheavy-MP", dict(n=5, multicast_fraction=0.5, dest_range=(3, 6)),
     0.04, 150, 2, "MP"),
    ("torus-DPM", dict(n=4, topology="torus", dest_range=(2, 5)), 0.06, 150, 3,
     "DPM"),
    ("torus-NMP", dict(n=4, topology="torus", dest_range=(2, 5)), 0.06, 150, 3,
     "NMP"),
]
IDS = [c[0] for c in CASES]
TELEMETRY_ARRAYS = ("link_flits", "vc_class_flits", "occupancy_hwm",
                    "link_conflicts", "credit_stalls")


def assert_same_stats(ts, js):
    """Every SimStats field and every Telemetry array equal."""
    names = [f.name for f in dataclasses.fields(js)]
    assert [f.name for f in dataclasses.fields(ts)] == names
    for name in names:
        if name != "telemetry":
            assert getattr(ts, name) == getattr(js, name), name
    assert ts.avg_latency == js.avg_latency
    tt, jt = ts.telemetry, js.telemetry
    for name in TELEMETRY_ARRAYS:
        a, b = getattr(tt, name), getattr(jt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(tt.epoch_link_flits(), jt.epoch_link_flits())
    np.testing.assert_array_equal(tt.latency_hist.counts,
                                  jt.latency_hist.counts)
    assert tt.epoch_series() == jt.epoch_series()
    assert tt.to_dict() == jt.to_dict()


def delivered_sets(sim):
    return {p.pid: {sim.g.idx(c) for c in p.delivery_times}
            for p in sim.packets}


def with_mixed_flits(wl):
    """``wl`` with per-request worm lengths 1..6 (trace payloads vary)."""
    wl.requests = [dataclasses.replace(r, flits=1 + i % 6)
                   for i, r in enumerate(wl.requests)]
    assert {r.flits for r in wl.requests} == set(range(1, 7))
    return wl


def _host_runs(kw, rate, cycles, seed, algo, grace=GRACE):
    """Both packages' WormholeSim over the same workload, each request
    planned with its own package's plan() and ingested by add_plan."""
    out = []
    for core, noc in ((tcore, tnoc), (jcore, jnoc)):
        cfg = noc.NoCConfig(**kw)
        wl = noc.synthetic_workload(cfg, rate, cycles, seed=seed)
        g = core.make_topology(cfg.topology, cfg.n, cfg.m, cfg.broken_links)
        sim = noc.WormholeSim(cfg, measure_window=(0, wl.horizon))
        for r in wl.requests:
            sim.add_plan(core.plan(algo, g, r.src, r.dests), r.time)
        out.append((sim, sim.run(wl.horizon + grace)))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wormhole_sim_matches_reference(case):
    _, kw, rate, cycles, seed, algo = case
    (tsim, ts), (jsim, js) = _host_runs(kw, rate, cycles, seed, algo)
    assert_same_stats(ts, js)
    assert ts.packets_finished == ts.packets_created > 0
    assert delivered_sets(tsim) == delivered_sets(jsim)
    assert [p.header_times for p in tsim.packets] == [
        p.header_times for p in jsim.packets]


SIMULATE_CASES = [
    ("mesh8x8-MU", dict(), 0.03, 200, 4, "MU"),
    ("mesh8x8-DPM", dict(), 0.03, 200, 4, "DPM"),
    ("mesh8x8-DPM-E", dict(dest_range=(7, 10)), 0.02, 200, 5, "DPM-E"),
    ("torus6x6-DP", dict(n=6, topology="torus"), 0.05, 200, 6, "DP"),
    ("mesh8x8-flits1to6", dict(multicast_fraction=0.3), 0.04, 200, 7,
     "DPM"),
]


@pytest.mark.parametrize("case", SIMULATE_CASES,
                         ids=[c[0] for c in SIMULATE_CASES])
def test_simulate_matches_reference(case):
    _, kw, rate, cycles, seed, algo = case
    kw = dict(kw, warmup=50, drain_grace=600)
    tc, jc = tnoc.NoCConfig(**kw), jnoc.NoCConfig(**kw)
    tw = tnoc.synthetic_workload(tc, rate, cycles, seed=seed)
    jw = jnoc.synthetic_workload(jc, rate, cycles, seed=seed)
    if "flits1to6" in case[0]:
        tw, jw = with_mixed_flits(tw), with_mixed_flits(jw)
    assert_same_stats(tnoc.simulate(tc, tw, algo), jnoc.simulate(jc, jw, algo))


@pytest.mark.parametrize("bench", ["canneal", "fluidanimate"])
def test_parsec_profile_matches_reference(bench):
    kw = dict(warmup=50, drain_grace=800)
    tc, jc = tnoc.NoCConfig(**kw), jnoc.NoCConfig(**kw)
    tw = tnoc.parsec_workload(tc, bench, 200, seed=1)
    jw = jnoc.parsec_workload(jc, bench, 200, seed=1)
    for algo in ("MU", "DPM"):
        assert_same_stats(tnoc.simulate(tc, tw, algo),
                          jnoc.simulate(jc, jw, algo))


def test_latency_vs_rate_matches_reference():
    kw = dict(n=4, dest_range=(2, 5), warmup=20, drain_grace=400)
    rates = [0.02, 0.1, 0.4, 0.6]
    got = tnoc.latency_vs_rate(tnoc.NoCConfig(**kw), rates, "DPM", cycles=120,
                               saturation_cap=30.0)
    want = jnoc.latency_vs_rate(jnoc.NoCConfig(**kw), rates, "DPM",
                                cycles=120, saturation_cap=30.0)
    assert got == want
    assert len(got) < len(rates)  # the saturation cap cut the sweep


@pytest.mark.parametrize("algo", ["MU", "DPM", "DPM-E", "DPM-flits1to6"])
def test_add_requests_matches_add_request_and_reference(algo):
    mixed = algo.endswith("-flits1to6")
    algo = algo.removesuffix("-flits1to6")
    kw = dict(n=6, topology="torus" if algo == "DPM-E" else "mesh",
              multicast_fraction=0.4, dest_range=(3, 8), warmup=0,
              drain_grace=600)
    tc, jc = tnoc.NoCConfig(**kw), jnoc.NoCConfig(**kw)
    tw = tnoc.synthetic_workload(tc, 0.04, 120, seed=8)
    jw = jnoc.synthetic_workload(jc, 0.04, 120, seed=8)
    if mixed:
        tw, jw = with_mixed_flits(tw), with_mixed_flits(jw)
    tcore.arena_clear()
    bulk = tnoc.WormholeSim(tc, measure_window=(0, tw.horizon))
    pids = bulk.add_requests(algo, tw.requests, device="cpu")
    one = tnoc.WormholeSim(tc, measure_window=(0, tw.horizon))
    one_pids = [one.add_request(algo, r.src, r.dests, r.time, flits=r.flits)
                for r in tw.requests]
    ref = jnoc.WormholeSim(jc, measure_window=(0, jw.horizon))
    ref_pids = ref.add_requests(algo, jw.requests)
    assert pids == one_pids == ref_pids
    end = tw.horizon + kw["drain_grace"]
    bs, os_, rs = bulk.run(end), one.run(end), ref.run(end)
    assert_same_stats(bs, os_)
    assert_same_stats(bs, rs)
    assert delivered_sets(bulk) == delivered_sets(one) == delivered_sets(ref)
    worms = [p.flits for p in bulk.packets]
    assert worms == [p.flits for p in ref.packets]
    assert (len(set(worms)) == 6) == mixed  # the lengths reached the worms


def test_add_plan_refuses_a_broken_link_and_bad_worms():
    cfg = tnoc.NoCConfig(n=4, broken_links=(((1, 0), (2, 0)),))
    sim = tnoc.WormholeSim(cfg)
    healthy = tcore.plan("MU", tcore.grid(4), (0, 0), [(3, 0)])
    with pytest.raises(ValueError, match="broken link"):
        sim.add_plan(healthy, 0)
    with pytest.raises(ValueError, match="at least one flit"):
        tnoc.WormholeSim(tnoc.NoCConfig(n=4)).add_plan(healthy, 0, flits=0)
    # the fault-aware planner detours, and the detour is admitted
    assert sim.add_request("MU", (0, 0), [(3, 0)], 0)
    st = sim.run(200)
    assert st.packets_finished == st.packets_created > 0
    assert st.latencies and not sim._pending and not sim._active


# the port's own host-vs-xsim contract (tests/test_xsim.py), on the CPU: the
# same delivery sets, conserved counts and per-link flits, latency within 10%
XSIM_CASES = [CASES[1], CASES[4]]


@pytest.mark.parametrize("case", XSIM_CASES, ids=[c[0] for c in XSIM_CASES])
def test_port_xsim_matches_port_wormhole(case):
    _, kw, rate, cycles, seed, algo = case
    cfg = tnoc.NoCConfig(**kw, warmup=0, drain_grace=300)
    wl = tnoc.synthetic_workload(cfg, rate, cycles, seed=seed)
    res = tnoc.xsimulate(cfg, [wl], (algo,), device="cpu")
    g = tcore.make_topology(cfg.topology, cfg.n, cfg.m)
    sim = tnoc.WormholeSim(cfg, measure_window=(0, wl.horizon))
    for r in wl.requests:
        sim.add_plan(tcore.plan(algo, g, r.src, r.dests), r.time)
    pst = sim.run(wl.horizon + GRACE)
    xst = res.stats(0, 0)
    assert res.all_drained(0, 0)
    assert pst.packets_finished == pst.packets_created
    assert res.delivered_sets(0, 0) == delivered_sets(sim)
    assert xst.flit_link_traversals == pst.flit_link_traversals
    assert xst.packets_created == pst.packets_created
    assert xst.packets_finished == pst.packets_finished
    np.testing.assert_array_equal(res.link_utilization(0, 0),
                                  pst.telemetry.link_flits)
    assert xst.avg_latency == pytest.approx(pst.avg_latency, rel=0.10)
    assert len(xst.latencies) == len(pst.latencies)


def test_add_requests_refuses_a_missing_card(monkeypatch):
    import torch

    cfg = tnoc.NoCConfig(n=4)
    wl = tnoc.synthetic_workload(cfg, 0.05, 10, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for algo in ("MU", "DPM"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnoc.WormholeSim(cfg).add_requests(algo, wl.requests)
