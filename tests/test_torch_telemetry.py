"""The port's NoC telemetry (``repro_torch.noc.telemetry``) on the CPU
against ``repro``'s: directed-link ids, the latency histogram, epoch rows,
the host simulator's counters on ``tests/test_telemetry.py``'s workloads,
the fitted cost models; and the port's own xsim link planes equal to its
host counters, which pins that ``link_index`` and the xsim geometry index
links alike."""
import numpy as np
import pytest

import repro.core as jcore
import repro.noc as jnoc
import repro_torch.core as tcore
import repro_torch.noc as tnoc
from repro_torch.noc import (
    LatencyHistogram,
    MeasuredContentionCost,
    Telemetry,
    fit_energy_cost,
    link_coords,
    link_index,
)

from test_torch_noc_sim import assert_same_stats

GRACE = 800
DEGRADED = (((3, 3), (4, 3)), ((3, 4), (3, 5)), ((0, 0), (1, 0)),
            ((6, 6), (6, 7)))
# tests/test_telemetry.py's cases: (name, NoCConfig kwargs, rate, cycles,
# seed)
CASES = [
    ("mesh", dict(n=5, multicast_fraction=0.5, dest_range=(3, 6),
                  drain_grace=GRACE), 0.04, 150, 2),
    ("degraded-8x8", dict(warmup=0, drain_grace=GRACE, multicast_fraction=0.4,
                          dest_range=(3, 6), broken_links=DEGRADED),
     0.025, 150, 2),
]
IDS = [c[0] for c in CASES]


def _host_run(core, noc, kw, rate, cycles, seed, algo="DPM"):
    cfg = noc.NoCConfig(**kw)
    wl = noc.synthetic_workload(cfg, rate, cycles, seed=seed)
    g = core.make_topology(cfg.topology, cfg.n, cfg.m, cfg.broken_links)
    sim = noc.WormholeSim(cfg, measure_window=(0, wl.horizon))
    for r in wl.requests:
        sim.add_plan(core.plan(algo, g, r.src, r.dests), r.time)
    return cfg, wl, g, sim.run(wl.horizon + cfg.drain_grace)


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_link_index_round_trips_and_matches_reference(topology):
    t = tcore.make_topology(topology, 4, 4)
    j = jcore.make_topology(topology, 4, 4)
    ids = set()
    for u in t.nodes():
        for v in t.neighbors(*u):
            lid = link_index(t, u, v)
            assert lid == jnoc.link_index(j, u, v)
            assert link_coords(t, lid) == jnoc.link_coords(j, lid) == (u, v)
            ids.add(lid)
    assert len(ids) == (64 if topology == "torus" else 48)
    assert all(0 <= i < 16 * 4 for i in ids)
    with pytest.raises(ValueError):
        link_index(t, (0, 0), (2, 0))  # two hops is not a link
    if topology == "torus":  # +x wrap resolves via the signed delta
        lid = link_index(t, (3, 0), (0, 0))
        assert link_coords(t, lid) == ((3, 0), (0, 0))


def test_latency_histogram_matches_reference():
    lats = (0, 1, 2, 3, 4, 7, 8, 2**40, 5, 5, 9, 130)
    h, jh = LatencyHistogram(), jnoc.LatencyHistogram()
    for lat in lats:
        h.add(lat)
        jh.add(lat)
    np.testing.assert_array_equal(h.counts, jh.counts)
    assert h.counts.dtype == jh.counts.dtype
    assert h.counts[-1] == 1  # overflow absorbs into the last bucket
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.to_dict() == jh.to_dict()
    assert LatencyHistogram().quantile(0.5) == 0
    with pytest.raises(ValueError):
        h.quantile(1.5)
    np.testing.assert_array_equal(
        LatencyHistogram.from_latencies([5, 5, 9]).counts,
        jnoc.LatencyHistogram.from_latencies([5, 5, 9]).counts)


def test_epoch_rows_grow_on_demand_as_reference():
    tms = [Telemetry(num_nodes=4, vcs_per_class=2, epoch_len=1),
           jnoc.Telemetry(num_nodes=4, vcs_per_class=2, epoch_len=1)]
    for tm in tms:
        tm.flit(0, 0, cycle=0)
        tm.flit(1, 1, cycle=5)
        tm.occupancy(1, 3, 2)
        tm.conflicts(2, 3)
        tm.stall(2)
        tm.latency(3, cycle=5)
    tm, jtm = tms
    assert tm.num_epochs == jtm.num_epochs == 6
    np.testing.assert_array_equal(tm.epoch_link_flits(), jtm.epoch_link_flits())
    assert tm.epoch_series() == jtm.epoch_series()
    assert tm.to_dict() == jtm.to_dict()
    np.testing.assert_array_equal(tm.router_conflicts(), jtm.router_conflicts())
    with pytest.raises(ValueError):
        Telemetry(4, 2, epoch_len=0)
    empty = Telemetry(4, 2)
    assert empty.epoch_link_flits().shape == (0, 16)
    assert empty.epoch_series() == []


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_host_telemetry_matches_reference(case):
    _, kw, rate, cycles, seed = case
    _, _, g, st = _host_run(tcore, tnoc, kw, rate, cycles, seed)
    _, _, jg, js = _host_run(jcore, jnoc, kw, rate, cycles, seed)
    assert_same_stats(st, js)
    tm = st.telemetry
    np.testing.assert_array_equal(tm.heatmap(g), js.telemetry.heatmap(jg))
    np.testing.assert_array_equal(tm.router_conflicts(),
                                  js.telemetry.router_conflicts())
    # the structured view and the flat aggregates count the same events
    assert int(tm.link_flits.sum()) == st.flit_link_traversals
    assert int(tm.vc_class_flits.sum()) == st.flit_link_traversals
    assert int(tm.epoch_link_flits().sum()) == st.flit_link_traversals
    assert tm.latency_hist.total == len(st.latencies)
    assert 1 <= tm.occupancy_hwm.max() <= kw.get("buffer_depth", 4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_xsim_link_planes_match_port_host_counters(case):
    _, kw, rate, cycles, seed = case
    kw = dict(kw, drain_grace=300)  # both workloads drain well before
    cfg, wl, g, st = _host_run(tcore, tnoc, kw, rate, cycles, seed)
    res = tnoc.xsimulate(cfg, [wl], ("DPM",), device="cpu")
    assert res.all_drained(0, 0)
    # per-link flit traversals are conserved events: exact, link by link,
    # on the degraded mesh's detoured routes too
    np.testing.assert_array_equal(res.link_utilization(0, 0),
                                  st.telemetry.link_flits)
    np.testing.assert_array_equal(res.link_heatmap(0, 0),
                                  st.telemetry.heatmap(g))
    assert res.router_conflicts(0, 0).shape == (g.num_nodes,)


def test_measured_contention_cost_matches_reference():
    g, jg = tcore.grid(4), jcore.grid(4)
    util = np.zeros(g.num_nodes * 4)
    util[5] = 100.0
    m, jm = MeasuredContentionCost(g, util), jnoc.MeasuredContentionCost(
        jg, util)
    np.testing.assert_array_equal(m.weights, jm.weights)
    u, v = link_coords(g, 5)
    assert m.link_cost(g, u, v) == jm.link_cost(jg, u, v) == 2.0
    assert m.link_cost(g, *link_coords(g, 0)) == 1.0
    with pytest.raises(ValueError):  # wrong shape
        MeasuredContentionCost(g, np.zeros(3))
    with pytest.raises(ValueError):  # calibrated for another fabric
        m.link_cost(tcore.grid(5), (0, 0), (1, 0))
    # hysteresis: sub-quantum movement keeps the previous weights exactly
    drift = util + 100.0 / (3 * m.QUANT)
    m2 = MeasuredContentionCost(g, drift, prev=m)
    np.testing.assert_array_equal(m2.weights, m.weights)
    np.testing.assert_array_equal(
        m2.weights, jnoc.MeasuredContentionCost(jg, drift, prev=jm).weights)
    util2 = util.copy()
    util2[7] = 50.0
    m3 = MeasuredContentionCost(g, util2, prev=m)
    assert m3.weights[7] > m.weights[7]
    np.testing.assert_array_equal(
        m3.weights, jnoc.MeasuredContentionCost(jg, util2, prev=jm).weights)
    assert (MeasuredContentionCost(g, np.zeros(64)).weights == 1.0).all()
    # a calibrated model prices plans like any other cost model
    p = tcore.plan("DPM", g, (0, 0), [(3, 3), (3, 0), (0, 3)], cost_model=m3)
    jp = jcore.plan("DPM", jg, (0, 0), [(3, 3), (3, 0), (0, 3)],
                    cost_model=jnoc.MeasuredContentionCost(jg, util2,
                                                           prev=jm))
    assert [path.hops for path in p.paths] == [path.hops for path in jp.paths]


def test_fit_energy_cost_matches_reference():
    cfg = tnoc.NoCConfig()
    F = cfg.flits_per_packet
    ctr = {
        "flit_link_traversals": 10 * F, "buffer_writes": 10 * F,
        "buffer_reads": 10 * F + 3, "xbar_traversals": 10 * F,
        "arbitrations": 13, "ni_flits": 2 * F + 1, "packets_finished": 2,
    }
    m = fit_energy_cost(ctr, cfg.energy, F)
    jm = jnoc.fit_energy_cost(ctr, jnoc.NoCConfig().energy, F)
    assert m._per_hop == jm._per_hop and m._per_packet == jm._per_packet
    # attribute-style counters (a SimStats) fit identically
    _, _, _, st = _host_run(tcore, tnoc, *CASES[0][1:])
    _, _, _, js = _host_run(jcore, jnoc, *CASES[0][1:])
    a = fit_energy_cost(st, cfg.energy, F)
    b = jnoc.fit_energy_cost(js, jnoc.NoCConfig().energy, F)
    assert (a._per_hop, a._per_packet) == (b._per_hop, b._per_packet)
    g = tcore.grid(4)
    assert a.route_cost(g, [(0, 0), (1, 0), (2, 0)]) == 2 * a._per_hop
