"""The port's 3-D mesh/torus and chiplet-package fabrics against ``repro``'s,
on the CPU, through the whole main path: geometry, every planner, the
weighted cost model, fault detours, route providers and cost matrices,
batched planning at 26 wedges, the generic DPM tables, the generic xsim
lowering, the batched xsim engine, the host simulator's telemetry, and the
committed ``benchmarks/results/topo3d_sweep.json`` rows that a CPU run can
reproduce (weighted planning, host-vs-xsim parity).

Fabrics: ``mesh3d``/``torus3d`` 3x3x3, a ``mesh3d`` 3x3x3 whose z-links
weigh 2.0, and a ``chiplet`` package of 2x2 dies of 4x4 routers. Inputs come
from numpy seeds (and the generators' own ``random.Random`` seeds).
Everything compared is integer or computed in the same float order: the
tolerance is exact equality.
"""
import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.noc as jnoc
import repro_torch.core as tcore
import repro_torch.noc as tnoc
from repro.core.routefn import provider_for as jprovider_for
from repro.kernels.dpm_cost.ops import dpm_plan_topo as jdpm_plan_topo
from repro.noc.xsim.compile import compile_workload as jcompile_workload
from repro_torch.core.batch_planner import membership_table
from repro_torch.core.routefn import provider_for
from repro_torch.kernels.dpm_cost.ops import (
    dpm_plan_topo,
    partition_membership,
    snake_labels,
)
from repro_torch.noc.xsim.compile import compile_workload

from test_torch_noc_sim import assert_same_stats

ARTIFACT = json.loads(
    (Path(__file__).resolve().parents[1] / "benchmarks" / "results"
     / "topo3d_sweep.json").read_text())
GRACE = 800
ALGOS = ("MU", "DP", "MP", "NMP", "DPM", "DPM-E")
# (id, kind, n, m, params)
FABRICS = [
    ("mesh3d", "mesh3d", 3, 3, (3,)),
    ("torus3d", "torus3d", 3, 3, (3,)),
    ("mesh3d-zw2", "mesh3d", 3, 3, (3, 2.0)),
    ("chiplet", "chiplet", 8, 8, (2, 2)),
]
FIDS = [f[0] for f in FABRICS]


def _pair(kind, n, m, params, broken=()):
    return (jcore.make_topology(kind, n, m, broken, params),
            tcore.make_topology(kind, n, m, broken, params))


def _requests(g, count, seed, kmax=8):
    """(src, dests) pairs drawn with a numpy seed."""
    rng = np.random.default_rng(seed)
    nodes = g.nodes()
    out = []
    for _ in range(count):
        pick = rng.choice(len(nodes), int(rng.integers(3, kmax + 2)),
                          replace=False)
        out.append((nodes[pick[0]], [nodes[i] for i in pick[1:]]))
    return out


def _as_tuple(p) -> tuple:
    return (
        p.algorithm, tuple(p.src), tuple(map(tuple, p.dests)),
        tuple(
            (tuple(map(tuple, q.hops)), tuple(map(tuple, q.deliveries)),
             q.parent)
            for q in p.paths
        ),
        p.total_hops,
    )


@pytest.fixture(autouse=True)
def _fresh_caches():
    for mod in (jcore, tcore):
        mod.plan_cache_clear()
        mod.arena_clear()
    yield
    for mod in (jcore, tcore):
        mod.plan_cache_clear()
        mod.arena_clear()


# ---------------------------------------------------------------- geometry
def test_kinds_and_exports_match_the_reference():
    from repro.core.algo import TOPOLOGY_KINDS as JKINDS
    from repro_torch.core.algo import TOPOLOGY_KINDS as TKINDS

    assert TKINDS == JKINDS
    assert tcore.registered_topology_kinds() == \
        jcore.registered_topology_kinds()
    for name in ("Mesh3D", "Torus3D", "ChipletPackage", "mesh3d", "torus3d",
                 "chiplet"):
        assert name in tcore.__all__
    assert tcore.mesh3d(3) is tcore.make_topology("mesh3d", 3, 3, params=(3,))
    assert tcore.chiplet(8, 8, 2, 2) is \
        tcore.make_topology("chiplet", 8, 8, params=(2, 2))
    with pytest.raises(ValueError, match="already registered"):
        tcore.register_topology("chiplet", tcore.chiplet)


@pytest.mark.parametrize("fid,kind,n,m,params", FABRICS, ids=FIDS)
def test_geometry_matches_reference(fid, kind, n, m, params):
    """Every node's label, neighbours, distance, delta, direction, link
    weight; the label tables; the protocol attributes."""
    j, t = _pair(kind, n, m, params)
    for attr in ("kind", "wrap", "ports", "n", "m", "rows", "num_nodes",
                 "params"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert getattr(t, "needs_bfs_routes", False) == \
        getattr(j, "needs_bfs_routes", False)
    assert t.nodes() == j.nodes()
    np.testing.assert_array_equal(t.all_labels(), j.all_labels())
    np.testing.assert_array_equal(t.label_table(), j.label_table())
    nodes = t.nodes()
    for u in nodes:
        assert t.label(*u) == j.label(*u)
        assert t.unlabel(t.label(*u)) == u
        assert t.idx(u) == j.idx(u) and t.from_idx(t.idx(u)) == u
        assert t.neighbors(*u) == j.neighbors(*u)
        for v in t.neighbors(*u):
            assert t.direction(u, v) == j.direction(u, v)
            assert t.link_weight(u, v) == j.link_weight(u, v)
        for v in nodes:
            assert t.delta(u, v) == j.delta(u, v)
            assert t.distance(u, v) == j.distance(u, v)
    for d in range(t.ports):
        assert t.dir_delta(d) == j.dir_delta(d)


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("fid,kind,n,m,params", FABRICS, ids=FIDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_plans_match_reference(fid, kind, n, m, params, algo):
    """Plan by plan, for every registered algorithm: hops, deliveries,
    parents. Chiplet plans come back split into label-monotone worms."""
    j, t = _pair(kind, n, m, params)
    assert tcore.available_algorithms(t) == jcore.available_algorithms(j)
    for src, dests in _requests(t, 10, seed=len(algo) + n):
        tp = tcore.plan(algo, t, src, dests)
        assert _as_tuple(tp) == _as_tuple(jcore.plan(algo, j, src, dests))
        assert tp.check_covers()
        if kind == "chiplet":
            for q in tp.paths:
                labs = [t.label(*h) for h in q.hops]
                steps = np.sign(np.diff(labs))
                assert len(set(steps.tolist())) <= 1


@pytest.mark.parametrize("cm", ["weighted", "contention", "energy"])
def test_cost_models_plan_like_reference(cm):
    """The cost models' prices on the 3-D extents (contention's cut per
    axis) and plans under them."""
    j, t = _pair("mesh3d", 3, 3, (3, 2.0))
    jm, tm = jcore.get_cost_model(cm), tcore.get_cost_model(cm)
    for u in t.nodes():
        for v in t.neighbors(*u):
            assert tm.link_cost(t, u, v) == jm.link_cost(j, u, v)
    for src, dests in _requests(t, 8, seed=3):
        assert _as_tuple(tcore.plan("DPM", t, src, dests, cost_model=cm)) \
            == _as_tuple(jcore.plan("DPM", j, src, dests, cost_model=cm))


def _weighted_cost(g, p):
    return sum(g.link_weight(u, v) for q in p.paths
               for u, v in zip(q.hops, q.hops[1:]))


@pytest.mark.parametrize("row", range(2), ids=["mesh3d-zw4", "chiplet-noi6"])
def test_weighted_planning_reproduces_the_artifact(row):
    """``topo3d_sweep.json``'s ``weighted_planning`` rows: DPM under the
    ``weighted`` model against hop-count DPM on a 4x4x4 mesh whose z-links
    weigh 4 and a 2x2-die package whose interposer links weigh 6 (the
    benchmark's instance generator and seeds)."""
    want = ARTIFACT["weighted_planning"][row]
    g = (tcore.make_topology("mesh3d", 4, 4, params=(4, 4.0)),
         tcore.make_topology("chiplet", 8, 8, params=(2, 2, 6.0)))[row]
    rng = random.Random((5, 6)[row])
    nodes = g.nodes()
    changed, cost_u, cost_w = 0, 0.0, 0.0
    for _ in range(want["instances"]):
        picks = rng.sample(nodes, rng.randint(3, 11))
        src, dests = picks[0], picks[1:]
        p_u = tcore.plan("DPM", g, src, dests)
        p_w = tcore.plan("DPM", g, src, dests, cost_model="weighted")
        cost_u += _weighted_cost(g, p_u)
        cost_w += _weighted_cost(g, p_w)
        if sorted(tuple(q.hops) for q in p_u.paths) != \
                sorted(tuple(q.hops) for q in p_w.paths):
            changed += 1
    assert changed == want["plans_changed"]
    assert round(cost_u, 1) == want["weighted_cost_hopmodel"]
    assert round(cost_w, 1) == want["weighted_cost_weightedmodel"]
    assert cost_w < cost_u


@pytest.mark.parametrize("kind,n,params,broken,src,dests", [
    ("mesh3d", 3, (3,), (((1, 1, 0), (1, 1, 1)),),
     (1, 1, 0), [(1, 1, 1), (1, 1, 2), (0, 0, 2)]),
    ("chiplet", 8, (2, 2), (((3, 0), (4, 0)),),
     (0, 0), [(7, 0), (7, 7), (4, 3)]),
], ids=["mesh3d", "chiplet-noi"])
def test_fault_detours_match_reference(kind, n, params, broken, src, dests):
    j, t = _pair(kind, n, n, params, broken)
    assert provider_for(t).name == jprovider_for(j).name == "fault-aware"
    for algo in ALGOS:
        tp = tcore.plan(algo, t, src, dests)
        assert _as_tuple(tp) == _as_tuple(jcore.plan(algo, j, src, dests))
        assert tp.check_covers()
        for q in tp.paths:
            for a, b in zip(q.hops, q.hops[1:]):
                assert not t.is_broken(a, b)
    for src, dests in _requests(t, 6, seed=17):
        assert _as_tuple(tcore.plan("DPM", t, src, dests)) == \
            _as_tuple(jcore.plan("DPM", j, src, dests))


@pytest.mark.parametrize("fid,kind,n,m,params", FABRICS, ids=FIDS)
def test_providers_and_cost_tensors_match_reference(fid, kind, n, m, params):
    """``provider_for`` dispatch (BFS on the chiplet package), and the
    dense route-cost and link-price tensors under each cost model."""
    j, t = _pair(kind, n, m, params)
    pt, pj = provider_for(t), jprovider_for(j)
    assert type(pt).__name__ == type(pj).__name__
    assert pt.name == ("bfs" if kind == "chiplet" else "minimal")
    for cm in (None, "weighted", "contention"):
        tm = None if cm is None else tcore.get_cost_model(cm)
        jm = None if cm is None else jcore.get_cost_model(cm)
        for a, b in zip(tcore.route_cost_matrices(t, tm),
                        jcore.route_cost_matrices(j, jm)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        w = pt.link_weights(t, tm)
        np.testing.assert_array_equal(w, pj.link_weights(j, jm))
        assert w.shape == (t.num_nodes * t.ports,)
        assert int(np.isfinite(w).sum()) == sum(
            len(t.neighbors(*u)) for u in t.nodes())


# ------------------------------------------------------- batched planning
@pytest.mark.parametrize("fid,kind,n,m,params", FABRICS, ids=FIDS)
@pytest.mark.parametrize("algo,cm", [("DPM", "hops"), ("DPM", "weighted"),
                                     ("DPM-E", "energy")])
def test_bulk_plan_equals_host_plan(fid, kind, n, m, params, algo, cm):
    """``bulk_plan(device="cpu")`` at 26 wedges (8 on the chiplet package):
    every batched plan equal to host ``plan()`` of both packages, the
    planner's membership table the reference's."""
    j, t = _pair(kind, n, m, params)
    pl = tcore.planner_for(t, algo, cm, device="cpu")
    assert pl.np_ == (8 if kind == "chiplet" else 26)
    np.testing.assert_array_equal(membership_table(t),
                                  jcore.batch_planner.membership_table(j))
    reqs = _requests(t, 24, seed=n * 7 + len(algo))
    got = tcore.bulk_plan(t, reqs, algo, cm, device="cpu")
    for (src, dests), p in zip(reqs, got):
        assert _as_tuple(p) == _as_tuple(
            tcore.plan(algo, t, src, dests, cost_model=cm))
        assert _as_tuple(p) == _as_tuple(
            jcore.plan(algo, j, src, dests, cost_model=cm))
    info = pl.info()
    assert info.misses > 0
    assert info.batched_plans == (info.misses if pl.support.ok else 0)
    if cm != "energy":
        assert pl.support.ok, pl.support.reason


@pytest.mark.parametrize("fid,kind,n,m,params", FABRICS, ids=FIDS)
def test_dpm_plan_topo_matches_reference(fid, kind, n, m, params):
    """The generic DPM tables (wedge membership, snake labels, route-cost
    tensors) and Algorithm 1 over them, against the reference's jnp."""
    j, t = _pair(kind, n, m, params)
    np_ = len(tcore.wedge_patterns(len(t.from_idx(0))))
    rng = np.random.default_rng(n + len(params))
    NN = t.num_nodes
    srcs = [t.from_idx(int(i)) for i in rng.integers(0, NN, 10)]
    masks = np.zeros((10, NN), np.int32)
    for p, s in enumerate(srcs):
        others = [i for i in range(NN) if i != t.idx(s)]
        masks[p, rng.choice(others, size=6, replace=False)] = 1
    from repro.kernels.dpm_cost.ops import partition_membership as jpm
    from repro.kernels.dpm_cost.ops import snake_labels as jsl

    memb = partition_membership(t, srcs)
    np.testing.assert_array_equal(memb, jpm(j, srcs))
    np.testing.assert_array_equal(snake_labels(t), jsl(j))
    part = np.where(masks > 0, memb, -1).astype(np.int32)
    sidx = np.array([t.idx(s) for s in srcs], np.int32)
    for cm in (None, "weighted"):
        tm = None if cm is None else tcore.get_cost_model(cm)
        dist, weight, overhead = tcore.route_cost_matrices(t, tm)
        got = dpm_plan_topo(part, sidx, snake_labels(t), dist, weight,
                            np_=np_, overhead=float(overhead), device="cpu")
        want = jdpm_plan_topo(
            jnp.asarray(part), jnp.asarray(sidx), jnp.asarray(snake_labels(t)),
            jnp.asarray(dist), jnp.asarray(weight), np_=np_,
            overhead=float(overhead))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ xsim
# tests/test_topo3d.py's host-vs-xsim cases: (id, NoCConfig kwargs, rate,
# cycles, seed, algo)
CASES = [
    ("mesh3d-DPM", dict(n=3, m=3, topology="mesh3d", topology_params=(3,),
                        dest_range=(2, 5)), 0.03, 100, 1, "DPM"),
    ("mesh3d-MU", dict(n=3, m=3, topology="mesh3d", topology_params=(3,),
                       dest_range=(2, 5)), 0.03, 100, 1, "MU"),
    ("torus3d-DPM", dict(n=3, m=3, topology="torus3d", topology_params=(3,),
                         dest_range=(2, 5)), 0.03, 100, 2, "DPM"),
    ("mesh3d-weighted-z-DPM",
     dict(n=3, m=3, topology="mesh3d", topology_params=(3, 2.0),
          dest_range=(2, 5)), 0.03, 100, 4, "DPM"),
    ("chiplet-DPM", dict(n=8, m=8, topology="chiplet", topology_params=(2, 2),
                         dest_range=(2, 5)), 0.02, 100, 3, "DPM"),
    ("chiplet-MP", dict(n=8, m=8, topology="chiplet", topology_params=(2, 2),
                        dest_range=(2, 5)), 0.02, 100, 3, "MP"),
]
CIDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CIDS)
def test_generic_lowering_matches_reference(case):
    """The per-hop lowering of the non-2-D kinds: ``link``, ``vcls`` and
    ``node`` (and every other compiled array) equal the reference's."""
    _, kw, rate, cycles, seed, algo = case
    jc, tc = jnoc.NoCConfig(**kw), tnoc.NoCConfig(**kw)
    assert tc.rows == jc.rows and tc.num_nodes == jc.num_nodes
    jw = jnoc.synthetic_workload(jc, rate, cycles, seed=seed)
    tw = tnoc.synthetic_workload(tc, rate, cycles, seed=seed)
    assert [(r.time, r.src, r.dests) for r in tw.requests] == \
        [(r.time, r.src, r.dests) for r in jw.requests]
    jt = jcompile_workload(jc, jw, algo)
    tt = compile_workload(tc, tw, algo, device="cpu")
    for f in ("n", "m", "kind", "params", "ports", "num_nodes", "num_links"):
        assert getattr(tt, f) == getattr(jt, f), f
    for f in ("link", "vcls", "node", "deliver", "dslot", "enqueue", "parent",
              "release_stage", "lane", "lane_seq", "chl", "watch_link"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                      err_msg=f)
    assert tt.link[tt.valid].max() < tt.num_links


@pytest.mark.parametrize("case", CASES, ids=CIDS)
def test_xsimulate_matches_reference(case):
    """``xsimulate(device="cpu")`` against the reference's ``ref`` backend
    on every plane and counter, and against the port's host sim's delivery
    sets and flit count."""
    _, kw, rate, cycles, seed, algo = case
    kw = dict(kw, warmup=0, drain_grace=GRACE)
    jc, tc = jnoc.NoCConfig(**kw), tnoc.NoCConfig(**kw)
    jw = jnoc.synthetic_workload(jc, rate, cycles, seed=seed)
    tw = tnoc.synthetic_workload(tc, rate, cycles, seed=seed)
    jr = jnoc.xsimulate(jc, [jw], (algo,), backend="ref")
    tr = tnoc.xsimulate(tc, [tw], (algo,), device="cpu")
    for f in ("ctr", "dtime", "crel", "lutil", "rconf"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f),
                                      err_msg=f)
    assert tr.latencies(0, 0) == jr.latencies(0, 0)
    assert tr.delivered_sets(0, 0) == jr.delivered_sets(0, 0)
    assert tr.stats(0, 0).flit_link_traversals == \
        jr.stats(0, 0).flit_link_traversals
    assert tr.all_drained(0, 0)
    sim = tnoc.WormholeSim(tc, measure_window=(0, tw.horizon))
    sim.add_requests(algo, tw.requests, device="cpu")
    st = sim.run(tw.horizon + GRACE, drain=True)
    assert st.packets_finished == st.packets_created
    g = tc.make_topology()
    assert tr.delivered_sets(0, 0) == {
        p.pid: {g.idx(c) for c in p.delivery_times} for p in sim.packets}
    assert tr.stats(0, 0).flit_link_traversals == st.flit_link_traversals
    np.testing.assert_array_equal(tr.link_utilization(0, 0),
                                  st.telemetry.link_flits)


def test_xsim_heatmap_shape_tracks_ports():
    kw = dict(n=3, m=3, topology="mesh3d", topology_params=(3,),
              dest_range=(2, 4), warmup=0, drain_grace=GRACE)
    cfg = tnoc.NoCConfig(**kw)
    wl = tnoc.synthetic_workload(cfg, 0.02, 60, seed=0)
    res = tnoc.xsimulate(cfg, [wl], ("DPM",), device="cpu")
    hm = res.link_heatmap(0, 0)
    assert hm.shape == (9, 3, 6)  # rows = m * d, six ports in 3-D
    assert hm.sum() == res.stats(0, 0).flit_link_traversals
    jc = jnoc.NoCConfig(**kw)
    jr = jnoc.xsimulate(jc, [jnoc.synthetic_workload(jc, 0.02, 60, seed=0)],
                        ("DPM",), backend="ref")
    np.testing.assert_array_equal(hm, jr.link_heatmap(0, 0))


# ------------------------------------------------------------- telemetry
@pytest.mark.parametrize("kw", [
    dict(n=3, m=3, topology="mesh3d", topology_params=(3,),
         dest_range=(2, 4)),
    dict(n=8, m=8, topology="chiplet", topology_params=(2, 2),
         dest_range=(2, 4)),
], ids=["mesh3d", "chiplet"])
def test_telemetry_conservation_matches_reference(kw):
    """The host sim's counters on six ports (and a chiplet's sparse links):
    every ``SimStats`` field and ``Telemetry`` array the reference's, the
    structured views equal to the flat counters, link ids round-tripping."""
    runs = []
    for noc in (jnoc, tnoc):
        cfg = noc.NoCConfig(**kw)
        wl = noc.synthetic_workload(cfg, 0.03, 120, seed=7)
        sim = noc.WormholeSim(cfg, measure_window=(0, wl.horizon))
        for r in wl.requests:
            sim.add_request("DPM", r.src, r.dests, r.time)
        runs.append((cfg, sim.run(wl.horizon + GRACE, drain=True)))
    (_, jst), (cfg, st) = runs
    assert_same_stats(st, jst)
    tel = st.telemetry
    g = cfg.make_topology()
    assert tel.link_flits.shape == (g.num_nodes * g.ports,)
    assert int(tel.link_flits.sum()) == st.flit_link_traversals
    assert np.array_equal(tel.heatmap(g).reshape(-1), tel.link_flits)
    for lid in np.flatnonzero(tel.link_flits):
        u, v = tnoc.link_coords(g, int(lid))
        assert v in g.neighbors(*u)
        assert tnoc.link_index(g, u, v) == int(lid)


@pytest.mark.parametrize("row", range(3),
                         ids=[p["case"] for p in ARTIFACT["parity"]])
def test_parity_rows_reproduce_the_artifact(row):
    """``topo3d_sweep.json``'s ``parity`` rows (80 cycles, DPM): the host
    sim and xsim deliver the same sets, both drain, and their latencies are
    the committed ones."""
    want = ARTIFACT["parity"][row]
    kw = [
        dict(n=3, m=3, topology="mesh3d", topology_params=(3,),
             dest_range=(2, 5)),
        dict(n=3, m=3, topology="mesh3d", topology_params=(3, 2.0),
             dest_range=(2, 5)),
        dict(n=8, m=8, topology="chiplet", topology_params=(2, 2),
             dest_range=(2, 5)),
    ][row]
    rate = 0.02 if kw["topology"] == "chiplet" else 0.03
    cfg = tnoc.NoCConfig(warmup=0, drain_grace=1200, **kw)
    wl = tnoc.synthetic_workload(cfg, rate, 80, seed=3)
    res = tnoc.xsimulate(cfg, [wl], (want["algo"],), device="cpu")
    g = cfg.make_topology()
    sim = tnoc.WormholeSim(cfg, measure_window=(0, wl.horizon))
    for r in wl.requests:
        sim.add_plan(tcore.plan(want["algo"], g, r.src, r.dests), r.time)
    pst = sim.run(wl.horizon + cfg.drain_grace)
    psets = {pk.pid: {g.idx(c) for c in pk.delivery_times}
             for pk in sim.packets}
    assert (psets == res.delivered_sets(0, 0)) == want["delivery_sets_equal"]
    assert (res.all_drained(0, 0)
            and pst.packets_finished == pst.packets_created) == want["drained"]
    assert round(pst.avg_latency, 3) == want["latency_host"]
    assert round(float(res.avg_latency(0, 0)), 3) == want["latency_xsim"]
