"""Planner parity: the port's ``repro_torch.core.plan`` against ``repro``'s.

The planners are exact integer algorithms, so plans must be equal path for
path: hops, deliveries and parent links, for every registered algorithm on
meshes and tori (and one degraded fabric), over random destination sets
drawn from a numpy seed.
"""
import zlib

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore

ALGOS = ("MU", "DP", "MP", "NMP", "DPM", "DPM-E")
# (kind, n, broken links)
FABRICS = [
    ("mesh", 4, ()),
    ("mesh", 8, ()),
    ("torus", 4, ()),
    ("torus", 8, ()),
    ("mesh", 8, (((3, 3), (4, 3)), ((5, 5), (5, 6)))),
]
REQUESTS = 12


def _requests(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    nodes = [(x, y) for y in range(n) for x in range(n)]
    out = []
    for _ in range(REQUESTS):
        src = nodes[rng.integers(len(nodes))]
        k = int(rng.integers(2, min(12, len(nodes) - 1) + 1))
        others = [d for d in nodes if d != src]
        pick = rng.choice(len(others), size=k, replace=False)
        out.append((src, [others[i] for i in pick]))
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


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize(
    "fabric", FABRICS,
    ids=[f"{k}{n}x{n}" + ("-2broken" if f else "") for k, n, f in FABRICS],
)
def test_plan_matches_reference(fabric, algo):
    kind, n, faults = fabric
    jg = jcore.make_topology(kind, n, None, faults)
    tg = tcore.make_topology(kind, n, None, faults)
    assert tg.num_nodes == jg.num_nodes
    seed = zlib.crc32(f"{kind}{n}{len(faults)}".encode())
    for src, dests in _requests(n, seed):
        jp = jcore.plan(algo, jg, src, dests)
        tp = tcore.plan(algo, tg, src, dests)
        assert _as_tuple(tp) == _as_tuple(jp), (src, dests)
        assert tp.check_covers()


@pytest.mark.parametrize("kind", ["mesh", "torus"])
def test_partition_and_topology_parity(kind):
    """Definitions 1-3 and Algorithm 1 and the torus ring arithmetic."""
    jg = jcore.make_topology(kind, 8)
    tg = tcore.make_topology(kind, 8)
    for d in range(-9, 10):
        for size in (1, 2, 3, 8):
            assert tcore.ring_delta(d, size) == jcore.ring_delta(d, size)
    for src, dests in _requests(8, seed=7):
        jr = jcore.dpm_partition(jg, src, dests)
        tr = tcore.dpm_partition(tg, src, dests)
        fields = ("ids", "dests", "rep", "cost_mu", "cost_dp", "source_leg",
                  "mode")
        assert [tuple(getattr(p, f) for f in fields) for p in tr.partitions] \
            == [tuple(getattr(p, f) for f in fields) for p in jr.partitions]
        assert tr.iterations == jr.iterations
        assert tr.savings_trace == jr.savings_trace
        assert tr.total_cost() == jr.total_cost()


@pytest.mark.parametrize("cost_model", [None, "energy", "contention"])
@pytest.mark.parametrize(
    "fabric", [FABRICS[0], FABRICS[2], FABRICS[4]],
    ids=["mesh4x4", "torus4x4", "mesh8x8-2broken"],
)
def test_route_cost_matrices_match_reference(fabric, cost_model):
    kind, n, faults = fabric
    jg = jcore.make_topology(kind, n, None, faults)
    tg = tcore.make_topology(kind, n, None, faults)
    jcm = None if cost_model is None else jcore.get_cost_model(cost_model)
    tcm = None if cost_model is None else tcore.get_cost_model(cost_model)
    jd, jw, jo = jcore.route_cost_matrices(jg, jcm)
    td, tw, to = tcore.route_cost_matrices(tg, tcm)
    assert (td.dtype, tw.dtype) == (jd.dtype, jw.dtype)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tw, jw)
    assert to == jo


def test_plan_cache_info_matches_reference(monkeypatch):
    """The same plan sequence through both packages, with the cache shrunk
    so that it evicts: ``plan_cache_info()`` equal field by field, the
    per-(algorithm, cost-model) ``by_key`` breakdown included, and
    ``plan_cache_clear()`` zeroing it in both."""
    from repro.core import planner as jplanner
    from repro_torch.core import planner as tplanner

    assert tplanner.PlanCacheInfo._fields == jplanner.PlanCacheInfo._fields
    reqs = _requests(4, seed=21)[:6]
    # DPM under two cost models, cost-insensitive MU and MP, re-plans that
    # hit, and re-plans of evicted entries that miss again
    calls = (
        [("DPM", None, r) for r in reqs[:4]]
        + [("DPM", "energy", r) for r in reqs[:2]]
        + [("MU", None, r) for r in reqs[:3]]
        + [("DPM", None, reqs[3]), ("MU", None, reqs[2])]
        + [("MP", None, r) for r in reqs]
        + [("DPM", None, reqs[0]), ("DPM", "energy", reqs[1])]
    )
    infos = []
    for pkg, planner in ((jcore, jplanner), (tcore, tplanner)):
        monkeypatch.setattr(planner, "_PLAN_CACHE_MAXSIZE", 5)
        planner.plan_cache_clear()
        g = pkg.make_topology("mesh", 4)
        for algo, cm, (src, dests) in calls:
            pkg.plan(algo, g, src, dests, cost_model=cm)
        infos.append(planner.plan_cache_info())
        planner.plan_cache_clear()
        cleared = planner.plan_cache_info()
        assert (cleared.hits, cleared.misses, cleared.currsize,
                cleared.by_key) == (0, 0, 0, {})
    want, got = infos
    assert want.by_key and sum(v["evictions"] for v in want.by_key.values())
    assert any(v["hits"] for v in want.by_key.values())
    for field in jplanner.PlanCacheInfo._fields:
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("kind", ["mesh", "torus"])
def test_plan_one_through_the_arena_matches_reference(kind):
    """Lone DPM requests through each package's shared arena
    (``planner_for(...).plan_one``, a batched pass of one request): the
    same plans as each other and as the port's host ``plan()``, all of
    them planned on the batched path."""
    jg = jcore.make_topology(kind, 4)
    tg = tcore.make_topology(kind, 4)
    reqs = _requests(4, seed=zlib.crc32(f"plan_one{kind}".encode()))[:6]
    for pkg in (jcore, tcore):
        pkg.arena_clear()
    try:
        jb = jcore.planner_for(jg, "DPM")
        tb = tcore.planner_for(tg, "DPM", device="cpu")
        for src, dests in reqs:
            tp = tb.plan_one(src, dests)
            assert _as_tuple(tp) == _as_tuple(jb.plan_one(src, dests))
            assert _as_tuple(tp) == _as_tuple(tcore.plan("DPM", tg, src,
                                                         dests))
        assert jb.info().batched_plans == tb.info().batched_plans == len(reqs)
        assert jb.info().dispatches == tb.info().dispatches == len(reqs)
    finally:
        for pkg in (jcore, tcore):
            pkg.arena_clear()
