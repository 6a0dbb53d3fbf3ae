"""Batched planning parity: ``repro_torch.core.batch_planner`` against
``repro.core.batch_planner`` and against the port's own ``plan()``, on the
CPU.

Every decoded plan is compared hop for hop, delivery for delivery and parent
for parent. The arena's accounting (hits, misses, evictions, the per-(algo,
cost-model) ``by_key`` counts, dispatches) must move exactly as the
reference's on the same request sequence. Requests come from a numpy seed;
the request counts are fixed so that the JAX reference compiles
``dpm_plan_exact`` for few shapes.
"""
import functools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
import repro.core.batch_planner as jbp
import repro_torch.core as tcore
import repro_torch.core.batch_planner as tbp

CPU = dict(device="cpu")


def _fabrics(kind, n=4):
    return (
        {"mesh": jcore.grid, "torus": jcore.torus}[kind](n, n),
        {"mesh": tcore.grid, "torus": tcore.torus}[kind](n, n),
    )


def _requests(n, count, seed, kmax=8, self_dest=False):
    rng = np.random.default_rng(seed)
    nodes = [(x, y) for y in range(n) for x in range(n)]
    out, seen = [], set()
    while len(out) < count:
        src = nodes[rng.integers(len(nodes))]
        others = [d for d in nodes if d != src]
        k = int(rng.integers(1, min(kmax, len(others)) + 1))
        dests = tuple(sorted(others[i] for i in
                             rng.choice(len(others), k, replace=False)))
        if (src, dests) in seen:
            continue
        seen.add((src, dests))
        out.append((src, list(dests)))
    if self_dest:
        src, dests = out[0]
        out[0] = (src, dests + [src])
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


@pytest.mark.parametrize("kind", ["mesh", "torus"])
@pytest.mark.parametrize("algo,cm", [("DPM", "hops"), ("DPM", "weighted"),
                                     ("DPM-E", "hops"),
                                     ("DPM-E", "weighted")])
def test_bulk_plan_matches_jax_and_host_plan(kind, algo, cm):
    jg, tg = _fabrics(kind)
    reqs = _requests(4, 16, seed=sum(map(ord, kind + algo + cm)))
    jplans = jcore.bulk_plan(jg, reqs, algo, cost_model=cm)
    tplans = tcore.bulk_plan(tg, reqs, algo, cost_model=cm, **CPU)
    info = tcore.planner_for(tg, algo, cm, **CPU).info()
    assert info.batched_plans == len(reqs) and info.host_plans == 0
    for (src, dests), jp, tp in zip(reqs, jplans, tplans):
        assert _as_tuple(tp) == _as_tuple(jp)
        assert _as_tuple(tp) == _as_tuple(
            tcore.plan(algo, tg, src, dests, cost_model=cm)
        )


@pytest.mark.parametrize("kind", ["mesh", "torus"])
def test_source_listed_as_destination_matches_jax(kind):
    """A request that names its own source as a destination reaches
    ``dpm_plan_exact`` with ``part_of == -1`` under a set mask bit; both
    packages read the last wedge's column there and decode the same plan."""
    jg, tg = _fabrics(kind)
    reqs = _requests(4, 16, seed=41, self_dest=True)
    jplans = jcore.bulk_plan(jg, reqs, "DPM")
    tplans = tcore.bulk_plan(tg, reqs, "DPM", **CPU)
    for jp, tp in zip(jplans, tplans):
        assert _as_tuple(tp) == _as_tuple(jp)


def test_batch_support_reasons_match_jax():
    cases = [
        ((((0, 0), (1, 0)),), "DPM", None),  # degraded fabric
        ((), "DPM-E", None),  # energy prices are not dyadic
        ((), "MU", None),  # no device twin
        ((), "MP", None),
        ((), "DPM", "weighted"),
        ((), "DPM-E", "hops"),
    ]
    for broken, algo, cm in cases:
        jg = jcore.faulty(jcore.grid(4), broken)
        tg = tcore.faulty(tcore.grid(4), broken)
        js, ts = jcore.batch_support(jg, algo, cm), tcore.batch_support(
            tg, algo, cm
        )
        assert tuple(ts) == tuple(js), (broken, algo, cm)
    assert not tcore.batch_support(tcore.grid(4), "MU").ok


def test_host_fallbacks_match_jax():
    """Outside the gate every miss plans on the host into the same arena."""
    for broken, algo in ((((1, 1), (2, 1)),), "DPM"), ((), "MU"), ((),
                                                                   "DPM-E"):
        jg = jcore.faulty(jcore.grid(4), broken)
        tg = tcore.faulty(tcore.grid(4), broken)
        reqs = _requests(4, 6, seed=3)
        jp = jcore.BatchPlanner(jg, algo).plan_many(reqs)
        bp = tcore.BatchPlanner(tg, algo, **CPU)
        tp = bp.plan_many(reqs)
        assert [_as_tuple(p) for p in tp] == [_as_tuple(p) for p in jp]
        info = bp.info()
        assert info.host_plans == len(reqs)
        assert info.batched_plans == 0 and info.dispatches == 0


def test_arena_accounting_matches_jax():
    """Hits, misses, evictions, dedup inside one call and ``by_key`` move
    as the reference's on one request sequence."""
    jg, tg = _fabrics("mesh")
    reqs = _requests(4, 6, seed=11)
    jb = jcore.BatchPlanner(jg, "DPM", maxsize=4)
    tb = tcore.BatchPlanner(tg, "DPM", maxsize=4, **CPU)
    dests = [(1, 2), (3, 0), (2, 3)]
    seq = [
        reqs,
        [reqs[-1]],
        [reqs[0]],
        [((0, 0), dests), ((0, 0), list(reversed(dests)))],
        [((0, 0), dests + [dests[-1]])],
    ]
    for batch in seq:
        jp, tp = jb.plan_many(batch), tb.plan_many(batch)
        assert [_as_tuple(p) for p in tp] == [_as_tuple(p) for p in jp]
        assert tuple(tb.info()) == tuple(jb.info())
    a, b = tb.plan_many([((0, 0), dests), ((0, 0), list(reversed(dests)))])
    assert a is b

    reqs4 = _requests(4, 4, seed=5)
    for mod, g, kw in ((jcore, jg, {}), (tcore, tg, CPU)):
        mod.arena_clear()
        mod.bulk_plan(g, reqs4, "DPM", **kw)
        mod.bulk_plan(g, reqs4, "DPM", cost_model="weighted", **kw)
        mod.bulk_plan(g, reqs4[:2], "DPM", **kw)
    ji, ti = jcore.arena_info(), tcore.arena_info()
    assert tuple(ti) == tuple(ji)
    assert ti.by_key[("DPM", "hops")] == {"hits": 2, "misses": 4,
                                          "evictions": 0}
    tcore.arena_clear()
    assert tcore.arena_info().misses == 0 and tcore.arena_info().currsize == 0


def test_planner_for_keys_on_config_and_device():
    g = tcore.grid(4)
    assert tcore.planner_for(g, "DPM", **CPU) is tcore.planner_for(
        g, "DPM", **CPU)
    assert tcore.planner_for(g, "DPM", **CPU) is not tcore.planner_for(
        g, "DPM", "weighted", **CPU)
    assert tcore.planner_for(g, "DPM", **CPU).device.type == "cpu"
    assert tcore.bulk_plan(g, [], **CPU) == []


def test_chunked_and_padded_batches_match_jax():
    """One request pads to a batch of one; DISPATCH_CHUNK + 3 requests take
    two dispatches, the second padded to a power of two."""
    assert tbp.DISPATCH_CHUNK == jbp.DISPATCH_CHUNK
    assert tbp.MAX_ARENA_NODES == jbp.MAX_ARENA_NODES
    assert tbp.DEFAULT_ARENA_SIZE == jbp.DEFAULT_ARENA_SIZE
    jg, tg = _fabrics("mesh")
    jb, tb = jcore.BatchPlanner(jg, "DPM"), tcore.BatchPlanner(tg, "DPM",
                                                                **CPU)
    one = _requests(4, 1, seed=21)
    assert _as_tuple(tb.plan_many(one)[0]) == _as_tuple(jb.plan_many(one)[0])
    n = tbp.DISPATCH_CHUNK + 3
    reqs = _requests(4, n, seed=22, kmax=6)
    jp, tp = jb.plan_many(reqs), tb.plan_many(reqs)
    assert tb.info().dispatches == jb.info().dispatches == 3
    assert [_as_tuple(p) for p in tp] == [_as_tuple(p) for p in jp]


def test_registry_change_clears_arenas():
    g = tcore.grid(4)
    tcore.bulk_plan(g, _requests(4, 3, seed=2), **CPU)
    assert tcore.arena_info().misses == 3
    with tcore.temporary_algorithm(tcore.plan_dpm, name="DPM-tmp"):
        pass  # registration mutates the registry -> arenas must drop
    assert tcore.arena_info().misses == 0


@functools.lru_cache(maxsize=None)
def _property_planner():
    """A private planner (no registry arena, so the per-test cache clearing
    leaves it alone) whose tables are built before the first example."""
    g = tcore.grid(4)
    bp = tcore.BatchPlanner(g, "DPM", **CPU)
    bp.plan_many(_requests(4, 2, seed=0))
    return g, bp


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10**9))
def test_batched_plan_equals_host_plan_property(seed):
    """Random (src, dest-set) instances on a 4x4 mesh, one at a time
    through the arena, always equal the port's host ``plan()``."""
    g, bp = _property_planner()
    (src, dests), = _requests(4, 1, seed)
    got = bp.plan_one(src, dests)
    assert _as_tuple(got) == _as_tuple(tcore.plan("DPM", g, src, dests))
