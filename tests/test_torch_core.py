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
