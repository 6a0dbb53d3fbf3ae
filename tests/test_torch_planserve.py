"""The port's plan server and its deadline batching (``repro_torch.serve``),
on the CPU: futures resolve to the plans of ``repro``'s plan server and of
the port's host ``plan()``; ``prefetch`` turns later requests into arena
hits; ``close`` drains or cancels; ``take_batch`` cuts batches as the
reference's does."""
import queue
import threading
import time

import pytest

import repro.core as jcore
import repro.serve as jserve
from repro.serve.engine import take_batch as jtake_batch
import repro_torch.core as tcore
from repro_torch.serve import PlanServer, take_batch

REQS = [((0, 0), [(3, 3), (1, 2)]), ((2, 2), [(0, 3)]),
        ((1, 3), [(0, 0), (3, 0), (2, 1), (3, 3)])]


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
def _fresh_arena():
    for mod in (jcore, tcore):
        mod.plan_cache_clear()
        mod.arena_clear()
    yield
    for mod in (jcore, tcore):
        mod.plan_cache_clear()
        mod.arena_clear()


def test_plan_server_futures_match_reference_and_host_plan():
    g = tcore.grid(4)
    with PlanServer(g, "DPM", max_wait_s=0.01, device="cpu") as ps:
        futs = [ps.submit(src, dests) for src, dests in REQS]
        plans = [f.result(timeout=60) for f in futs]
    with jserve.PlanServer(jcore.grid(4), "DPM", max_wait_s=0.01) as js:
        jplans = [js.submit(s, d).result(timeout=60) for s, d in REQS]
    for p, jp, (src, dests) in zip(plans, jplans, REQS):
        assert _as_tuple(p) == _as_tuple(jp)
        assert _as_tuple(p) == _as_tuple(tcore.plan("DPM", g, src, dests))
    assert ps.closed and ps.queue_depth == 0
    with pytest.raises(RuntimeError):
        ps.submit((0, 0), [(1, 1)])
    assert ps.stats["requests"] == len(REQS)
    assert ps.info().batched_plans == len(REQS)


def test_plan_server_prefetch_turns_requests_into_hits():
    g = tcore.grid(4)
    with PlanServer(g, "DPM", max_wait_s=0.005, device="cpu") as ps:
        ps.prefetch(REQS)
        deadline = time.monotonic() + 60
        while ps.info().misses < len(REQS) and time.monotonic() < deadline:
            time.sleep(0.01)
        before = ps.info().misses
        p = ps.plan(*REQS[0])  # arena hit: the prefetch already decoded it
    assert _as_tuple(p) == _as_tuple(tcore.plan("DPM", g, *REQS[0]))
    assert ps.info().misses == before == len(REQS)
    assert ps.info().hits >= 1


def test_plan_server_close_drains_pending_futures():
    g = tcore.grid(4)
    ps = PlanServer(g, "DPM", max_wait_s=0.001, device="cpu")
    futs = [ps.submit((0, 0), [((i % 3) + 1, 3)]) for i in range(8)]
    ps.close(drain=True)
    assert all(f.result(timeout=5) is not None for f in futs)
    assert ps.stats["requests"] == 8
    assert not ps._thread.is_alive()


def test_plan_server_close_without_drain_cancels_queued_futures():
    """The worker holds the first request inside ``plan_many`` while two
    more wait in the queue; ``close(drain=False)`` cancels those two, and
    the one in flight still resolves."""
    g = tcore.grid(4)
    inner = tcore.planner_for(g, "DPM", device="cpu")
    started, gate = threading.Event(), threading.Event()

    class HeldPlanner:
        def plan_many(self, reqs):
            started.set()
            gate.wait(30)
            return inner.plan_many(reqs)

        def info(self):
            return inner.info()

    ps = PlanServer(g, planner=HeldPlanner(), max_batch=1, max_wait_s=0.0)
    first = ps.submit(*REQS[0])
    assert started.wait(30)
    queued = [ps.submit(*r) for r in REQS[1:]]
    releaser = threading.Timer(0.2, gate.set)
    releaser.start()
    ps.close(drain=False)
    releaser.join(30)
    assert all(f.cancelled() for f in queued)
    assert _as_tuple(first.result(timeout=30)) == _as_tuple(
        tcore.plan("DPM", g, *REQS[0])
    )
    assert ps.stats["requests"] == 1 and ps.queue_depth == 0
    assert not ps._thread.is_alive()


def test_plan_server_propagates_planning_errors():
    g = tcore.grid(4)
    with PlanServer(g, "DPM", max_wait_s=0.001, device="cpu") as ps:
        bad = ps.submit((0, 0), [(9, 9)])  # off-fabric destination
        with pytest.raises(IndexError):
            bad.result(timeout=60)
        ok = ps.submit((0, 0), [(1, 1)])  # the worker keeps serving
        assert _as_tuple(ok.result(timeout=60)) == _as_tuple(
            tcore.plan("DPM", g, (0, 0), [(1, 1)])
        )


@pytest.mark.parametrize("impl", [take_batch, jtake_batch],
                         ids=["port", "reference"])
def test_take_batch_cuts_at_max_batch_then_drains(impl):
    q = queue.Queue()
    for i in range(5):
        q.put(i)
    assert impl(q, 3, 0.01) == [0, 1, 2]
    assert impl(q, 8, 0.01) == [3, 4]


def test_take_batch_waits_until_the_deadline():
    """After the first item the batch stays open for ``max_wait_s``: an item
    put within the window joins it, one put after it starts the next."""
    q = queue.Queue()
    q.put("a")
    threading.Timer(0.05, q.put, ("b",)).start()
    t0 = time.monotonic()
    assert take_batch(q, 4, 0.5) == ["a", "b"]
    assert time.monotonic() - t0 >= 0.45
    q.put("c")
    late = threading.Timer(0.3, q.put, ("d",))
    late.start()
    assert take_batch(q, 4, 0.05) == ["c"]
    late.join(5)
    assert take_batch(q, 4, 0.05) == ["d"]


def test_take_batch_stop_event_drains_then_returns_empty():
    q = queue.Queue()
    stop = threading.Event()
    stop.set()
    q.put("x")  # items queued before the stop still form a batch
    assert take_batch(q, 4, 0.01, stop=stop) == ["x"]
    assert take_batch(q, 4, 0.01, stop=stop) == []  # stopped + empty
