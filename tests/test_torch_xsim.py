"""The port's batched xsim on the CPU against ``repro``'s, end to end:
plan, lower, run the engine and read the results, bit for bit."""
import numpy as np
import pytest

import repro.noc as jnoc
import repro_torch.noc as tnoc

CFG = dict(n=4, dest_range=(2, 5), multicast_fraction=0.3, warmup=20,
           drain_grace=200)
RATES = (0.04, 0.15)
ALGOS = ("MU", "DPM")


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_xsimulate_matches_reference(topology):
    jc = jnoc.NoCConfig(topology=topology, **CFG)
    tc = tnoc.NoCConfig(topology=topology, **CFG)
    jw = [jnoc.synthetic_workload(jc, r, 80, seed=9) for r in RATES]
    tw = [tnoc.synthetic_workload(tc, r, 80, seed=9) for r in RATES]
    jr = jnoc.xsimulate(jc, jw, ALGOS, backend="ref")
    tr = tnoc.xsimulate(tc, tw, ALGOS, device="cpu")
    assert tr.algos == jr.algos and tr.cycles == jr.cycles
    assert tr.device == "cpu" and tr.device_s > 0
    np.testing.assert_array_equal(tr.ctr, jr.ctr)
    np.testing.assert_array_equal(tr.dtime, jr.dtime)
    np.testing.assert_array_equal(tr.crel, jr.crel)
    np.testing.assert_array_equal(tr.lutil, jr.lutil)
    np.testing.assert_array_equal(tr.rconf, jr.rconf)
    for w in range(len(RATES)):
        for a in range(len(ALGOS)):
            assert tr.latencies(w, a) == jr.latencies(w, a)
            assert tr.delivered_sets(w, a) == jr.delivered_sets(w, a)
            ts, js = tr.stats(w, a), jr.stats(w, a)
            for f in ("latencies", "flit_link_traversals", "buffer_writes",
                      "buffer_reads", "xbar_traversals", "arbitrations",
                      "ni_flits", "cycles", "packets_created",
                      "packets_finished"):
                assert getattr(ts, f) == getattr(js, f), f
            assert ts.dyn_energy_pj(tc.energy) == js.dyn_energy_pj(jc.energy)
            assert tr.all_drained(w, a) == jr.all_drained(w, a)
    assert all(tr.all_drained(0, a) for a in range(len(ALGOS)))


def test_latency_vs_rate_batched_matches_reference():
    kw = dict(n=4, topology="torus", dest_range=(2, 4), warmup=10,
              drain_grace=150)
    jcurves, _ = jnoc.latency_vs_rate_batched(
        jnoc.NoCConfig(**kw), [0.03, 0.1], ("MP", "NMP"), cycles=60, seed=2,
        backend="ref",
    )
    tcurves, res = tnoc.latency_vs_rate_batched(
        tnoc.NoCConfig(**kw), [0.03, 0.1], ("MP", "NMP"), cycles=60, seed=2,
        device="cpu",
    )
    assert tcurves == jcurves
    assert res.compile_s > 0 and res.wall_s >= res.compile_s
