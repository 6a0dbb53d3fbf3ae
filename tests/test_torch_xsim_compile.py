"""Workload and lowering parity: ``repro_torch.noc`` traffic generators and
the xsim compiler against ``repro``'s, field by field, plus the carriers
that move compiled arrays onto a torch device."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.noc as jnoc
import repro.noc.xsim.compile as jcomp
import repro_torch.noc as tnoc
import repro_torch.noc.xsim.compile as tcomp

BROKEN = (((1, 1), (2, 1)), ((2, 2), (2, 3)))
CFGS = {
    "mesh": dict(n=4, dest_range=(2, 5), multicast_fraction=0.4),
    "torus": dict(n=4, topology="torus", dest_range=(2, 5),
                  multicast_fraction=0.4),
    "mesh-2broken": dict(n=4, dest_range=(2, 5), multicast_fraction=0.4,
                         broken_links=BROKEN),
}
ARRAY_FIELDS = [
    f.name for f in dataclasses.fields(jcomp.CompiledTraffic)
    if f.name not in ("n", "m", "kind", "params", "ports", "num_nodes",
                      "num_links", "horizon")
]


def _cfgs(name):
    return jnoc.NoCConfig(**CFGS[name]), tnoc.NoCConfig(**CFGS[name])


def _reqs(wl):
    return [(r.time, r.src, r.dests, r.flits) for r in wl.requests]


@pytest.mark.parametrize("name", ["mesh", "torus"])
@pytest.mark.parametrize("rate,seed", [(0.05, 0), (0.3, 5)])
def test_synthetic_workload_identical(name, rate, seed):
    jc, tc = _cfgs(name)
    jw = jnoc.synthetic_workload(jc, rate, 80, seed=seed)
    tw = tnoc.synthetic_workload(tc, rate, 80, seed=seed)
    assert (tw.name, tw.horizon) == (jw.name, jw.horizon)
    assert _reqs(tw) == _reqs(jw)


@pytest.mark.parametrize("bench", ["canneal", "fluidanimate"])
def test_parsec_workload_identical(bench):
    jc, tc = jnoc.NoCConfig(), tnoc.NoCConfig()
    jw = jnoc.parsec_workload(jc, bench, 120, seed=3)
    tw = tnoc.parsec_workload(tc, bench, 120, seed=3)
    assert _reqs(tw) == _reqs(jw)


@pytest.mark.parametrize("algo", ["MU", "MP", "NMP", "DPM"])
@pytest.mark.parametrize("name", list(CFGS))
def test_compile_workload_identical(name, algo):
    jc, tc = _cfgs(name)
    wl_j = jnoc.synthetic_workload(jc, 0.1, 40, seed=2)
    wl_t = tnoc.synthetic_workload(tc, 0.1, 40, seed=2)
    jt = jcomp.compile_workload(jc, wl_j, algo)
    tt = tcomp.compile_workload(tc, wl_t, algo, device="cpu")
    for f in ("n", "m", "kind", "params", "ports", "num_nodes", "num_links",
              "horizon"):
        assert getattr(tt, f) == getattr(jt, f), f
    for f in ARRAY_FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kind", ["mesh", "torus"])
@pytest.mark.parametrize("V", [1, 2])
def test_geometry_tables_identical(kind, V):
    jg = jcomp.geometry_tables(kind, 4, 4, (), V)
    tg = tcomp.geometry_tables(kind, 4, 4, (), V)
    assert jg.keys() == tg.keys()
    for k in jg:
        assert tg[k].dtype == jg[k].dtype
        np.testing.assert_array_equal(tg[k], jg[k], err_msg=k)


def test_stack_and_carry_to_torch_keep_dtypes():
    """stack_traffic pads identically; traffic_from_numpy/planes_from_numpy
    carry the reference's arrays onto a torch device with dtypes kept."""
    jc, tc = _cfgs("torus")
    wls = [tnoc.synthetic_workload(tc, r, 30, seed=1) for r in (0.05, 0.2)]
    jwls = [jnoc.synthetic_workload(jc, r, 30, seed=1) for r in (0.05, 0.2)]
    _, js = jcomp.stack_traffic(
        [jcomp.compile_workload(jc, w, a) for w in jwls for a in ("MU", "DPM")]
    )
    _, ts = tcomp.stack_traffic(
        [tcomp.compile_workload(tc, w, a, device="cpu") for w in wls
         for a in ("MU", "DPM")]
    )
    assert js.keys() == ts.keys()
    tr = tcomp.traffic_from_numpy(js, "cpu")
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        assert tr[k].device.type == "cpu"
        assert tr[k].numpy().dtype == js[k].dtype, k
        np.testing.assert_array_equal(tr[k].numpy(), js[k])
    from repro.kernels.noc_cycle.ref import init_planes as jinit

    jp = jinit(64, 4, 16, 3, 2)
    tp = tcomp.planes_from_numpy(
        [np.asarray(p)[None] for p in jp], "cpu"
    )
    for name, a, b in zip(jp._fields, jp, tp):
        assert b.shape == (1,) + np.asarray(a).shape, name
        assert b.numpy().dtype == np.asarray(a).dtype, name
        assert torch.equal(b[0], torch.from_numpy(np.array(a))), name
