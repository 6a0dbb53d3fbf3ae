"""xsim's batch split over devices (``noc.xsim.run._run_sharded``, the
twin of the reference's ``pmap`` over its local devices).

- On a 4x4 mesh (B = 8 and B = 6: three workloads, two algorithms), the
  batch split over the CPU listed four times (D = 4, then D = 3) equals
  the one-launch run bit for bit: delivery times, counters, child
  releases, telemetry planes and every final state plane.
- The split count D, the largest count up to the devices' number that
  divides B, equals the reference's for B = 1..24 and 1..8 devices: the
  reference's ``_run_sharded`` runs with ``jax.local_device_count``
  patched to the count and its ``pmap`` replaced by a recorder of the
  leading dim it is handed (so no engine runs).
"""
import numpy as np
import pytest
import torch

import repro.noc.xsim.run as jrun
import repro_torch.noc as tnoc
import repro_torch.noc.xsim.run as trun
from repro_torch.noc.xsim.compile import geometry_tables, traffic_from_numpy
from repro_torch.noc.xsim.step import run_cycles

CFG = dict(n=4, dest_range=(2, 5), multicast_fraction=0.3, warmup=20,
           drain_grace=200)
KEYS = ("dtime", "ctr", "crel", "lutil", "rconf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_inputs(rates, algos):
    cfg = tnoc.NoCConfig(**CFG)
    wls = [tnoc.synthetic_workload(cfg, r, 80, seed=9) for r in rates]
    res = tnoc.xsimulate(cfg, wls, algos, device="cpu")
    st = res.traffic
    g = cfg.make_topology()
    geom = geometry_tables(g.kind, g.n, g.m or g.rows, g.params,
                           cfg.vcs_per_class)
    kw = dict(T=res.cycles, F=max(cfg.flits_per_packet,
                                  int(st["flits"].max())),
              V=cfg.vcs_per_class, BD=cfg.buffer_depth,
              L=g.num_nodes * g.ports, NN=g.num_nodes,
              ND=int(st["dslot"].max()) + 1, epoch_len=res.epoch_len)
    return traffic_from_numpy(st, "cpu"), geom, kw, res


@pytest.mark.parametrize("rates,algos,D", [
    ((0.04, 0.15), ("MU", "MP", "NMP", "DPM"), 4),
    ((0.04, 0.1, 0.15), ("MU", "DPM"), 3),
])
def test_split_over_devices_equals_one_launch(rates, algos, D):
    tr, geom, kw, res = _engine_inputs(rates, algos)
    B = tr["link"].shape[0]
    assert trun._shard_count(B, 4) == D
    one = run_cycles(tr, geom, **kw)
    split = trun._run_sharded(tr, geom, ["cpu"] * 4, **kw)
    for k in KEYS:
        assert split[k].shape[0] == B
        assert torch.equal(split[k], one[k]), k
    for f, a, b in zip(one["planes"]._fields, split["planes"],
                       one["planes"]):
        assert torch.equal(a, b), f
    np.testing.assert_array_equal(split["ctr"].numpy(), res.ctr)


def test_split_count_matches_reference(monkeypatch):
    seen = []

    class Recorded(Exception):
        pass

    def pmap(fn, **kw):
        def call(shaped):
            seen.append(next(iter(shaped.values())).shape[0])
            raise Recorded
        return call

    def run_batch(stacked, **kw):
        seen.append(1)
        raise Recorded

    monkeypatch.setattr(jrun.jax, "pmap", pmap)
    monkeypatch.setattr(jrun, "_run_batch", run_batch)
    for n in range(1, 9):
        monkeypatch.setattr(jrun.jax, "local_device_count", lambda n=n: n)
        for B in range(1, 25):
            with pytest.raises(Recorded):
                jrun._run_sharded({"link": np.zeros((B, 1), np.int32)})
            assert trun._shard_count(B, n) == seen[-1], (B, n)
