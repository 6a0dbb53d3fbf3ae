"""The port's plain wormhole cycle against ``repro``'s, bit for bit.

* ``cycle_core``: every plane after each cycle of a compiled 4x4 DPM run,
  mesh and torus (the port's batch axis carries one instance);
* ``run_cycles``: the port's CPU path against the reference's ``ref``
  backend on JAX-compiled traffic carried over with ``traffic_from_numpy``;
* one small case against the reference's ``pallas_interpret`` backend, the
  Pallas kernel run on the CPU;
* the credit-limited path (buffers shallower than the longest worm) with
  per-packet worm lengths that differ from the configured one.

Everything is integer arithmetic: the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.noc as jnoc
from repro.kernels.noc_cycle import ref as jref
from repro.noc.xsim.compile import (
    compile_workload,
    geometry_tables,
    stack_traffic,
)
from repro.noc.xsim.run import _run_batch
from repro_torch.kernels.noc_cycle import (
    KERNEL,
    cycle_core,
    geometry_tensors,
    init_planes,
    run_cycles,
    run_cycles_cuda,
)
from repro_torch.noc.xsim.compile import traffic_from_numpy

CYCLES = 100


def _compiled(topology, algos=("DPM",), rates=(0.12,), cycles=40, seed=4,
              buffer_depth=4, flits=None):
    """Compile with the reference; ``flits`` maps request index -> worm
    length (None keeps ``cfg.flits_per_packet``)."""
    cfg = jnoc.NoCConfig(n=4, topology=topology, dest_range=(2, 6),
                         multicast_fraction=0.4, buffer_depth=buffer_depth)
    wls = [jnoc.synthetic_workload(cfg, r, cycles, seed=seed) for r in rates]
    if flits is not None:
        for w in wls:
            for i, r in enumerate(w.requests):
                r.flits = flits(i)
    ref, stacked = stack_traffic(
        [compile_workload(cfg, w, a) for w in wls for a in algos]
    )
    return cfg, ref, stacked


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_cycle_core_matches_reference_every_cycle(topology):
    cfg, ref, stacked = _compiled(topology)
    L, NN, V = ref.num_links, ref.num_nodes, cfg.vcs_per_class
    W = 2 * V
    C = stacked["child_parent"].shape[1]
    params = dict(F=cfg.flits_per_packet, V=V, BD=cfg.buffer_depth, L=L,
                  NN=NN, EPL=16)
    geom = geometry_tables(ref.kind, ref.n, ref.m, ref.params, V)
    jtb = {f: jnp.asarray(stacked[f][0]) for f in jref.TABLE_FIELDS}
    jstep = jax.jit(
        lambda st, t: jref.cycle_core(st, jtb, t, geom, **params)
    )
    ttb = traffic_from_numpy(
        {f: stacked[f] for f in jref.TABLE_FIELDS}, "cpu"
    )
    tgeom = geometry_tensors(geom, "cpu")
    E = -(-CYCLES // 16)
    jst = jref.init_planes(L, W, NN, C, E)
    tst = init_planes(1, L, W, NN, C, E, device="cpu")
    moved = 0
    for t in range(CYCLES):
        jst, jev = jstep(jst, jnp.int32(t))
        tst, tev = cycle_core(tst, ttb, t, tgeom, **params)
        for name, a, b in zip(jst._fields, jst, tst):
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(
                b.numpy()[0], a, err_msg=f"{name} after cycle {t}"
            )
        for a, b in zip(jev, tev):
            np.testing.assert_array_equal(b.numpy()[0], np.asarray(a))
        moved += int(np.asarray(jev[0]).sum())
    assert moved > 0  # the run carried traffic


def _engine_kw(cfg, ref, stacked, drain):
    return dict(
        T=int(stacked["enqueue"][stacked["valid"]].max()) + 1 + drain,
        F=max(cfg.flits_per_packet, int(stacked["flits"].max())), V=cfg.vcs_per_class, BD=cfg.buffer_depth,
        L=ref.num_links, NN=ref.num_nodes, ND=int(stacked["dslot"].max()) + 1,
    )


def _reference(stacked, ref, kw, backend, epoch_len):
    out = _run_batch(
        {k: jnp.asarray(v) for k, v in stacked.items()},
        kind=ref.kind, n=ref.n, m=ref.m, params=ref.params, backend=backend,
        epoch_len=epoch_len, **kw,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_outputs_equal(port, want):
    for k in ("dtime", "ctr", "crel", "lutil", "rconf"):
        got = port[k].numpy()
        assert got.dtype == want[k].dtype, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)


def _mixed_flits(i):
    return 1 + i % 6


@pytest.mark.parametrize("topology,buffer_depth,flits", [
    ("mesh", 4, None),
    ("torus", 4, None),
    # buffers of 2 flits under worms of 1 to 6 flits: admission is bounded
    # by FIFO credit (``fcount < BD``), not by the BD >= F shortcut
    ("mesh", 2, _mixed_flits),
    ("torus", 2, _mixed_flits),
], ids=["mesh", "torus", "mesh-bd2-flits1to6", "torus-bd2-flits1to6"])
def test_run_cycles_matches_reference_backend(topology, buffer_depth, flits):
    cfg, ref, stacked = _compiled(topology, algos=("MU", "DPM", "MP"),
                                  rates=(0.05, 0.2),
                                  buffer_depth=buffer_depth, flits=flits)
    kw = _engine_kw(cfg, ref, stacked, drain=200 if flits else 150)
    if flits is not None:
        assert kw["BD"] < kw["F"]
        assert len(np.unique(stacked["flits"][stacked["valid"]])) == 6
    want = _reference(stacked, ref, kw, "ref", epoch_len=32)
    geom = geometry_tables(ref.kind, ref.n, ref.m, ref.params, kw["V"])
    port = run_cycles(traffic_from_numpy(stacked, "cpu"), geom,
                      epoch_len=32, **kw)
    _assert_outputs_equal(port, want)
    assert int(want["ctr"][:, 0].sum()) > 0


def test_run_cycles_matches_pallas_interpret():
    cfg, ref, stacked = _compiled("mesh", rates=(0.05,), cycles=30, seed=1)
    kw = _engine_kw(cfg, ref, stacked, drain=60)
    want = _reference(stacked, ref, kw, "pallas_interpret", epoch_len=None)
    geom = geometry_tables(ref.kind, ref.n, ref.m, ref.params, kw["V"])
    port = run_cycles(traffic_from_numpy(stacked, "cpu"), geom, **kw)
    _assert_outputs_equal(port, want)


def test_kernel_wrapper_never_falls_back_to_the_plain_version():
    """The CUDA wrapper refuses CPU tensors instead of running the plain
    cycle, and importing the package built nothing."""
    cfg, ref, stacked = _compiled("mesh", rates=(0.05,), cycles=10)
    kw = _engine_kw(cfg, ref, stacked, drain=10)
    tr = traffic_from_numpy(stacked, "cpu")
    geom = geometry_tensors(
        geometry_tables(ref.kind, ref.n, ref.m, ref.params, kw["V"]), "cpu"
    )
    launches = KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        run_cycles_cuda(
            {k: v for k, v in tr.items() if k != "dslot"}, tr["dslot"], geom,
            EPL=kw["T"], E=1, **kw,
        )
    assert KERNEL.launches == launches
    assert KERNEL._lib is None
    with pytest.raises(ValueError, match="no cycle engine"):
        run_cycles({k: v.to("meta") for k, v in tr.items()},
                   geometry_tables(ref.kind, ref.n, ref.m, ref.params, 2),
                   **kw)
