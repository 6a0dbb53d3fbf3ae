"""The port's plain wormhole cycle against ``repro``'s, bit for bit.

* ``cycle_core``: every plane after each cycle of a compiled 4x4 DPM run,
  mesh and torus (the port's batch axis carries one instance);
* ``run_cycles``: the port's CPU path against the reference's ``ref``
  backend on JAX-compiled traffic carried over with ``traffic_from_numpy``;
* one small case against the reference's ``pallas_interpret`` backend, the
  Pallas kernel run on the CPU;
* the credit-limited path (buffers shallower than the longest worm) with
  per-packet worm lengths that differ from the configured one;
* the CUDA cluster kernel's per-rank layout (bands of routers, their FIFOs,
  lanes, output links and children; which ranks read which; shared memory
  per rank against the 227 KB a block may hold) and its route choice, at
  the repo's grids, 2-D, 3-D (six ports) and chiplet packages;
* the cluster kernel itself, compiled as C++ with ``g++`` and run with each
  CTA thread as a host thread (``tests/cuda_host``), against the reference's
  outputs and the plain cycle's final planes.

Everything is integer arithmetic: the tolerance is exact equality.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    TABLE_FIELDS,
    VARIANTS,
    cycle_core,
    geometry_tensors,
    init_planes,
    run_cycles,
    run_cycles_cuda,
    run_cycles_ref,
)
from repro_torch.kernels.noc_cycle import noc_cycle as nc
from repro_torch.core import make_topology as tmake_topology
from repro_torch.noc.xsim.compile import geometry_tables as tgeometry_tables
from repro_torch.noc.xsim.compile import traffic_from_numpy

CYCLES = 100
# (kind, n, topology_params) of each compiled fabric: the 2-D ones 4x4, the
# 3-D ones with six ports, a chiplet package of 2x2 dies of 4x4 routers
FABRICS = {
    "mesh": ("mesh", 4, ()),
    "torus": ("torus", 4, ()),
    "mesh3d": ("mesh3d", 4, (4,)),
    "torus3d": ("torus3d", 3, (3,)),
    "chiplet": ("chiplet", 8, (2, 2)),
}


def _compiled(topology, algos=("DPM",), rates=(0.12,), cycles=40, seed=4,
              buffer_depth=4, flits=None):
    """Compile with the reference; ``flits`` maps request index -> worm
    length (None keeps ``cfg.flits_per_packet``)."""
    kind, n, params = FABRICS[topology]
    cfg = jnoc.NoCConfig(n=n, topology=kind, topology_params=params,
                         dest_range=(2, 6), multicast_fraction=0.4,
                         buffer_depth=buffer_depth)
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
    launches, variants = KERNEL.launches, dict(KERNEL.variants)
    for variant in (None, *VARIANTS):
        with pytest.raises(ValueError, match="CUDA"):
            run_cycles_cuda(
                {k: v for k, v in tr.items() if k != "dslot"}, tr["dslot"],
                geom, EPL=kw["T"], E=1, variant=variant, **kw,
            )
    with pytest.raises(ValueError, match="CUDA kernel route"):
        run_cycles(tr, geometry_tables(ref.kind, ref.n, ref.m, ref.params, 2),
                   variant="block", **kw)
    assert KERNEL.launches == launches and KERNEL.variants == variants
    assert KERNEL._lib is None
    with pytest.raises(ValueError, match="no cycle engine"):
        run_cycles({k: v.to("meta") for k, v in tr.items()},
                   geometry_tables(ref.kind, ref.n, ref.m, ref.params, 2),
                   **kw)


# ------------------------------------------------------------ cluster kernel
# (kind, side, topology params, VCs per class): the repo's grids, mesh and
# torus, the 3-D fabrics (six ports) and chiplet packages (four ports, the
# absent interposer links ghost links)
LAYOUT_GRIDS = [(k, n, (), 2) for k in ("mesh", "torus")
                for n in (4, 8, 16, 32)]
LAYOUT_GRIDS += [("mesh", 8, (), 1), ("torus", 8, (), 1)]
LAYOUT_GRIDS += [(k, n, (d,), 2) for k in ("mesh3d", "torus3d")
                 for n, d in ((3, 3), (4, 4), (8, 8))]
LAYOUT_GRIDS += [("mesh3d", 8, (4,), 2), ("torus3d", 8, (8,), 1),
                 ("chiplet", 8, (2, 2), 2), ("chiplet", 16, (4, 4), 2)]
# children per rank: the chip cases, compiled on the CPU, put at most 38
# (8x8), 152 (16x16) and 236 (32x32) children of one instance on one rank;
# the bound is 2.5 times that, keyed here by routers per fabric; a 3-D or
# chiplet fabric takes the bound of the next 2-D grid at least as large.
CHILDREN_BOUND = {16: 100, 64: 100, 256: 400, 1024: 600}
# the cluster size each fabric's bands take: 8 ranks where that many bands
# join only neighbouring ranks, else the first smaller K that does (a 3-D
# fabric needs a whole layer a rank, or its z-links skip a band)
LAYOUT_K = {("mesh3d", 3, (3,)): 3, ("torus3d", 3, (3,)): 3,
            ("mesh3d", 4, (4,)): 4, ("torus3d", 4, (4,)): 4,
            ("mesh3d", 8, (8,)): 8, ("torus3d", 8, (8,)): 8,
            ("mesh3d", 8, (4,)): 4, ("chiplet", 8, (2, 2)): 8,
            ("chiplet", 16, (4, 4)): 8}


def _grid_id(kind, n, params, V):
    if kind == "chiplet":
        return f"{kind}{n}x{n}-dies{params[0]}x{params[1]}-V{V}"
    return f"{kind}{'x'.join(map(str, (n, n, *params)))}-V{V}"


def _geometry(kind, n, V, params=()):
    g = tmake_topology(kind, n, n, params=params)
    geom = tgeometry_tables(kind, n, n, g.params, V)
    return geom["node_ports"], g.num_nodes, g.num_nodes * g.ports


def _worst_children(CC):
    """A ``cluster_plan`` children function whose per-rank count is ``CC``."""
    def children(layout):
        return nc.ChildLayout(None, None, None, CC, True)
    return children


def _children_bound(NN):
    return CHILDREN_BOUND[min(k for k in CHILDREN_BOUND if k >= NN)]


def _plan(kind, n, V, params=()):
    ports, NN, L = _geometry(kind, n, V, params)
    plan = nc.cluster_plan(ports, _worst_children(_children_bound(NN)),
                           NN=NN, L=L, V=V)
    return plan, ports, NN, L


@pytest.mark.parametrize("kind,n,params,V", LAYOUT_GRIDS,
                         ids=[_grid_id(*c) for c in LAYOUT_GRIDS])
def test_cluster_layout_owns_everything_once(kind, n, params, V):
    """Every router, FIFO, lane and output link has exactly one rank; a
    router's input FIFOs sit in its own rank in port order; remote reads
    and pushes join only neighbouring bands (ranks 0 and K - 1 too on a
    torus); the rank's shared memory fits 227 KB; the route is the
    cluster kernel, with 8 ranks from 8 rows up on the 2-D grids and the
    sizes of ``LAYOUT_K`` on the others."""
    plan, ports, NN, L = _plan(kind, n, V, params)
    assert plan is not None  # the route chooser takes cluster_smem
    lay = plan.layout
    K, NR, D, W = lay.K, lay.NR, L // NN, 2 * V
    want_k = LAYOUT_K[kind, n, params] if params else (8 if n >= 8 else n)
    assert K == want_k and K * NR == NN
    assert D == (6 if kind.endswith("3d") else 4)
    assert plan.smem == nc.cluster_smem_bytes(NR, D, W, _children_bound(NN))
    assert plan.smem <= 232_448 and plan.threads <= 512
    # routers and lanes: contiguous bands, one per rank
    node_rank = np.arange(NN) // NR
    assert np.array_equal(np.bincount(node_rank, minlength=K), [NR] * K)
    # links (and so FIFOs, W per link) and output links: one home each
    slots = lay.slot_link[lay.slot_link >= 0]
    assert np.array_equal(np.sort(slots), np.arange(L))
    src, home = nc.link_ranks(lay, D)
    assert np.array_equal(np.bincount(src, minlength=K), [NR * D] * K)
    for r in range(K):
        for s_, l in enumerate(lay.slot_link[r]):
            assert lay.link_home[l] == (r << 16) | s_
    # a router's input FIFOs, port by port, are its own in-slots
    LW = L * W
    for v in range(NN):
        r, vl = divmod(v, NR)
        for d in range(D):
            c = int(ports[v, d * W])
            if c < LW:
                assert lay.slot_link[r, vl * D + d] == c // W
    # remote traffic only between neighbouring bands
    gap = (home - src) % K
    if kind in ("mesh", "mesh3d", "chiplet"):
        assert np.all(np.abs(home - src) <= 1)
    else:
        assert np.all((gap <= 1) | (gap == K - 1))
        if K > 2:
            assert np.any(gap == K - 1) and np.any(gap == 1)


def test_cluster_route_needs_the_block_kernel_only_beyond_shared_memory():
    """Where 8 ranks cannot hold a band the chooser takes 16 (the
    non-portable cluster), and where no cluster can, the block kernel."""
    ports, NN, L = _geometry("mesh", 32, 2)
    plan = nc.cluster_plan(ports, _worst_children(1500), NN=NN, L=L, V=2)
    assert plan.layout.K == 16 and plan.smem <= 232_448
    assert nc.cluster_plan(ports, _worst_children(20_000), NN=NN, L=L,
                           V=2) is None


# (kind, n, params) -> (K, shared memory per CTA with no children), or None
# for the block route: the cluster sizes of the full-size 3-D and chiplet
# fabrics at V = 2
CLUSTER_K = [
    ("torus3d", 8, (8,), (8, 127_632)),
    ("mesh3d", 8, (8,), (8, 127_632)),
    ("mesh3d", 8, (4,), (4, 127_632)),  # K = 8 leaves z-links 2 ranks apart
    ("mesh3d", 4, (4,), (4, 32_016)),
    ("torus3d", 4, (4,), (4, 32_016)),
    ("chiplet", 16, (4, 4), (8, 44_944)),
    ("chiplet", 8, (2, 2), (8, 11_344)),
    # K = 4 is the first whose bands are adjacent, and needs 510,096 B
    ("torus3d", 16, (4,), None),
]


@pytest.mark.parametrize("kind,n,params,want", CLUSTER_K,
                         ids=[_grid_id(k, n, p, 2) for k, n, p, _ in CLUSTER_K])
def test_cluster_size_on_3d_and_chiplet_fabrics(kind, n, params, want):
    """The chooser's K on the six-port and chiplet fabrics: a cluster whose
    bands hold whole layers (3-D) or die rows (chiplet), and the block
    kernel where the only adjacent bands overflow shared memory."""
    ports, NN, L = _geometry(kind, n, 2, params)
    plan = nc.cluster_plan(ports, _worst_children(0), NN=NN, L=L, V=2)
    got = None if plan is None else (plan.layout.K, plan.smem)
    assert got == want
    if plan is None:
        lay = nc.band_layout(ports, NN, L, 2, 4)
        assert nc.bands_adjacent(lay, L // NN)
        assert nc.cluster_smem_bytes(lay.NR, L // NN, 4, 0) > 232_448


@pytest.mark.parametrize("n,params", [(8, (2, 2)), (16, (4, 4)),
                                      (16, (2, 4))],
                         ids=["8x8-dies2x2", "16x16-dies4x4", "16x16-dies2x4"])
def test_chiplet_ghost_links_balance_in_every_band(n, params):
    """A chiplet's absent interposer links have no router to enter: each is
    a ghost link whose FIFOs fill a free in-slot of its source's band. Every
    absence is symmetric (u -> v is missing exactly when v -> u is), so each
    band has as many free in-slots as ghost links, at every K the chooser
    tries."""
    g = tmake_topology("chiplet", n, n, params=params)
    ports, NN, L = _geometry("chiplet", n, 2, params)
    step = {(u, d): tuple(c + e for c, e in zip(u, g.dir_delta(d)))
            for u in g.nodes() for d in range(g.ports)}
    missing = {(u, d) for (u, d), v in step.items()
               if g.in_bounds(*v) and v not in g.neighbors(*u)}
    assert missing  # the package has interposer gaps
    for u, d in missing:  # directions pair up as (+x, -x), (+y, -y)
        assert (step[u, d], d ^ 1) in missing
    for K in nc.CLUSTER_SIZES:
        lay = nc.band_layout(ports, NN, L, 2, K)
        if -(-NN // -(-NN // K)) != K:
            assert lay is None  # a rank would hold no router
            continue
        assert lay is not None
        slots = lay.slot_link[lay.slot_link >= 0]
        assert np.array_equal(np.sort(slots), np.arange(L))


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_cluster_child_layout(topology):
    """Each DPM child that a lane queues or an arrival can release has one
    slot, in the rank of the router whose lane queues it; ``coff`` names
    that slot; the link a child watches is held by its own rank; children
    with no slot are the padding rows, which nothing releases or queues."""
    cfg, ref, stacked = _compiled(topology, algos=("MU", "DPM"),
                                  rates=(0.05, 0.2))
    tr = traffic_from_numpy(stacked, "cpu")
    ports, NN, L = _geometry(topology, 4, cfg.vcs_per_class)
    lay = nc.band_layout(ports, NN, L, cfg.vcs_per_class, 4)
    ch = nc.child_layout(tr["chl"], tr["watch_link"], tr["child_rs"], lay)
    chl, crow = tr["chl"].numpy(), ch.crow.numpy()
    B, C = tr["child_rs"].shape
    assert ch.CC == max(int((crow[b, r] >= 0).sum()) for b in range(B)
                        for r in range(lay.K))
    queued = 0
    for b in range(B):
        held = crow[b][crow[b] >= 0]
        assert len(held) == len(set(held.tolist()))  # one slot at most
        owner = ch.owner[b]
        for r in range(lay.K):
            rows = crow[b, r][crow[b, r] >= 0]
            assert np.all(owner[rows] == r)
            assert np.array_equal(rows, np.sort(rows))
            # slots are filled from 0
            assert np.all(crow[b, r][len(rows):] == -1)
        for v in range(NN):
            for k, row in enumerate(chl[b, v]):
                if row < 0:
                    continue
                queued += 1
                r = v // lay.NR
                assert crow[b, r, ch.coff[b, row]] == row
                wl = tr["watch_link"][b, row]
                assert lay.link_home[wl] >> 16 == r  # watched locally
        rs = tr["child_rs"][b].numpy()
        free = np.setdiff1d(np.arange(C), held)
        assert np.all((rs[free] < 0) | (rs[free] >= 32768))
        assert not np.isin(free, chl[b]).any()
        assert np.all(ch.coff[b].numpy()[free] == -1)
    assert queued > 0 and ch.local_watch


_HOST = Path(__file__).resolve().parent / "cuda_host"
_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "noc_cycle" / "csrc" / "noc_cycle.cu")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The cycle kernels compiled with g++ against ``tests/cuda_host``: the
    cluster kernel runs with one host thread per CUDA thread."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("noc_cycle_host")
    src = _CU.read_text()
    decl = "  extern __shared__ __align__(16) unsigned char noc_cl_smem[];"
    assert src.count(decl) == 1
    (out / "noc_cycle.cu").write_text(
        src.replace(decl, "  unsigned char* noc_cl_smem = emu::smem();"))
    lib = out / "libnoc_cycle_host.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{_HOST}", f'-DNOC_CYCLE_SOURCE="{out / "noc_cycle.cu"}"',
         "-o", str(lib), str(_HOST / "noc_cycle_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    so.emu_cluster_run.argtypes = [ctypes.POINTER(nc.ClArgs), ctypes.c_int]
    so.emu_cluster_run.restype = ctypes.c_long
    so.noc_cycle_cluster_smem_bytes.argtypes = [ctypes.c_int] * 4
    so.noc_cycle_cluster_smem_bytes.restype = ctypes.c_size_t
    return so


def test_cluster_smem_mirror_matches_the_kernel(host_kernel):
    """``cluster_smem_bytes`` is the kernel's own layout arithmetic."""
    for NR, D, W, CC in [(1, 4, 2, 1), (8, 4, 4, 11), (32, 4, 4, 867),
                         (128, 4, 4, 1349), (64, 4, 2, 4000), (7, 6, 4, 33)]:
        assert host_kernel.noc_cycle_cluster_smem_bytes(NR, D, W, CC) \
            == nc.cluster_smem_bytes(NR, D, W, CC)


@pytest.mark.parametrize("topology,buffer_depth,flits,epoch_len", [
    ("mesh", 4, None, None),
    ("torus", 4, None, 32),
    ("mesh", 2, _mixed_flits, 32),
    ("mesh3d", 4, None, None),
    ("torus3d", 2, _mixed_flits, 32),
    ("chiplet", 4, None, 32),
], ids=["mesh", "torus-epochs", "mesh-bd2-flits1to6", "mesh3d4x4x4",
        "torus3d3x3x3-bd2-flits1to6", "chiplet8x8-epochs"])
def test_cluster_kernel_on_host_threads(host_kernel, topology, buffer_depth,
                                        flits, epoch_len):
    """The cluster kernel's arithmetic, barriers and cross-rank reads: its
    outputs equal the reference's and its final planes the plain cycle's."""
    cfg, ref, stacked = _compiled(topology, algos=("MU", "DPM", "MP"),
                                  rates=(0.05, 0.2),
                                  buffer_depth=buffer_depth, flits=flits)
    kw = _engine_kw(cfg, ref, stacked, drain=200 if flits else 150)
    want = _reference(stacked, ref, kw, "ref", epoch_len=epoch_len)
    tr = traffic_from_numpy(stacked, "cpu")
    tb = {f: tr[f] for f in TABLE_FIELDS}
    geom = geometry_tables(ref.kind, ref.n, ref.m, ref.params, kw["V"])
    T, V, L, NN = kw["T"], kw["V"], kw["L"], kw["NN"]
    EPL = epoch_len or T
    E = -(-T // EPL)
    B, P, S = tb["link"].shape
    C, QC = tb["child_parent"].shape[1], tb["chl"].shape[2]
    plan = nc.cluster_plan(
        geom["node_ports"],
        lambda lay: nc.child_layout(tb["chl"], tb["watch_link"],
                                    tb["child_rs"], lay),
        NN=NN, L=L, V=V,
    )
    planes = init_planes(B, L, 2 * V, NN, C, E, device="cpu")
    dtime = torch.full((B, kw["ND"] + 1), -1, dtype=torch.int32)
    sizes = dict(B=B, P=P, S=S, Q=tb["lane_seq"].shape[2], QC=QC, C=C, NN=NN,
                 L=L, V=V, D=L // NN, F=kw["F"], BD=kw["BD"], E=E, EPL=EPL,
                 ND=kw["ND"], T=T)
    args, keep = nc.cluster_args(plan, planes, dict(tb, dslot=tr["dslot"]),
                                 dtime, sizes)
    # 32 threads a CTA: every strided loop of the kernel takes several turns
    assert host_kernel.emu_cluster_run(ctypes.byref(args), 32) == plan.smem
    plain, plain_dtime = run_cycles_ref(
        tb, tr["dslot"], geometry_tensors(geom, "cpu"), EPL=EPL, E=E, **kw)
    for f, got, exp in zip(planes._fields, planes, plain):
        assert torch.equal(got, exp), f
    assert torch.equal(dtime, plain_dtime)
    crel = (planes.crtime >= 0) & (planes.crtime < T)
    _assert_outputs_equal(
        {"dtime": dtime, "ctr": planes.ctr, "crel": crel,
         "lutil": planes.lutil, "rconf": planes.rconf}, want)
    assert int(want["ctr"][:, 0].sum()) > 0 and int(crel.sum()) > 0
