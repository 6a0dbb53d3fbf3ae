"""The CUDA cost-table kernels themselves, run on host threads.

``src/repro_torch/kernels/dpm_cost/csrc/dpm_cost.cu`` is compiled as C++
with ``g++`` against the stand-ins of ``tests/cuda_host`` (each CUDA thread
a host thread; warp ballots and shuffles meet at a barrier of the warp's 32
threads; ``__syncthreads`` is a block barrier) and launched through its own
launch functions. Both routes run: the warp route (one warp per packet
over its destinations, the default) and the block route (one block per
packet over all its nodes). Their outputs are held bit for bit against the
JAX package's Pallas kernels in interpret mode; the weighted table under
the non-dyadic ``energy`` prices within rtol 1e-6 (the reference sums in
another order). Every batch has 13 packets (two blocks of the warp route,
the second partial): one lists its own source, one has no destination,
one is fully dense. The fabrics cover rows of 15 nodes (4-byte loads),
rows of 32, 144 and 256 nodes (16-byte loads: one, two partial and two
full turns of 128 nodes), and rows of 32 and 144 nodes that are not
16-byte aligned (4-byte loads, one and five turns of 32 nodes). A dense
packet of 16x16 spans 8 chunks of 32 destinations.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro.kernels.dpm_cost import dpm_cost as jkern

ENERGY_RTOL = 1e-6
P = 13

_HOST = Path(__file__).resolve().parent / "cuda_host"
_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "dpm_cost" / "csrc" / "dpm_cost.cu")
# the kernels' shared arrays, as pointers into the block's host buffer
_SHARED = {
    "extern __shared__ __align__(16) unsigned char s_warps[];":
        "unsigned char* s_warps = emu::smem();",
    "extern __shared__ signed char s_w[];":
        "signed char* s_w = (signed char*)emu::smem();",
    "__shared__ Shared sh;": "Shared& sh = *(Shared*)emu::static_smem();",
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """Both routes of both tables compiled with g++ against
    ``tests/cuda_host``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("dpm_cost_host")
    src = _CU.read_text()
    for decl, ptr in _SHARED.items():
        assert src.count(decl) == 2, decl
        src = src.replace(decl, ptr)
    (out / "dpm_cost.cu").write_text(src)
    lib = out / "libdpm_cost_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
         "-shared", "-fPIC", "-pthread", f"-I{_HOST}",
         f'-DDPM_COST_SOURCE="{out / "dpm_cost.cu"}"',
         "-o", str(lib), str(_HOST / "dpm_cost_host.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.emu_cost_table.argtypes = [p] * 4 + [i] * 6
    so.emu_cost_table_weighted.argtypes = [p] * 6 + [i] * 5 + [
        ctypes.c_float, i]
    return so


def _packets(n, m, seed):
    """(mask (P, NN) int32, src_xy (P, 2) int32): random destination sets;
    packet 0 lists its own source, packet 1 has none, packet 2 lists every
    node."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((P, n * m)) < 0.3).astype(np.int32)
    sxy = np.stack([rng.integers(0, n, P), rng.integers(0, m, P)], 1)
    sxy = sxy.astype(np.int32)
    mask[0, sxy[0, 1] * n + sxy[0, 0]] = 1
    mask[1] = 0
    mask[2] = 1
    return mask, sxy


def _rows(mask, aligned):
    """``mask`` in a buffer whose rows start 16-byte aligned, or 4 bytes
    past an aligned address."""
    buf = np.zeros(mask.size + 8, np.int32)
    off = (-buf.ctypes.data // 4) % 4 + (0 if aligned else 1)
    rows = buf[off:off + mask.size].reshape(mask.shape)
    rows[:] = mask
    return rows


def _runs(n, m, unaligned):
    """(route, aligned rows, expected 16-byte loads) of one case: the warp
    route on aligned rows (and on unaligned ones), the block route."""
    vec = (n * m) % 4 == 0
    runs = [("warp", True, vec)]
    if unaligned:
        runs.append(("warp", False, False))
    return runs + [("block", True, vec)]


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("kind,n,m,leg,unaligned", [
    ("mesh", 5, 3, True, False),
    ("torus", 8, 4, False, True),
    ("mesh", 16, 16, False, False),
    ("torus", 12, 12, True, False),
])
def test_cost_table_kernels_on_host_threads(host_kernel, kind, n, m, leg,
                                            unaligned):
    mask, sxy = _packets(n, m, seed=n * m + leg)
    wrap = kind == "torus"
    jc, jr = jkern.dpm_cost_table(
        jnp.asarray(mask), jnp.asarray(sxy), n=n, m=m, wrap=wrap,
        include_source_leg=leg, tile=16, interpret=True)
    for route, aligned, vec in _runs(n, m, unaligned):
        rows = _rows(mask, aligned)
        costs = np.full((P, 24), -7, np.int32)
        reps = np.full((P, 24), -7, np.int32)
        got_vec = host_kernel.emu_cost_table(
            rows.ctypes.data, sxy.ctypes.data, costs.ctypes.data,
            reps.ctypes.data, P, n, m, int(wrap), int(leg),
            int(route == "block"))
        what = f"{route} aligned={aligned}"
        assert got_vec == vec, what
        _eq(costs, jc, f"costs {what}")
        _eq(reps, jr, f"reps {what}")
    assert (reps[1] == -1).all() and (costs[1] == 0).all()  # no destinations


def _route_tensors(kind, n, m, model):
    make = {"mesh": jcore.grid, "torus": jcore.torus}[kind]
    dist, w, oh = jcore.route_cost_matrices(make(n, m),
                                            jcore.get_cost_model(model))
    return (np.ascontiguousarray(dist, np.float32),
            np.ascontiguousarray(w, np.float32), oh)


@pytest.mark.parametrize("kind,n,m,model,leg,unaligned", [
    ("torus", 5, 3, "weighted", False, False),
    ("mesh", 8, 4, "hops", True, True),
    ("mesh", 16, 16, "energy", True, False),
    ("torus", 12, 12, "energy", False, True),
])
def test_weighted_table_kernels_on_host_threads(host_kernel, kind, n, m,
                                                model, leg, unaligned):
    mask, sxy = _packets(n, m, seed=n + m + leg)
    wrap = kind == "torus"
    dist, w, oh = _route_tensors(kind, n, m, model)
    jc, jr = jkern.dpm_cost_table_weighted(
        jnp.asarray(mask), jnp.asarray(sxy), jnp.asarray(dist),
        jnp.asarray(w), n=n, m=m, wrap=wrap, overhead=oh,
        include_source_leg=leg, tile=16, interpret=True)
    for route, aligned, vec in _runs(n, m, unaligned):
        rows = _rows(mask, aligned)
        costs = np.full((P, 24), -7, np.float32)
        reps = np.full((P, 24), -7, np.int32)
        got_vec = host_kernel.emu_cost_table_weighted(
            rows.ctypes.data, sxy.ctypes.data, dist.ctypes.data,
            w.ctypes.data, costs.ctypes.data, reps.ctypes.data, P, n, m,
            int(wrap), int(leg), float(oh), int(route == "block"))
        what = f"{route} aligned={aligned}"
        assert got_vec == vec, what
        _eq(reps, jr, f"reps {what}")
        if model == "energy":
            np.testing.assert_allclose(costs, np.asarray(jc), rtol=ENERGY_RTOL,
                                       atol=0, err_msg=what)
        else:
            _eq(costs, jc, f"costs {what}")
    assert (reps[1] == -1).all() and (costs[1] == 0).all()
