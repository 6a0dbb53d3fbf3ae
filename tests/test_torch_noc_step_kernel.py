"""The CUDA segmented-min kernels themselves, run on host threads.

``src/repro_torch/kernels/noc_step/csrc/noc_step.cu`` is compiled as C++
with ``g++`` against the stand-ins of ``tests/cuda_host`` (each CUDA thread
a host thread; a cooperative launch's blocks run together, their shared
memory one buffer each, the grid barrier a barrier of all their threads;
the card has 2 SMs of one resident block each, so each block of the grid
route takes many groups) and launched through its own launch functions.
Both routes run: ``grid`` (a fill, then blocks that gather their chunk's
minima in shared memory when its resources span few ids, else go to the
output through a cache of their last updates), also with the winner test
of ``arbitrate`` fused in, and ``atomic`` (a fill and a pass). Outputs are held
bit for bit against the JAX package's Pallas kernel in interpret mode, its
jnp oracle and its ``arbitrate`` (``pallas_interpret`` and ``ref``
backends).

Cases: tests/test_kernels.py's shapes, padded segments (-1 and L), keys
above NOC_INF, negative keys (down to INT_MIN), no candidate at all, L not a
multiple of 8 and below 8, a hot spot (its resources
within a few ids, then spread over 100,000: the grid route's cache), resources
that share slots of that cache, arrays off
16-byte alignment (keys and segments in one phase: 16-byte loads after a
scalar head; in two phases: scalar loads; the mask off 4-byte alignment),
and admissible candidates outside [0, L) (compared with the clipped
resource's minimum).
"""
import ctypes
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.noc_step import ops as jops
from repro.kernels.noc_step.noc_step import segmented_min as j_segmented_min
from repro.kernels.noc_step.ref import segmented_min_ref as j_segmented_min_ref
from repro_torch.kernels.noc_step import (
    NOC_INF,
    VARIANTS,
    arbitrate_kernel,
    segmented_min,
)

_HOST = Path(__file__).resolve().parent / "cuda_host"
_CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
       / "noc_step" / "csrc" / "noc_step.cu")
_SHARED = {"extern __shared__ __align__(16) int s_tab[];":
               "int* s_tab = (int*)emu::smem();",
           "__shared__ SpanScratch sp;":
               "SpanScratch& sp = *(SpanScratch*)emu::static_smem();"}
INT_MIN = -2**31


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """Every route compiled with g++ against ``tests/cuda_host``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("noc_step_host")
    src = _CU.read_text()
    for decl, ptr in _SHARED.items():
        assert src.count(decl) == 1, decl
        src = src.replace(decl, ptr)
    (out / "noc_step.cu").write_text(src)
    lib = out / "libnoc_step_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC",
         "-pthread", f"-I{_HOST}",
         f'-DNOC_STEP_SOURCE="{out / "noc_step.cu"}"',
         "-o", str(lib), str(_HOST / "noc_step_host.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    so = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.segmented_min_launch.argtypes = [p, p, p, ll, i, p]
    so.segmin_grid_launch.argtypes = [p, p, p, p, p, ll, i, p]
    so.emu_enable_launches()
    return so


def _placed(a, phase):
    """``a`` copied into a buffer at ``phase`` elements past a 16-byte
    boundary."""
    per = 16 // a.itemsize
    buf = np.zeros(a.size + 2 * per, a.dtype)
    off = (-buf.ctypes.data // a.itemsize) % per + phase
    out = buf[off:off + a.size]
    out[:] = a
    assert out.ctypes.data % 16 == phase * a.itemsize
    return out


def _case(name):
    """(keys, segs, adm, L) of a named case, int32/int32/bool numpy, from
    its own seed; keys ~30% NOC_INF, the rest below 2^22, as
    tests/test_kernels.py makes them."""
    kind, N, L = CASES[name]
    rng = np.random.default_rng(N * 1009 + L)
    keys = rng.integers(0, 2**22, N).astype(np.int32)
    keys[rng.random(N) < 0.3] = NOC_INF
    segs = rng.integers(0, L, N).astype(np.int32)
    if kind == "padded":
        pad = rng.random(N) < 0.1
        segs[pad] = np.where(rng.random(int(pad.sum())) < 0.5, -1, L)
        keys[pad] = NOC_INF
    elif kind == "above":
        keys[rng.random(N) < 0.1] = NOC_INF + 7
    elif kind == "negative":
        keys[:] = rng.integers(INT_MIN, 2**22, N)
        keys[rng.random(N) < 0.3] = NOC_INF
        keys[:4] = INT_MIN
        keys[4:8] = -1
    elif kind == "collide":  # 32 resources in 2 slots of the grid's cache
        segs[:] = rng.integers(0, 16, N) * 8192 + rng.integers(0, 2, N)
    elif kind == "hotspot":
        live = keys < NOC_INF
        segs[live] = rng.choice(L, 4, replace=False)[
            rng.integers(0, 4, int(live.sum()))]
    adm = rng.random(N) < 0.6
    if kind == "padded":
        adm[segs < 0] = False
        adm[segs >= L] = False
    return keys, segs, adm, L


CASES = {
    "64x7": ("plain", 64, 7),
    "1000x256": ("plain", 1000, 256),
    "4096x64": ("plain", 4096, 64),
    "37x300": ("plain", 37, 300),
    "512x320": ("plain", 512, 320),
    "padded-512x320": ("padded", 512, 320),
    "above-inf-1000x256": ("above", 1000, 256),
    "negative-1000x61": ("negative", 1000, 61),
    "no-candidates-L1": ("plain", 0, 1),
    "ragged-1000x13": ("plain", 1000, 13),
    "below-8-300x5": ("plain", 300, 5),
    "hotspot-4096x2000": ("hotspot", 4096, 2000),
    "collide-4096x131072": ("collide", 4096, 131_072),
    "hotspot-4096x100000": ("hotspot", 4096, 100_000),
}
# too many resource tiles for the Pallas kernel in interpret mode: held
# against the jnp oracle and the reference arbitrate's jnp backend only
NO_PALLAS = {"collide-4096x131072", "hotspot-4096x100000"}
# (keys phase, segs phase, adm/win phase) in elements past 16-byte alignment
PHASES = {"aligned": (0, 0, 0), "one-phase": (1, 1, 1),
          "two-phases": (1, 2, 0), "mask-off": (3, 3, 2)}
RUNS = ([(c, "aligned") for c in CASES]
        + [("1000x256", p) for p in PHASES if p != "aligned"]
        + [("ragged-1000x13", "one-phase"), ("64x7", "two-phases")])


@lru_cache(maxsize=None)
def _segmin_want(name):
    keys, segs, _, L = _case(name)
    k, s = jnp.asarray(keys), jnp.asarray(segs)
    ref = np.asarray(j_segmented_min_ref(k, s, L))
    # the Pallas grid needs a candidate tile
    if keys.size and name not in NO_PALLAS:
        pallas = np.asarray(j_segmented_min(k, s, L, interpret=True))
        np.testing.assert_array_equal(pallas, ref)
    return ref


@lru_cache(maxsize=None)
def _arbitrate_want(name):
    keys, segs, adm, L = _case(name)
    if not keys.size:  # neither reference reduces zero candidates
        return np.zeros(0, bool), np.full(L, NOC_INF, np.int32)
    args = (jnp.asarray(adm), jnp.asarray(keys), jnp.asarray(segs), L)
    ref = np.asarray(jops.arbitrate(*args, backend="ref"))
    if name not in NO_PALLAS:
        pallas = np.asarray(jops.arbitrate(*args, backend="pallas_interpret"))
        np.testing.assert_array_equal(pallas, ref)
    mkeys = np.where(adm, keys, NOC_INF).astype(np.int32)
    seg_min = np.asarray(j_segmented_min_ref(jnp.asarray(mkeys),
                                             jnp.asarray(segs), L))
    return ref, seg_min


def _segmin(lib, route, keys, segs, L, phase=(0, 0, 0)):
    k, s = _placed(keys, phase[0]), _placed(segs, phase[1])
    out = np.full(L, -7, np.int32)
    if route == "atomic":
        rc = lib.segmented_min_launch(k.ctypes.data, s.ctypes.data,
                                      out.ctypes.data, keys.size, L, None)
    else:
        rc = lib.segmin_grid_launch(k.ctypes.data, s.ctypes.data, None,
                                    out.ctypes.data, None, keys.size, L, None)
    assert rc == 0, rc
    return out


def _arbitrate(lib, adm, keys, segs, L, phase=(0, 0, 0)):
    k, s = _placed(keys, phase[0]), _placed(segs, phase[1])
    a = _placed(adm.astype(np.uint8), phase[2])
    win = _placed(np.full(adm.size, 7, np.uint8), phase[2])
    out = np.full(L, -7, np.int32)
    rc = lib.segmin_grid_launch(k.ctypes.data, s.ctypes.data, a.ctypes.data,
                                out.ctypes.data, win.ctypes.data, keys.size,
                                L, None)
    assert rc == 0, rc
    return win.copy(), out


@pytest.mark.parametrize("route", VARIANTS)
@pytest.mark.parametrize("name,phase", RUNS, ids=[f"{c}-{p}" for c, p in RUNS])
def test_segmin_routes_on_host_threads(host_kernel, name, phase, route):
    keys, segs, _, L = _case(name)
    got = _segmin(host_kernel, route, keys, segs, L, PHASES[phase])
    np.testing.assert_array_equal(got, _segmin_want(name))


@pytest.mark.parametrize("name,phase", RUNS, ids=[f"{c}-{p}" for c, p in RUNS])
def test_fused_arbitrate_on_host_threads(host_kernel, name, phase):
    keys, segs, adm, L = _case(name)
    want, seg_min = _arbitrate_want(name)
    win, out = _arbitrate(host_kernel, adm, keys, segs, L, PHASES[phase])
    assert set(np.unique(win)) <= {0, 1}
    np.testing.assert_array_equal(win.astype(bool), want)
    np.testing.assert_array_equal(out, seg_min)


def _clip_inputs():
    """777 unique keys over 61 resources, 40% admissible, then admissible
    candidates outside [0, L): at -1 and L with the key of the clipped
    resource's winner (so they win beside it), at -3 and L + 2 with keys
    below every other (a skipped candidate must not win anywhere)."""
    rng = np.random.default_rng(9)
    N, L = 777, 61
    keys = rng.permutation(N).astype(np.int32) + 10
    segs = rng.integers(0, L, N).astype(np.int32)
    adm = rng.random(N) < 0.4
    for r in (0, L - 1):
        assert (adm & (segs == r)).any()
    m0 = keys[adm & (segs == 0)].min()
    mL = keys[adm & (segs == L - 1)].min()
    segs[:4] = [-1, L, -3, L + 2]
    keys[:4] = [m0, mL, 1, 2]
    adm[:4] = True
    return adm, keys, segs, L


def test_fused_arbitrate_clips_out_of_range_segments(host_kernel):
    adm, keys, segs, L = _clip_inputs()
    args = (jnp.asarray(adm), jnp.asarray(keys), jnp.asarray(segs), L)
    pallas = np.asarray(jops.arbitrate(*args, backend="pallas_interpret"))
    np.testing.assert_array_equal(
        pallas, np.asarray(jops.arbitrate(*args, backend="ref")))
    assert pallas[:2].all() and not pallas[2:4].any()
    win, _ = _arbitrate(host_kernel, adm, keys, segs, L)
    np.testing.assert_array_equal(win.astype(bool), pallas)


def test_grid_launch_needs_its_outputs(host_kernel):
    keys = np.zeros(4, np.int32)
    adm = np.ones(4, np.uint8)
    out = np.full(1, -7, np.int32)
    # no minima, or a mask without a winner array: refused, nothing written
    for a, o in ((None, None), (adm.ctypes.data, out.ctypes.data)):
        rc = host_kernel.segmin_grid_launch(keys.ctypes.data, keys.ctypes.data,
                                            a, o, None, 4, 1, None)
        assert rc == 1  # cudaErrorInvalidValue
    assert out[0] == -7


def test_wrappers_refuse_cpu_tensors():
    keys = torch.zeros(8, dtype=torch.int32)
    adm = torch.ones(8, dtype=torch.bool)
    for variant in VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            segmented_min(keys, keys, 4, variant=variant)
    with pytest.raises(ValueError, match="CUDA"):
        arbitrate_kernel(adm, keys, keys, 4)
    with pytest.raises(ValueError, match="unknown segmented-min route"):
        segmented_min(keys, keys, 4, variant="cluster")
