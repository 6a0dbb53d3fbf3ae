"""The port's SSD (``repro_torch.kernels.ssd`` and ``models.ssm``) against the
reference's Pallas intra-chunk kernel in interpret mode
(``ssd_scan_pallas``, ``ssd_intra_chunk``) and its oracles ``ssd_scan`` and
``ssd_reference``, on the reference's sweep (``test_kernels.py``'s
``SSD_SHAPES``, ragged and grouped cases included).

On the CPU ``ssd_scan_kernel`` runs the plain intra-chunk pass, the
function the CUDA kernel is held to on the card, then the same inter-chunk
recurrence. Tolerances are the reference's own (``test_kernels.py``): f32
atol 5e-4, bf16 atol 1e-1. The intra-chunk outputs are compared in f32 at
atol 5e-4 too: the cumulative sum may be taken in another order.

The bf16 tensor-core kernel's rounding (M and B (.) w to TF32 for the
tensor core) is emulated here, not in the package, and held to the JAX
oracle at the chip's bf16 tolerance; so is the bf16 rounding it replaced,
which misses that tolerance at N = 128. Each kernel instance's shared
memory is held to the 227 KB a block may use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd_scan_pallas
from repro.kernels.ssd.ssd import ssd_intra_chunk as jax_intra
from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro.models.ssm import ssd_scan as jax_ssd_scan
import repro_torch.kernels.ssd.ops as ssd_ops
from repro_torch.kernels.ssd import (
    ssd_intra_chunk,
    ssd_intra_chunk_cuda,
    ssd_scan_kernel,
)
from repro_torch.kernels.ssd.ref import MIN_LOG, pad_to_chunks
from repro_torch.kernels.ssd.ssd import (
    MAX_SMEM,
    TC_MAX_CHUNK,
    TC_SHAPES,
    smem_bytes,
)
from repro_torch.models.ssm import ssd_reference, ssd_scan

SSD_SHAPES = [
    # (B, S, H, P, G, N, chunk), as test_kernels.py
    (1, 64, 2, 8, 1, 16, 16),
    (2, 128, 4, 16, 2, 8, 32),
    (2, 96, 4, 16, 2, 8, 32),  # ragged
    (1, 256, 8, 32, 1, 64, 64),  # mamba2-like ratios
]
DTYPES = {"float32": (jnp.float32, torch.float32, 5e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-1)}


def _inputs(shape, seed):
    B, S, H, P, G, N, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    return x, dt, A, Bm, Cm


def _cast(np_in, jdt, tdt):
    """(jax arrays, torch tensors): x, dt, Bm, Cm in the dtype, A in f32."""
    j = [jnp.asarray(a, jnp.float32 if i == 2 else jdt)
         for i, a in enumerate(np_in)]
    t = [torch.from_numpy(a).to(torch.float32 if i == 2 else tdt)
         for i, a in enumerate(np_in)]
    return j, t


@pytest.fixture(scope="module")
def reference():
    """Every case through JAX once: Pallas interpret (y, h) and the naive
    recurrence (y, h)."""
    out = {}
    for i, shape in enumerate(SSD_SHAPES):
        np_in = _inputs(shape, seed=i)
        for name, (jdt, tdt, _) in DTYPES.items():
            j, _ = _cast(np_in, jdt, tdt)
            y, h = ssd_scan_pallas(*j, chunk=shape[-1], interpret=True)
            yr, hr = jax_ssd_reference(*j)
            out[shape, name] = tuple(np.asarray(a, np.float32)
                                     for a in (y, h, yr, hr))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_kernel_path_matches_pallas_and_oracle(reference, shape,
                                                        dtype):
    y_p, h_p, y_r, h_r = reference[shape, dtype]
    jdt, tdt, atol = DTYPES[dtype]
    _, t = _cast(_inputs(shape, seed=SSD_SHAPES.index(shape)), jdt, tdt)
    y, h = ssd_scan_kernel(*t, chunk=shape[-1], device="cpu")
    assert y.dtype == torch.float32 and y.shape == t[0].shape
    for got, want in ((y, y_p), (y, y_r), (h, h_p), (h, h_r)):
        np.testing.assert_allclose(got.numpy(), want, atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_plain_ssd_scan_matches_oracle(reference, shape, dtype):
    """``models.ssm.ssd_scan``, the CPU path of the SSD block."""
    _, _, y_r, h_r = reference[shape, dtype]
    jdt, tdt, atol = DTYPES[dtype]
    _, t = _cast(_inputs(shape, seed=SSD_SHAPES.index(shape)), jdt, tdt)
    y, h = ssd_scan(*t, chunk=shape[-1], return_state=True)
    np.testing.assert_allclose(y.numpy(), y_r, atol=atol)
    np.testing.assert_allclose(h.numpy(), h_r, atol=atol)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_intra_chunk_outputs_match_pallas_kernel(shape):
    """The four outputs of the intra-chunk pass against the reference
    kernel on the reference wrapper's layout (zero-padded, groups repeated,
    (B*H, nc, L, ...))."""
    B, S, H, P, G, N, L = shape
    np_in = _inputs(shape, seed=11)
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in np_in)
    pad = (-S) % L
    nc = (S + pad) // L
    pad_s = lambda a: jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    x, dt, Bm, Cm = map(pad_s, (x, dt, Bm, Cm))
    hpg = H // G
    xk = x.transpose(0, 2, 1, 3).reshape(B * H, nc, L, P)
    dtk = dt.transpose(0, 2, 1).reshape(B * H, nc, L)
    lay = lambda m: jnp.repeat(m, hpg, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, nc, L, N)
    Ak = jnp.broadcast_to(A[None, :], (B, H)).reshape(B * H, 1)
    want = jax_intra(xk, dtk, Ak, lay(Bm), lay(Cm), interpret=True)
    y, sc, dec, cum = ssd_intra_chunk(*(torch.from_numpy(a) for a in np_in),
                                      L, device="cpu")
    got = (
        y.reshape(B, nc, L, H, P).permute(0, 3, 1, 2, 4).reshape(B * H, nc, L, P),
        sc.permute(0, 2, 1, 3, 4).reshape(B * H, nc, N, P),
        dec.permute(0, 2, 1).reshape(B * H, nc),
        cum.permute(0, 3, 1, 2).reshape(B * H, nc, L),
    )
    for name, g, w in zip(("y_intra", "sc", "dec", "cum"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   err_msg=name)


def test_ssd_reference_and_initial_state_match_jax():
    """The naive recurrence and ``ssd_scan`` from a nonzero initial state."""
    shape = SSD_SHAPES[1]
    B, S, H, P, G, N, L = shape
    np_in = _inputs(shape, seed=5)
    h0 = np.random.default_rng(6).standard_normal((B, H, N, P), np.float32)
    j = [jnp.asarray(a) for a in np_in]
    t = [torch.from_numpy(a) for a in np_in]
    yr, hr = jax_ssd_reference(*j, h0=jnp.asarray(h0))
    y, h = ssd_reference(*t, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=5e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=5e-4)
    ys, hs = jax.jit(lambda *a: jax_ssd_scan(*a, chunk=L, h0=jnp.asarray(h0),
                                             return_state=True))(*j)
    y2, h2 = ssd_scan(*t, chunk=L, h0=torch.from_numpy(h0), return_state=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(ys), atol=5e-4)
    np.testing.assert_allclose(h2.numpy(), np.asarray(hs), atol=5e-4)


def test_kernel_wrapper_refuses_cpu_tensors():
    t = [torch.from_numpy(a) for a in _inputs(SSD_SHAPES[0], seed=0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_intra_chunk_cuda(*t, 16)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's rounding, emulated on the CPU
# ---------------------------------------------------------------------------
def _round_tf32(t):
    """f32 -> TF32 as ``cvt.rna.tf32.f32`` rounds: 10 mantissa bits, ties
    away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_bf16(t):
    return t.bfloat16().float()


def _tc_intra_chunk_emulation(rnd):
    """What ``ssd_intra_tc_kernel`` computes, as a drop-in for
    ``ops.ssd_intra_chunk``: C B^T from the bf16 inputs in f32 (exact
    products), M = decay * C B^T * dt_j and B (.) w formed in f32 and passed
    through ``rnd`` (the rounding for the tensor core), then M X and
    (B (.) w)^T X in f32 with X exact."""
    def intra(x, dt, A, Bm, Cm, chunk, *, device=None):
        B_, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        hpg, L = H // G, chunk
        x, dt, Bm, Cm = (pad_to_chunks(t, L) for t in (x, dt, Bm, Cm))
        nc = x.shape[1] // L
        xf = x.float().reshape(B_, nc, L, G, hpg, P)
        dtf = dt.float().reshape(B_, nc, L, H)
        Bf = Bm.float().reshape(B_, nc, L, G, N)
        Cf = Cm.float().reshape(B_, nc, L, G, N)
        cum = torch.cumsum(dtf * A.float(), dim=2)
        cb = torch.einsum("bclgn,bckgn->bcglk", Cf, Bf)
        ci = cum.permute(0, 1, 3, 2)
        tri = torch.ones((L, L), dtype=torch.bool).tril()
        m = torch.where(tri, torch.exp(torch.clamp(
            ci[..., :, None] - ci[..., None, :], min=MIN_LOG)), 0.0)
        m = m.reshape(B_, nc, G, hpg, L, L) * cb[:, :, :, None]
        m = rnd(m * dtf.permute(0, 1, 3, 2).reshape(B_, nc, G, hpg, 1, L))
        y = torch.einsum("bcgkij,bcjgkp->bcigkp", m, xf)
        w = torch.exp(torch.clamp(cum[:, :, -1:] - cum, min=MIN_LOG)) * dtf
        w = w.reshape(B_, nc, L, G, hpg)
        bw = rnd(Bf[:, :, :, :, None] * w[..., None])
        sc = torch.einsum("bclgkn,bclgkp->bcgknp", bw, xf)
        dec = torch.exp(torch.clamp(cum[:, :, -1], min=MIN_LOG))
        return (y.reshape(B_, nc * L, H, P), sc.reshape(B_, nc, H, N, P),
                dec, cum)
    return intra


# (B, S, H, P, G, N, chunk): mamba2's N = 128 and hymba's N = 16 with a
# ragged last chunk, at the chip's input scales
EMULATION_SHAPES = [(1, 512, 4, 64, 1, 128, 256),
                    (2, 300, 4, 64, 1, 16, 256)]


def _tc_run(shape, rnd, monkeypatch):
    """(y, h) of ``ssd_scan_kernel`` on the CPU with the intra-chunk pass
    emulating the kernel's rounding ``rnd``, and the JAX oracle's (y, h),
    on bf16 x, B, C drawn as chip_smoke draws them."""
    B, S, H, P, G, N, L = shape
    rng = np.random.default_rng(S + N)
    np_in = (rng.standard_normal((B, S, H, P), np.float32),
             np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
             .astype(np.float32),
             -np.exp(rng.standard_normal(H)).astype(np.float32),
             rng.standard_normal((B, S, G, N), np.float32),
             rng.standard_normal((B, S, G, N), np.float32))
    j, t = _cast(np_in, jnp.bfloat16, torch.bfloat16)
    j[1] = jnp.asarray(np_in[1])  # dt in f32, as the model passes it
    t[1] = torch.from_numpy(np_in[1])
    yr, hr = jax_ssd_reference(*j)
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk",
                        _tc_intra_chunk_emulation(rnd))
    y, h = ssd_scan_kernel(*t, chunk=L, device="cpu")
    return (y.numpy(), h.numpy()), (np.asarray(yr, np.float32),
                                    np.asarray(hr, np.float32))


@pytest.mark.parametrize("shape", EMULATION_SHAPES)
def test_tc_kernel_emulation_matches_oracle(shape, monkeypatch):
    """M X and the state in TF32 (the kernel's rounding) stay within the
    chip's bf16 tolerance (atol 1e-1) of the naive recurrence."""
    (y, h), (yr, hr) = _tc_run(shape, _round_tf32, monkeypatch)
    np.testing.assert_allclose(y, yr, atol=1e-1)
    np.testing.assert_allclose(h, hr, atol=1e-1)


def test_bf16_rounding_of_m_misses_the_tolerance_at_n128(monkeypatch):
    """Why the kernel rounds M and B (.) w to TF32 and not to bf16: at
    mamba2's N = 128, |C B^T| ~ sqrt(N), and bf16's 8-bit mantissa puts y
    past the 1e-1 tolerance where TF32 stays well inside it."""
    (y16, _), (yr, _) = _tc_run(EMULATION_SHAPES[0], _round_bf16, monkeypatch)
    (y32, _), _ = _tc_run(EMULATION_SHAPES[0], _round_tf32, monkeypatch)
    err16, err32 = np.abs(y16 - yr).max(), np.abs(y32 - yr).max()
    assert err16 > 1e-1 > 4 * err32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_kernel_shared_memory_fits_a_block(shape, dtype):
    """Each kernel instance's shared memory at the longest chunk fits the
    227 KB a block may use on an H100."""
    N, P = shape
    assert 0 < smem_bytes(dtype, TC_MAX_CHUNK, N, P) <= MAX_SMEM
    assert MAX_SMEM == 232_448
