"""The SSD intra-chunk pass's backward (``repro_torch.kernels.ssd``:
``ops.SsdIntraChunk``, ``ref.ssd_intra_chunk_bwd_ref``) on the CPU against
the reference, which trains by differentiating its jnp ``ssd_scan``
(``repro.models.ssm``; its Pallas kernel has no backward).

- ``ssd_scan_kernel(device="cpu")`` under autograd, y and h_last both
  given cotangents, against ``jax.vjp`` of ``ssd_scan`` on
  ``test_torch_ssd.py``'s ``SSD_SHAPES`` (ragged and grouped): every
  gradient within 5e-4 of its largest |.| in f32, and within 1e-1 of it
  on bf16 inputs (the forward's bf16 tolerance; both sides compute in f32
  from the same bf16 values and round the gradient to bf16).
- ``ssd_intra_chunk_bwd_ref``, the closed form the CUDA kernel computes,
  against torch autograd of ``ssd_intra_chunk_ref`` with cotangents on
  all four outputs: within 1e-5 of each gradient's largest |.| (measured
  up to 6e-7: the same f32 products summed in another order).
- A chunk whose decay spans 256 (> 88.7, where exp of the masked upper
  triangle overflows): the reference ``ssd_scan``'s dt and A gradients
  are NaN, the port's are finite and within 5e-4 of ``jax.vjp`` of the
  naive recurrence ``ssd_reference``.
- One training step of hymba's and mamba2's smoke configs with
  ``models.ssm.ssd_scan`` patched to the Function path against the
  reference's step, under ``tests/test_torch_train.py``'s rule.
- The backward kernel's shared memory at each instance, and serving (grad
  off) still running the forward alone.

Inputs draw dt = softplus(z - 2) and A = -exp(z / 2), so that a chunk's
decay spans at most ~40 (as at the models' init) and the reference's own
gradient stays finite, save in the steep-decay case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro.models.ssm import ssd_scan as jax_ssd_scan
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_state as jax_init_state
from repro.train import synthetic_batch as jax_batch
import repro_torch.kernels.ssd.ops as ssd_ops
import repro_torch.models.ssm as ssm
from repro_torch.kernels.ssd import (
    SsdIntraChunk, ssd_intra_chunk, ssd_intra_chunk_bwd_ref,
    ssd_intra_chunk_ref, ssd_scan_kernel,
)
from repro_torch.kernels.ssd.ssd import (
    MAX_SMEM, TC_MAX_CHUNK, TC_SHAPES, bwd_smem_bytes,
)
from repro_torch.models.layers import tree_flatten
from repro_torch.train import build_train_step, init_state
from test_torch_ssd import SSD_SHAPES
from test_torch_train import _jax_paths, _pair, _torch_batch

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-1)}
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    """x, dt, A, Bm, Cm (numpy f32) and the largest decay span of a
    chunk."""
    B, S, H, P, G, N, L = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)
                  ).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) / 2).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    pad = (-S) % L
    spans = np.pad(dt, [(0, 0), (0, pad), (0, 0)]).reshape(
        B, -1, L, H).sum(2) * -A
    return (x, dt, A, Bm, Cm), float(spans.max())


def _assert_close(got, want, rtol, what=""):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, (what, name, err / scale)


def _port_grads(np_in, tdt, dy, dh, chunk):
    """The port's gradients of <y, dy> + <h_last, dh> through
    ``ssd_scan_kernel`` on the CPU (the ``SsdIntraChunk`` path)."""
    t = [torch.from_numpy(a).to(torch.float32 if i == 2 else tdt)
         .requires_grad_(True) for i, a in enumerate(np_in)]
    y, h = ssd_scan_kernel(*t, chunk=chunk, device="cpu")
    assert y.grad_fn is not None
    torch.autograd.backward((y, h), (torch.from_numpy(dy),
                                     torch.from_numpy(dh)))
    return [a.grad.float().numpy() for a in t]


def _jax_grads(fn, np_in, jdt, dy, dh):
    j = [jnp.asarray(a, jnp.float32 if i == 2 else jdt)
         for i, a in enumerate(np_in)]
    (y, h), vjp = jax.vjp(fn, *j)
    return [np.asarray(g, np.float32) for g in vjp(
        (jnp.asarray(dy, y.dtype), jnp.asarray(dh, h.dtype)))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_gradients_match_jax_vjp_of_ssd_scan(shape, dtype):
    B, S, H, P, G, N, L = shape
    np_in, span = _inputs(shape, SSD_SHAPES.index(shape))
    assert span < 80
    rng = np.random.default_rng(100 + SSD_SHAPES.index(shape))
    dy = rng.standard_normal((B, S, H, P), np.float32)
    dh = rng.standard_normal((B, H, N, P), np.float32)
    jdt, tdt, rtol = DTYPES[dtype]
    want = _jax_grads(jax.jit(lambda *a: jax_ssd_scan(
        *a, chunk=L, return_state=True)), np_in, jdt, dy, dh)
    got = _port_grads(np_in, tdt, dy, dh, L)
    _assert_close(got, want, rtol, shape)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_closed_form_backward_matches_autograd_of_the_forward(shape):
    B, S, H, P, G, N, L = shape
    np_in, span = _inputs(shape, 7)
    assert span < 80
    t = [torch.from_numpy(a).requires_grad_(True) for a in np_in]
    outs = ssd_intra_chunk_ref(*t, L)
    gen = torch.Generator().manual_seed(8)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    want = torch.autograd.grad(outs, t, cots)
    got = ssd_intra_chunk_bwd_ref(*(a.detach() for a in t),
                                  outs[3].detach(), *cots, L)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want], 1e-5)


def test_steep_decay_stays_finite_where_the_reference_goes_nan():
    """dt = 1, A = (-1, -16), chunks of 16: a span of 256 in head 1."""
    B, S, H, P, G, N, L = 1, 32, 2, 8, 1, 16, 16
    rng = np.random.default_rng(3)
    np_in = (rng.standard_normal((B, S, H, P), np.float32),
             np.ones((B, S, H), np.float32),
             np.array([-1.0, -16.0], np.float32),
             rng.standard_normal((B, S, G, N), np.float32),
             rng.standard_normal((B, S, G, N), np.float32))
    dy = rng.standard_normal((B, S, H, P), np.float32)
    dh = rng.standard_normal((B, H, N, P), np.float32)
    ref = _jax_grads(lambda *a: jax_ssd_scan(*a, chunk=L, return_state=True),
                     np_in, jnp.float32, dy, dh)
    assert np.isnan(ref[1]).any() and np.isnan(ref[2]).any()
    assert all(np.isfinite(g).all() for g in (ref[0], ref[3], ref[4]))
    want = _jax_grads(jax_ssd_reference, np_in, jnp.float32, dy, dh)
    got = _port_grads(np_in, torch.float32, dy, dh, L)
    _assert_close(got, want, 5e-4)


@pytest.mark.parametrize("name", ["hymba-1.5b", "mamba2-1.3b"])
def test_one_train_step_through_the_function_matches_reference(
        name, monkeypatch):
    """Batch 4 of 48 tokens: chunks of 32, the last one ragged. The rule
    of ``tests/test_torch_train.py``: loss and grad norm within 1e-5, the
    parameters within 2 lr, at most 1e-3 of them beyond 1e-6."""
    jcfg, jrun, jp, cfg, run, tp = _pair(name)
    jb = jax_batch(jcfg, 4, 48, 0, 0)
    jstate, jm = jax.jit(jax_build_train_step(jcfg, jrun))(
        jax_init_state(jp), jb)
    backwards = []

    def scan(*args, return_state, stream_bf16):
        assert return_state and not stream_bf16
        return ssd_scan_kernel(*args, device="cpu")

    def bwd(*args):
        backwards.append(args[0].shape)
        return ssd_intra_chunk_bwd_ref(*args)

    monkeypatch.setattr(ssm, "ssd_scan", scan)
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk_bwd_ref", bwd)
    tstate, tm = build_train_step(cfg, run)(init_state(tp), _torch_batch(jb))
    assert len(backwards) == cfg.n_layers  # every layer has SSD heads
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    lr = float(jm["lr"])
    want = _jax_paths(jstate.params)
    diffs = np.concatenate([np.abs(p.numpy() - want[path]).ravel()
                            for path, p in tree_flatten(tstate.params)])
    assert diffs.max() <= 2 * lr * (1 + 1e-5)
    assert (diffs > 1e-6).mean() <= 1e-3, (diffs > 1e-6).mean()


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_backward_kernel_shared_memory_fits_a_block(shape):
    """The tile kernel's shared memory at the longest chunk, for each
    (N, P) it is built for, fits the 227 KB a block may use."""
    assert 0 < bwd_smem_bytes(TC_MAX_CHUNK, *shape) <= MAX_SMEM


def test_grad_off_runs_the_forward_alone():
    """Serving (grad off, or no input that requires grad) builds no
    autograd node; under grad the outputs come from ``SsdIntraChunk``."""
    np_in, _ = _inputs(SSD_SHAPES[0], 0)
    t = [torch.from_numpy(a) for a in np_in]
    L = SSD_SHAPES[0][-1]
    assert all(o.grad_fn is None for o in ssd_intra_chunk(*t, L,
                                                          device="cpu"))
    t[0].requires_grad_(True)
    with torch.no_grad():
        assert ssd_intra_chunk(*t, L, device="cpu")[0].grad_fn is None
    y = ssd_intra_chunk(*t, L, device="cpu")[0]
    assert type(y.grad_fn).__name__ == f"{SsdIntraChunk.__name__}Backward"
