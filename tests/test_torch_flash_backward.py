"""The port's attention backward (``repro_torch.kernels.flash_attention``)
against the reference's hand-written backward.

- ``flash_attention_bwd_ref`` (the CPU path and the backward kernel's
  oracle) against ``jax.vjp`` of ``repro.models.attention.
  chunked_attention`` and against ``_flash_bwd_impl`` called directly, on
  seeded f32 inputs: causal MHA, GQA at G = 3 with a window, G = 8, D = 16,
  64 and 128, a ragged S, a ``q_offset`` chunk, and MLA's pair (q/k 192, v
  128) under GQA with a window and as a ``q_offset`` chunk. atol 1e-5:
  both are the same f32 function summed in another order (the reference in
  32-wide chunks), a few ulps of O(1) gradients apart.
- ``flash_attention_ref(..., return_lse=True)``'s row log-sum-exp against
  ``_flash_fwd_impl``'s, atol 1e-5 (the same reason).
- The ``torch.autograd.Function`` behind ``flash_attention`` on the CPU
  against ``torch.autograd`` through the plain forward, atol 1e-5; without
  grad the serving path keeps its plain forward and no graph.
- The bf16 kernel's arithmetic (P and dS rounded to bf16 before their
  second products, the gradients to bf16) emulated here, not in the
  package, within half the per-row bound that ``chip_smoke.py`` holds the
  kernel to (``BWD_ROW_RTOL`` 2e-2, rows floored at a tenth of the mean row
  norm), and a dropped 64-key tile over ten times that bound.
- Each backward kernel instance's shared memory within a block's 227 KB,
  at every head-dim pair ``HEAD_DIM_PAIRS`` on both routes (``wgmma``, the
  default, and ``mma_sync``); on the card the SSD kernel refuses a call
  under grad; a head-dim pair outside ``HEAD_DIM_PAIRS`` and an unknown
  route raise.
- The wgmma kernels' tile walks (``bwd_live_key_tiles`` for a dQ block,
  ``bwd_live_query_tiles`` for a dK/dV block in query tiles of each pair's
  ``bwd_query_tile``, mirrors of the source's ``live_key_tiles`` /
  ``live_query_tiles``) against ``attention_mask`` on the cases above (the
  fifth is also the card's ``q_offset`` case) and at stablelm's training
  shape: every visible pair in exactly one visited tile of each pass, no
  visited tile wholly masked.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import (
    _flash_bwd_impl,
    _flash_fwd_impl,
    chunked_attention,
)
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    attention_mask,
    flash_attention,
    flash_attention_bwd_cuda,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_ROUTES,
    BWD_TILE,
    BWD_WGS,
    HEAD_DIM_PAIRS,
    bwd_live_key_tiles,
    bwd_live_query_tiles,
    bwd_query_tile,
    bwd_smem_bytes,
    check_pair,
    smem_bytes,
)
from repro_torch.kernels.ssd import ssd_intra_chunk_bwd_cuda

# (B, Sq, Sk, H, KH, D, Dv, window, q_offset)
CASES = [
    (2, 96, 96, 4, 4, 64, 64, None, 0),  # causal MHA
    (1, 80, 80, 6, 2, 16, 16, 24, 0),  # GQA G = 3, window
    (1, 64, 64, 8, 1, 128, 128, None, 0),  # GQA G = 8, D = 128
    (2, 77, 77, 3, 1, 64, 64, None, 0),  # ragged S, G = 3
    (1, 40, 100, 4, 2, 32, 32, 50, 60),  # q_offset chunk with a window
    (1, 90, 90, 4, 2, 192, 128, 40, 0),  # MLA's pair, GQA, window, ragged
    (1, 40, 100, 2, 2, 192, 128, None, 60),  # MLA's pair, q_offset chunk
]
IDS = ["mha", "g3_window_d16", "g8_d128", "ragged_g3", "q_offset_window",
       "mla_g2_window", "mla_q_offset"]


def _pair_id(pair):
    """A pair's test id: its head dim where v is as wide, else "D-Dv"."""
    D, Dv = pair
    return str(D) if D == Dv else f"{D}-{Dv}"
ATOL = 1e-5
CHUNK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Sq, Sk, H, KH, D, seed=0, Dv=None):
    """q, k, v and dout, seeded; v and dout of width ``Dv`` (default D)."""
    Dv = D if Dv is None else Dv
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, Dv),
                      (B, Sq, H, Dv))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_jax_vjp_and_flash_bwd_impl(case):
    B, Sq, Sk, H, KH, D, Dv, window, q_offset = case
    q, k, v, do = _inputs(B, Sq, Sk, H, KH, D, Dv=Dv)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, **kw)

    def fwd(q_, k_, v_):
        return chunked_attention(q_, k_, v_, chunk_q=CHUNK, chunk_k=CHUNK,
                                 **kw)

    jout, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    for a, b in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    jo, jlse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               True, window, CHUNK, CHUNK, q_offset)
    direct = _flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jlse, jo, jnp.asarray(do), True, window, CHUNK,
                             CHUNK, q_offset)
    for a, b in zip(got, direct):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert [tuple(t.shape) for t in got] == [a.shape for a in (q, k, v)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_matches_flash_fwd_impl(case):
    B, Sq, Sk, H, KH, D, Dv, window, q_offset = case
    q, k, v, _ = _inputs(B, Sq, Sk, H, KH, D, seed=1, Dv=Dv)
    _, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, window=window,
                                 q_offset=q_offset, return_lse=True)
    _, jlse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              True, window, CHUNK, CHUNK, q_offset)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, Sq, H)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, Sq, H), atol=ATOL)


@pytest.mark.parametrize("window", [None, 20])
def test_autograd_function_matches_autograd_of_the_plain_forward(window):
    q, k, v, do = map(torch.from_numpy, _inputs(2, 50, 50, 6, 2, 32, seed=2))
    grads = []
    for fn in (lambda *a: flash_attention(*a, window=window, device="cpu"),
               lambda *a: flash_attention_ref(*a, window=window)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        grads.append(torch.autograd.grad(out, leaves, do))
    out = flash_attention(*(t.requires_grad_(True) for t in (q, k, v)),
                          window=window, device="cpu")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_serving_forward_builds_no_graph():
    q, k, v, _ = map(torch.from_numpy, _inputs(1, 20, 20, 2, 2, 16))
    with torch.no_grad():
        out = flash_attention(*(t.requires_grad_(True) for t in (q, k, v)),
                              device="cpu")
    assert out.grad_fn is None
    plain = flash_attention(q.detach(), k.detach(), v.detach(), device="cpu")
    assert plain.grad_fn is None and torch.equal(out, plain)
    assert issubclass(FlashAttention, torch.autograd.Function)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _bwd_bf16_emulated(q, k, v, out, lse, dout, drop_tile=None):
    """The bf16 kernel's arithmetic: bf16 inputs, f32 products, P and dS
    rounded to bf16 before P^T dO, dS^T Q and dS K, gradients rounded to
    bf16; ``drop_tile`` zeroes one 64-key tile of P (a planted fault)."""
    B, S, H, D = q.shape
    qf, kf, vf, of, dof = (_bf16(t) for t in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * D**-0.5
    p = torch.exp(torch.clamp(s - lse.permute(0, 2, 1)[..., None], max=30.0))
    p = torch.where(attention_mask(S, S, causal=True, window=None,
                                   q_offset=0), p, 0.0)
    if drop_tile is not None:
        p[..., 64 * drop_tile: 64 * drop_tile + 64] = 0.0
    delta = (dof * of).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * D**-0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf)
    return tuple(_bf16(t) for t in (dq, dk, dv))


def _row_rel(got, want, floor=0.1):
    norms = want.norm(dim=-1)
    return float(((got - want).norm(dim=-1)
                  / norms.clamp_min(floor * float(norms.mean()))).max())


def test_bf16_backward_arithmetic_within_the_chip_row_bound():
    """chip_smoke.py's BWD_ROW_RTOL (2e-2) holds the emulated kernel
    arithmetic with a margin of two and catches a dropped key tile."""
    q, k, v, do = (_bf16(torch.from_numpy(a))
                   for a in _inputs(1, 256, 256, 2, 2, 64, seed=3))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    want = flash_attention_bwd_ref(q, k, v, _bf16(out), lse, do)
    got = _bwd_bf16_emulated(q, k, v, out, lse, do)
    errs = [_row_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) <= 1e-2, errs
    dropped = _bwd_bf16_emulated(q, k, v, out, lse, do, drop_tile=1)
    assert max(_row_rel(a, b) for a, b in zip(dropped, want)) > 0.2
    # the floor: the first causal row's dq is exactly 0 (p = 1 on its one
    # key, where dout . v equals delta)
    assert float(want[0][:, 0].abs().max()) < 1e-6


@pytest.mark.parametrize("part", ["dkdv", "dq"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", HEAD_DIM_PAIRS, ids=_pair_id)
def test_backward_kernel_shared_memory_fits_a_block(D, dtype, part):
    """At each head-dim pair ``D`` = (D, Dv), the default route."""
    assert 0 < bwd_smem_bytes(dtype, *D, part) <= 232_448


def test_card_refuses_training_what_it_has_no_backward_for():
    """The card's backward wrappers take CUDA tensors only: the flash
    backward's, and the SSD intra-chunk backward's (which replaced the SSD
    path's refusal under grad)."""
    q = torch.zeros((1, 8, 2, 192), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q.detach(), q.detach(), q.detach(),
                                 q.detach(), torch.zeros((1, 8, 2)),
                                 q.detach())
    x = torch.zeros((1, 8, 2, 16))
    dt, bm = torch.zeros((1, 8, 2)), torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_intra_chunk_bwd_cuda(x, dt, torch.zeros(2), bm, bm,
                                 torch.zeros((1, 2, 4, 2)),
                                 torch.zeros((1, 8, 2, 16)),
                                 torch.zeros((1, 2, 2, 16, 16)),
                                 torch.zeros((1, 2, 2)),
                                 torch.zeros((1, 2, 4, 2)), 4)


def test_head_dim_pair_outside_the_kernels_raises(monkeypatch):
    """MLA's (192, 128) is a pair of the kernels; (192, 64), (64, 128) and
    (128, 192) are not: the card's entry point under grad, the wrappers'
    checks and the shared-memory mirrors raise, naming the pairs."""
    assert (192, 128) in HEAD_DIM_PAIRS
    check_pair(192, 128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for D, Dv in ((192, 64), (64, 128), (128, 192)):
        q, k = (torch.zeros((1, 8, 2, D), requires_grad=True)
                for _ in range(2))
        v = torch.zeros((1, 8, 2, Dv), requires_grad=True)
        with pytest.raises(ValueError, match="take the pairs"):
            flash_attention(q, k, v, device="cuda")
        with pytest.raises(ValueError, match="take the pairs"):
            check_pair(D, Dv)
        with pytest.raises(ValueError, match="take the pairs"):
            smem_bytes(torch.bfloat16, D, Dv)
        for route in BWD_ROUTES:
            with pytest.raises(ValueError, match="take the pairs"):
                bwd_smem_bytes(torch.bfloat16, D, Dv, "dq", route=route)


def test_backward_route_shared_memory_fits_a_block():
    """Every (route, pair, dtype, part) instance of both backward routes."""
    for route, pair, dtype, part in itertools.product(
            BWD_ROUTES, HEAD_DIM_PAIRS, (torch.bfloat16, torch.float32),
            ("dkdv", "dq")):
        smem = bwd_smem_bytes(dtype, *pair, part, route=route)
        assert 0 < smem <= 232_448, (route, pair, dtype, part, smem)


def test_unknown_backward_route_raises():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="unknown backward route"):
        flash_attention_bwd_cuda(x, x, x, x, torch.zeros((1, 8, 2)), x,
                                 route="cutlass")
    with pytest.raises(ValueError, match="unknown backward route"):
        bwd_smem_bytes(torch.bfloat16, 64, 64, "dq", route="mma")


def _visits(mask, block, walk, tile_rows=BWD_TILE, **kw):
    """(Sq, Sk) visit counts of one pass, whose blocks hold ``block`` rows
    (dQ, ``walk`` its live key tiles of ``BWD_TILE``) or keys (dK/dV, its
    live query tiles of ``tile_rows``), and the visited tiles that hold no
    visible pair."""
    Sq, Sk = mask.shape
    count = torch.zeros((Sq, Sk), dtype=torch.int16)
    empty = []
    dq_pass = walk is bwd_live_key_tiles
    if not dq_pass:
        kw["tile"] = tile_rows
    for a0 in range(0, Sq if dq_pass else Sk, block):
        own = slice(a0, a0 + block)
        for tile in walk(a0, block, Sq, Sk, **kw):
            n = BWD_TILE if dq_pass else tile_rows
            other = slice(tile * n, (tile + 1) * n)
            r, c = (own, other) if dq_pass else (other, own)
            count[r, c] += 1
            if not bool(mask[r, c].any()):
                empty.append((a0, tile))
    return count, empty


# walks of several blocks whose window edges and offsets cross tiles
# (windows of 65 and 66 put a block's first key, or its last row, on a
# tile's edge; Sq = 60 < Sk leaves a 128-row block's nominal rows past Sq)
WALK_CASES = [
    (1, 333, 333, 1, 1, 64, 70, 0),
    (1, 400, 400, 1, 1, 64, 65, 0),
    (1, 400, 400, 1, 1, 64, 66, 0),
    (1, 60, 300, 1, 1, 64, None, 0),
    (1, 100, 500, 1, 1, 64, 150, 400),
    (1, 300, 700, 1, 1, 64, None, 400),
    (2, 4096, 4096, 32, 32, 64, None, 0),  # stablelm's training shape
]


def test_wgmma_tile_walks_cover_every_visible_pair_once():
    """The cases above (the fifth is also the card's q_offset case) and
    WALK_CASES, both passes; the dK/dV pass in the query tiles of every
    head-dim pair in ``HEAD_DIM_PAIRS`` (64 rows, MLA's 32, (192, 192)'s
    16)."""
    big = BWD_WGS * BWD_TILE
    tiles = sorted({bwd_query_tile(*p) for p in HEAD_DIM_PAIRS})
    assert tiles == [16, 32, 64]
    for B, Sq, Sk, H, KH, D, window, q_offset in [
            c[:6] + c[7:] for c in CASES] + WALK_CASES:
        kw = dict(causal=True, window=window, q_offset=q_offset)
        mask = attention_mask(Sq, Sk, **kw)
        for walk, rows in ([(bwd_live_key_tiles, BWD_TILE)]
                           + [(bwd_live_query_tiles, t) for t in tiles]):
            where = (Sq, Sk, window, q_offset, walk.__name__, rows)
            count, empty = _visits(mask, big, walk, rows, **kw)
            assert bool((count[mask] == 1).all()), where
            assert int(count.max()) <= 1, where
            assert not empty, (where, empty[:5])
