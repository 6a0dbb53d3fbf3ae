"""The port's attention (``repro_torch.kernels.flash_attention``) against the
reference's Pallas flash kernel in interpret mode and its jnp oracle
``attention_ref``, on the reference's own sweep (``test_kernels.py``'s
``ATTN_SHAPES``: MHA, GQA, MQA, ragged, window, rectangular blocks, plus
MLA's head dim 192, with v as wide and with MLA's own v of 128) and its
``q_offset`` case. The Pallas kernel has one head dim for q, k and v: at
MLA's pair it runs on v zero-padded to 192 and its output is cut back to
128 columns (the padded columns are zeros, and the rest is the same
function); the oracle takes v at 128 as it is.

On the CPU ``flash_attention`` runs the plain version, the function the
CUDA kernels are held to on the card. Tolerances are the reference's own
(``test_kernels.py``): f32 atol 2e-5, bf16 atol 2e-2. Inputs are drawn with
numpy and cast to bf16 by both frameworks (round to nearest even).

The bf16 tensor-core kernel's arithmetic (128-row query tiles walking
64-key tiles in ascending order, exp2, P rounded to bf16 before P V) is
emulated here, not in the package, and held to the JAX oracle at the chip's
bf16 tolerance on its edge cases (MLA's pair among them); each kernel
instance's shared memory, at every head-dim pair, is held to the 227 KB a
block may use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (
    attention_mask,
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIM_PAIRS,
    TC_BK,
    TC_BQ,
    check_tma,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF

ATTN_SHAPES = [
    # (B, S, H, KH, D, bq, bk, window, Dv), as test_kernels.py (Dv = D)
    (1, 128, 4, 4, 64, 64, 64, None, 64),  # MHA
    (2, 256, 8, 2, 64, 128, 128, None, 64),  # GQA 4:1
    (2, 256, 8, 1, 32, 64, 128, None, 32),  # MQA
    (1, 200, 4, 2, 64, 64, 64, None, 64),  # ragged (pad path)
    (2, 256, 4, 4, 128, 64, 64, 96, 128),  # sliding window
    (1, 512, 2, 2, 64, 128, 256, 128, 64),  # window, rectangular blocks
    (1, 160, 4, 4, 192, 64, 64, None, 192),  # MLA's q/k head dim 128 + 64
    (1, 160, 4, 2, 192, 64, 64, 48, 128),  # MLA's pair, GQA, window
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Sk, H, KH, D, seed, Dv=None):
    """q, k, v, seeded; v of width ``Dv`` (default D)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32),
            rng.standard_normal((B, Sk, KH, D if Dv is None else Dv),
                                np.float32))


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def reference():
    """Every case through JAX once: (inputs, Pallas interpret, oracle)."""
    out = {}
    for i, shape in enumerate(ATTN_SHAPES):
        B, S, H, KH, D, bq, bk, window, Dv = shape
        np_in = _inputs(B, S, S, H, KH, D, seed=i, Dv=Dv)
        for name, (jdt, _, _) in DTYPES.items():
            q, k, v = (jnp.asarray(a, jdt) for a in np_in)
            # the Pallas kernel's one head dim: v zero-padded, cut back
            vp = jnp.pad(v, [(0, 0)] * 3 + [(0, D - Dv)])
            pallas = jax_flash(q, k, vp, window=window, block_q=bq,
                               block_k=bk, interpret=True)[..., :Dv]
            oracle = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v),
                                         window=window))
            out[shape, name] = (np_in, np.asarray(pallas, np.float32),
                                np.asarray(oracle, np.float32))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_matches_pallas_and_oracle(reference, shape, dtype):
    np_in, pallas, oracle = reference[shape, dtype]
    _, tdt, atol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in np_in)
    out = flash_attention(q, k, v, window=shape[7], device="cpu")
    assert out.dtype == tdt and out.shape == q.shape[:3] + v.shape[3:]
    got = out.float().numpy()
    np.testing.assert_allclose(got, pallas, atol=atol)
    np.testing.assert_allclose(got, oracle, atol=atol)


def test_attention_q_offset_decode_chunk():
    """Chunked decode/extension: q_offset shifts the causal diagonal
    (queries are positions 192..255 of 256 keys)."""
    B, H, D, Sk, Sq, off = 1, 2, 64, 256, 64, 192
    np_in = _inputs(B, Sq, Sk, H, H, D, seed=7)
    q, k, v = (jnp.asarray(a) for a in np_in)
    pallas = jax_flash(q, k, v, q_offset=off, block_q=64, block_k=64,
                       interpret=True)
    oracle = _bhsd(attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), q_offset=off))
    got = flash_attention(*(torch.from_numpy(a) for a in np_in), q_offset=off,
                          device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-5)


def test_attention_gqa_reads_kv_head_h_over_g():
    """Head h attends with KV head h // G: equal to MHA on repeated K/V."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 40, 40, 6, 2, 16, 3))
    got = flash_attention_ref(q, k, v, window=9)
    rep = flash_attention_ref(q, k.repeat_interleave(3, 2),
                              v.repeat_interleave(3, 2), window=9)
    torch.testing.assert_close(got, rep, rtol=0, atol=0)


def test_attention_mask_window_and_offset():
    m = attention_mask(3, 6, causal=True, window=2, q_offset=3)
    assert m.tolist() == [
        [False, False, True, True, False, False],
        [False, False, False, True, True, False],
        [False, False, False, False, True, True],
    ]


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the CUDA wrapper raises; only ``ops`` picks the plain
    version, and only by the tensors' device."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# the bf16 Hopper kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
LOG2E = 1.4426950408889634


def _tc_kernel_emulation(q, k, v, *, window=None, q_offset=0):
    """What ``flash_fwd_tc_kernel`` computes, in plain PyTorch: 128-row query
    tiles walk their live 64-key tiles in ascending order (the reference's
    tile skipping), keys past ``Sk`` read as zeros and are masked, scores in
    f32 masked with the finite -1e30, an online softmax in exp2 with the
    scale folded into the exponent, and P rounded to bf16 before P V (l
    sums the unrounded p). Returns the output and, per query row, whether
    its first walked tile was fully masked."""
    B, Sq, H, D = q.shape
    Sk, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    BQ, BK = TC_BQ, TC_BK
    nk = -(-Sk // BK)
    pad = nk * BK - Sk
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(G, 2)
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(G, 2)
    qf = q.float()
    scale = D**-0.5 * LOG2E
    out = torch.empty((B, Sq, H, Dv), dtype=torch.float32)
    first_masked = torch.zeros(Sq, dtype=torch.bool)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        first_q, last_q = q_offset + q0, q_offset + q0 + BQ - 1
        kt1 = min(nk, last_q // BK + 1)
        kt0 = 0
        if window is not None and first_q - window + 1 > 0:
            kt0 = (first_q - window + 1) // BK
        qp = q_offset + rows
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), Dv))
        for kt in range(kt0, kt1):
            keys = torch.arange(kt * BK, (kt + 1) * BK)
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows],
                             kf[:, kt * BK:(kt + 1) * BK])
            vis = (keys[None, :] < Sk) & (keys[None, :] <= qp[:, None])
            if window is not None:
                vis &= keys[None, :] > qp[:, None] - window
            if kt == kt0:
                first_masked[rows] = ~vis.any(1)
            s = torch.where(vis, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            # a row that has seen no visible key takes p = 1 (exp(0))
            c = torch.where(m_new == NEG_INF, 0.0, scale)
            corr = torch.exp2((m - m_new) * scale)
            p = torch.exp2(s * c[..., None] - (m_new * c)[..., None])
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                              vf[:, kt * BK:(kt + 1) * BK])
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / l.clamp(min=1e-30)[..., None]
        out[:, rows] = o.permute(0, 2, 1, 3)
    return out.to(q.dtype), first_masked


TC_CASES = [
    # (B, Sq, Sk, H, KH, D, window, q_offset, Dv)
    (1, 300, 300, 2, 2, 64, 70, 0, 64),  # window rows whose first tile is dead
    (2, 200, 200, 4, 2, 16, None, 0, 16),  # D = 16, ragged Sq and Sk
    (1, 200, 200, 4, 1, 32, 40, 0, 32),  # D = 32, MQA, window
    (1, 333, 333, 2, 2, 128, 100, 0, 128),  # D = 128, two column blocks
    (1, 333, 333, 4, 2, 192, 100, 0, 192),  # D = 192, GQA, window
    (2, 200, 200, 4, 4, 192, None, 0, 192),  # D = 192, ragged Sq and Sk
    (2, 64, 1377, 4, 2, 64, 1024, 1313, 64),  # a 64-query q_offset chunk
    (1, 40, 40, 2, 2, 64, None, 0, 64),  # Sk below one key tile
    (1, 333, 333, 4, 2, 192, 100, 0, 128),  # MLA's pair, GQA, window
    (2, 64, 1377, 2, 2, 192, None, 1313, 128),  # MLA's pair, q_offset
]


@pytest.mark.parametrize("case", TC_CASES)
def test_tc_kernel_emulation_matches_oracle(case):
    """The bf16 kernel's arithmetic (bf16 P, exp2, tile walk) stays within
    the chip tolerance of the JAX oracle (atol 2e-2)."""
    B, Sq, Sk, H, KH, D, window, off, Dv = case
    np_in = _inputs(B, Sq, Sk, H, KH, D, seed=Sq + D, Dv=Dv)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in np_in)
    got, _ = _tc_kernel_emulation(q, k, v, window=window, q_offset=off)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in np_in)
    want = _bhsd(attention_ref(_bhsd(jq), _bhsd(jk), _bhsd(jv), window=window,
                               q_offset=off))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_tc_emulation_window_case_has_a_fully_masked_first_tile():
    """The window case of ``TC_CASES`` does reach the -1e30 cancellation:
    rows whose first walked key tile is fully masked, and the output there
    still equals the oracle's."""
    B, Sq, Sk, H, KH, D, window, off, _ = TC_CASES[0]
    np_in = _inputs(B, Sq, Sk, H, KH, D, seed=1)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in np_in)
    got, first_masked = _tc_kernel_emulation(q, k, v, window=window)
    assert first_masked.sum() > 50
    want = flash_attention_ref(q, k, v, window=window)
    rows = first_masked.nonzero()[:, 0]
    torch.testing.assert_close(got[:, rows].float(), want[:, rows].float(),
                               rtol=0, atol=2e-2)


def _chip_smoke_row_rtol() -> dict:
    """``chip_smoke.ATTN_ROW_RTOL``, the per-row relative tolerance the
    card's moonshot flash checks use, read from the script itself."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ATTN_ROW_RTOL


def _max_row_rel_err(got, want):
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(
        -1, want.shape[-1])
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def test_row_rtol_holds_the_kernel_arithmetic_and_catches_a_dropped_tile():
    """At moonshot's S = 2,000 and D = 128 with near-uniform attention
    (small q and k, as random weights give), the bf16 kernel's emulated
    arithmetic stays within the chip's per-row relative tolerance of the
    plain version (about 0.004 against 2e-2), while zeroing one 64-key
    tile's values moves some row by over ten times that (about 0.25)."""
    rtol = _chip_smoke_row_rtol()["torch.bfloat16"]
    g = torch.Generator().manual_seed(0)
    q, k = (0.3 * torch.randn((1, 2000, 2, 128), generator=g)
            for _ in range(2))
    v = torch.randn((1, 2000, 2, 128), generator=g)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    got, _ = _tc_kernel_emulation(q, k, v)
    want = flash_attention_ref(q, k, v)
    assert _max_row_rel_err(got, want) <= rtol / 2
    v_drop = v.clone()
    v_drop[:, 1024:1024 + TC_BK] = 0
    assert _max_row_rel_err(flash_attention_ref(q, k, v_drop), want) > 10 * rtol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "D", HEAD_DIM_PAIRS,
    ids=lambda p: str(p[0]) if p[0] == p[1] else f"{p[0]}-{p[1]}")
def test_kernel_shared_memory_fits_a_block(D, dtype):
    """Each kernel instance's shared memory, at each head-dim pair ``D`` =
    (D, Dv), fits the 227 KB a block may use on an H100."""
    assert 0 < smem_bytes(dtype, *D) <= 232_448


def test_tma_check_refuses_unaligned_strides():
    """The bf16 kernel's wrapper raises on what TMA cannot read: a stride
    that is not a multiple of 8 elements, or a base not 16-byte aligned."""
    t = torch.zeros((1, 16, 3, 72), dtype=torch.bfloat16)
    check_tma("q", t[..., :64])  # strides (3456, 216, 72): multiples of 8
    with pytest.raises(ValueError, match="multiples of 8"):
        check_tma("q", torch.zeros((1, 16, 3, 68), dtype=torch.bfloat16)
                  [..., :64])
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tma("q", t[..., 1:65])
