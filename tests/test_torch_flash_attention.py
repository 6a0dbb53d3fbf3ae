"""The port's attention (``repro_torch.kernels.flash_attention``) against the
reference's Pallas flash kernel in interpret mode and its jnp oracle
``attention_ref``, on the reference's own sweep (``test_kernels.py``'s
``ATTN_SHAPES``: MHA, GQA, MQA, ragged, window, rectangular blocks) and its
``q_offset`` case.

On the CPU ``flash_attention`` runs the plain version, the function the
CUDA kernel is held to on the card. Tolerances are the reference's own
(``test_kernels.py``): f32 atol 2e-5, bf16 atol 2e-2. Inputs are drawn with
numpy and cast to bf16 by both frameworks (round to nearest even).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (
    attention_mask,
    flash_attention,
    flash_attention_cuda,
    flash_attention_ref,
)

ATTN_SHAPES = [
    # (B, S, H, KH, D, bq, bk, window), as test_kernels.py
    (1, 128, 4, 4, 64, 64, 64, None),  # MHA
    (2, 256, 8, 2, 64, 128, 128, None),  # GQA 4:1
    (2, 256, 8, 1, 32, 64, 128, None),  # MQA
    (1, 200, 4, 2, 64, 64, 64, None),  # ragged (pad path)
    (2, 256, 4, 4, 128, 64, 64, 96),  # sliding window
    (1, 512, 2, 2, 64, 128, 256, 128),  # window, rectangular blocks
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Sk, H, KH, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32),
            rng.standard_normal((B, Sk, KH, D), np.float32))


def _bhsd(x):
    return x.transpose(0, 2, 1, 3)


@pytest.fixture(scope="module")
def reference():
    """Every case through JAX once: (inputs, Pallas interpret, oracle)."""
    out = {}
    for i, shape in enumerate(ATTN_SHAPES):
        B, S, H, KH, D, bq, bk, window = shape
        np_in = _inputs(B, S, S, H, KH, D, seed=i)
        for name, (jdt, _, _) in DTYPES.items():
            q, k, v = (jnp.asarray(a, jdt) for a in np_in)
            pallas = jax_flash(q, k, v, window=window, block_q=bq,
                               block_k=bk, interpret=True)
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
    out = flash_attention(q, k, v, window=shape[-1], device="cpu")
    assert out.dtype == tdt and out.shape == q.shape
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
