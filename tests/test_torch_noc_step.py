"""The port's segmented-min arbitration (``repro_torch.kernels.noc_step``)
on the CPU against ``repro``'s: its jnp oracle, its Pallas kernel in
interpret mode and its ``arbitrate`` on both backends. Integer outputs, so
every comparison is exact. The CUDA kernel itself runs only on the card
(``chip_smoke.py``, phase ``[segmin]``); here its wrapper must refuse CPU
tensors and the entry points a missing card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.noc_step import ops as jops
from repro.kernels.noc_step.noc_step import NOC_INF as J_NOC_INF
from repro.kernels.noc_step.noc_step import segmented_min as j_segmented_min
from repro.kernels.noc_step.ref import segmented_min_ref as j_segmented_min_ref
from repro_torch.kernels.noc_step import (
    NOC_INF,
    arbitrate,
    segmented_min,
    segmented_min_ref,
    segmin,
)

# tests/test_kernels.py's SEGMIN_SHAPES: (candidates, segments)
SEGMIN_SHAPES = [(64, 7), (1000, 256), (4096, 64), (37, 300), (512, 320)]


def _inputs(N, L, *, pad=0.0, above=0.0, seed=None):
    """Keys and segments as tests/test_kernels.py makes them (~30% NOC_INF,
    the rest below 2^22); ``pad`` moves that share of entries to segment -1
    or L with a NOC_INF key, ``above`` sets that share of keys above
    NOC_INF."""
    rng = np.random.default_rng(N * L if seed is None else seed)
    keys = rng.integers(0, 2**22, N).astype(np.int32)
    keys[rng.random(N) < 0.3] = NOC_INF
    segs = rng.integers(0, L, N).astype(np.int32)
    padded = rng.random(N) < pad
    segs[padded] = np.where(rng.random(int(padded.sum())) < 0.5, -1, L)
    keys[padded] = NOC_INF
    keys[rng.random(N) < above] = NOC_INF + 7
    return keys, segs


def _jax_outputs(keys, segs, L):
    k, s = jnp.asarray(keys), jnp.asarray(segs)
    return {
        "ref": np.asarray(j_segmented_min_ref(k, s, L)),
        "pallas_interpret": np.asarray(
            j_segmented_min(k, s, L, interpret=True)),
        "segmin_ref": np.asarray(jops.segmin(k, s, L, backend="ref")),
    }


CASES = [(f"{N}x{L}", N, L, {}) for N, L in SEGMIN_SHAPES] + [
    ("padded-512x320", 512, 320, {"pad": 0.1}),
    ("above-inf-1000x256", 1000, 256, {"above": 0.1}),
]


def test_noc_inf_is_the_reference_sentinel():
    assert NOC_INF == J_NOC_INF == 2**30


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_segmin_matches_reference(case):
    _, N, L, kw = case
    keys, segs = _inputs(N, L, **kw)
    want = _jax_outputs(keys, segs, L)
    # the two JAX paths agree with each other on these inputs
    np.testing.assert_array_equal(want["ref"], want["pallas_interpret"])
    np.testing.assert_array_equal(want["ref"], want["segmin_ref"])
    got_ref = segmented_min_ref(torch.from_numpy(keys),
                                torch.from_numpy(segs), L)
    got_ops = segmin(torch.from_numpy(keys), torch.from_numpy(segs), L,
                     device="cpu")
    for got in (got_ref, got_ops):
        assert got.dtype == torch.int32 and got.shape == (L,)
        np.testing.assert_array_equal(got.numpy(), want["ref"])
    # empty segments hold exactly NOC_INF, and nothing exceeds it
    live = (keys < NOC_INF) & (segs >= 0) & (segs < L)
    empty = np.setdiff1d(np.arange(L), segs[live])
    assert (got_ops.numpy()[empty] == NOC_INF).all()
    assert (got_ops.numpy() <= NOC_INF).all()


def test_segmin_takes_any_shape_and_numpy_inputs():
    keys, segs = _inputs(4096, 64)
    want = _jax_outputs(keys, segs, 64)["ref"]
    got = segmin(keys.reshape(64, 64), segs.reshape(64, 64), 64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = segmin(torch.from_numpy(keys.astype(np.int64)),
                   torch.from_numpy(segs.astype(np.int64)), 64, device="cpu")
    np.testing.assert_array_equal(got64.numpy(), want)


@pytest.mark.parametrize("L", [1, 5])
def test_segmin_of_no_candidates_is_all_noc_inf(L):
    empty = np.zeros(0, np.int32)
    got = segmin(empty, empty, L, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.full(L, NOC_INF))
    # the reference's oracle (its dense small-input branch cannot reduce
    # zero candidates)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_segmented_min_ref(jnp.asarray(empty),
                                                    jnp.asarray(empty), L)))


def _arbitrate_inputs():
    rng = np.random.default_rng(9)
    N, L = 777, 61
    keys = rng.permutation(N).astype(np.int32)  # unique
    segs = rng.integers(0, L, N).astype(np.int32)
    adm = rng.random(N) < 0.4
    return adm, keys, segs, L


@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
def test_arbitrate_matches_reference(backend):
    adm, keys, segs, L = _arbitrate_inputs()
    want = np.asarray(jops.arbitrate(jnp.asarray(adm), jnp.asarray(keys),
                                     jnp.asarray(segs), L, backend=backend))
    got = arbitrate(torch.from_numpy(adm), torch.from_numpy(keys),
                    torch.from_numpy(segs), L, device="cpu")
    assert got.dtype == torch.bool and got.shape == adm.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_arbitrate_one_winner_per_resource():
    adm, keys, segs, L = _arbitrate_inputs()
    win = arbitrate(adm, keys, segs, L, device="cpu").numpy()
    assert (win & ~adm).sum() == 0  # winners are admissible
    for seg in range(L):
        mask = (segs == seg) & adm
        if mask.any():
            # exactly the min-key admissible candidate wins
            expect = np.flatnonzero(mask)[keys[mask].argmin()]
            assert win[segs == seg].sum() == 1
            assert win[expect]
        else:
            assert win[segs == seg].sum() == 0


def test_arbitrate_ignores_padded_candidates():
    adm, keys, segs, L = _arbitrate_inputs()
    segs = segs.copy()
    segs[:50] = -1  # padding: never admissible by contract
    adm = adm.copy()
    adm[:50] = False
    want = np.asarray(jops.arbitrate(jnp.asarray(adm), jnp.asarray(keys),
                                     jnp.asarray(segs), L, backend="ref"))
    got = arbitrate(adm, keys, segs, L, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[:50].any()


def test_kernel_wrapper_takes_cuda_tensors_only():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segmented_min(keys, keys, 4)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys, segs = _inputs(64, 7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        segmin(keys, segs, 7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arbitrate(keys < NOC_INF, keys, segs, 7)
