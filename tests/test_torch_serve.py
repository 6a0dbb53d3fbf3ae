"""The port's model serving (``repro_torch.serve``): ``generate`` against the
reference's on the same weights, for every configuration at smoke width
(the frame models on seeded numpy frames, fed back as zero frames at each
decode step, as the reference does), and ``BatchServer``'s batch formation,
slicing, left padding, reuse, close/drain and queue depth, as
``tests/test_serve.py`` checks the reference's.

Greedy tokens are compared with the reference's only where its top two
logits differ by more than 1e-3: random weights give near-ties, where the
two frameworks' f32 rounding may pick either token. Sampling with
``temperature > 0`` draws from a seeded ``torch.Generator``: deterministic
per seed, not the reference's ``jax.random`` bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRun
from repro.models import decode_step as jax_decode
from repro.models import model_init as jax_init
from repro.models import prefill as jax_prefill
from repro.serve.engine import generate as jax_generate
from repro_torch.configs import SMOKES
from repro_torch.models import RunConfig, model_init, params_from_jax
from repro_torch.serve import BatchServer, Request, generate

RUN_KW = dict(remat="none", attn_chunk_q=32, attn_chunk_k=32, vocab_round=64,
              activations_dtype="float32", kv_cache_dtype="float32")
RUN = RunConfig(**RUN_KW)
NEAR_TIE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = SMOKES["smollm-135m"]
    return model_init(0, cfg, RUN, device="cpu")[0], cfg


def _prompts(cfg, B, S, seed):
    """Token prompts (B, S), or a frame model's frames (B, S, d)."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input == "frames":
        return rng.standard_normal((B, S, cfg.d_model), np.float32)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _jax_logit_gaps(jp, cfg, run, prompts, tokens):
    """The reference's top-two logit gap at each step of ``tokens`` (its own
    greedy continuation), from its prefill and decode_step (a frame model
    is fed zero frames, as its ``generate`` does)."""
    B, S = prompts.shape[:2]
    steps = tokens.shape[1]
    frames = cfg.embed_input == "frames"
    key = "frames" if frames else "tokens"
    logits, caches = jax.jit(lambda p, t: jax_prefill(
        p, {key: t}, cfg, run, cache_len=S + steps))(
        jp, jnp.asarray(prompts))
    dec = jax.jit(lambda p, c, t, pos: jax_decode(
        p, c, {key: t, "pos": pos}, cfg, run))
    gaps = []
    for t in range(steps):
        top2 = np.sort(np.asarray(logits[:, -1, : cfg.vocab]), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if t < steps - 1:
            nxt = (np.zeros((B, 1, cfg.d_model), np.float32) if frames
                   else tokens[:, t:t + 1])
            logits, caches = dec(jp, caches, jnp.asarray(nxt),
                                 jnp.int32(S + t))
    return np.stack(gaps, 1)  # (B, steps)


@pytest.mark.parametrize("name", ["hymba-1.5b", "smollm-135m", "mamba2-1.3b",
                                  "stablelm-1.6b", "starcoder2-7b",
                                  "qwen1.5-32b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-236b", "musicgen-medium",
                                  "qwen2-vl-72b"])
def test_generate_greedy_matches_reference(name):
    jcfg, cfg = JAX_SMOKES[name], SMOKES[name]
    jrun = JaxRun(**RUN_KW)
    jp = jax.jit(lambda k: jax_init(k, jcfg, jrun)[0])(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, RUN,
                             device="cpu")
    prompts = _prompts(cfg, 3, 70, seed=1)  # past hymba's smoke window (64)
    want = jax_generate(jp, jcfg, jrun, jnp.asarray(prompts), steps=8).tokens
    got = generate(params, cfg, RUN, prompts, steps=8, device="cpu").tokens
    assert got.shape == want.shape == (3, 8) and got.dtype == np.int32
    gaps = _jax_logit_gaps(jp, jcfg, jrun, prompts, want)
    compared = 0
    for b in range(3):
        for t in range(8):
            if gaps[b, t] > NEAR_TIE:
                assert got[b, t] == want[b, t], (b, t, gaps[b, t])
                compared += 1
            elif got[b, t] != want[b, t]:
                break  # a near-tie went the other way: the rest may differ
    assert compared >= 12


def test_generate_shapes_and_greedy_determinism(tiny):
    params, cfg = tiny
    prompts = _prompts(cfg, 2, 8, seed=1)
    r1 = generate(params, cfg, RUN, prompts, steps=5, device="cpu")
    r2 = generate(params, cfg, RUN, prompts, steps=5, device="cpu")
    assert r1.tokens.shape == (2, 5) and r1.tokens.dtype == np.int32
    assert (0 <= r1.tokens).all() and (r1.tokens < cfg.vocab).all()
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.prefill_ms > 0 and r1.decode_ms_per_token > 0


def test_generate_temperature_uses_seed(tiny):
    params, cfg = tiny
    prompts = _prompts(cfg, 2, 8, seed=2)
    kw = dict(steps=8, temperature=1.5, device="cpu")
    a = generate(params, cfg, RUN, prompts, seed=3, **kw)
    b = generate(params, cfg, RUN, prompts, seed=3, **kw)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    c = generate(params, cfg, RUN, prompts, seed=4, **kw)
    assert not np.array_equal(a.tokens, c.tokens)
    assert (0 <= a.tokens).all() and (a.tokens < cfg.vocab).all()


def test_batch_server_formation_and_slicing(tiny):
    """max_batch caps the first batch, the rest drain on the next call;
    every response carries its request id and exactly max_tokens tokens."""
    params, cfg = tiny
    srv = BatchServer(params, cfg, RUN, max_batch=3, max_wait_s=0.01,
                      device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=4 + i),
                    max_tokens=2 + (i % 3)) for i in range(5)]
    for r in reqs:
        srv.submit(r)
    first = srv.serve_once()
    second = srv.serve_once()
    assert [r.rid for r in first] == [0, 1, 2]
    assert [r.rid for r in second] == [3, 4]
    for resp in first + second:
        assert resp.tokens.shape == (reqs[resp.rid].max_tokens,)
        assert resp.latency_s >= 0
    assert srv.stats == {"batches": 2, "requests": 5,
                         "tokens": 3 * max(2, 3, 4) + 2 * max(2, 3)}
    assert srv.last_result.tokens.shape == (2, 3)


def test_batch_server_left_pads_to_longest(tiny):
    """Prompts of unequal length align on the last token (left padding with
    token 0, no pad mask, as in the reference)."""
    params, cfg = tiny
    prompt = _prompts(cfg, 1, 6, seed=5)[0]
    srv = BatchServer(params, cfg, RUN, max_batch=2, max_wait_s=0.01,
                      device="cpu")
    srv.submit(Request(rid=0, prompt=prompt, max_tokens=3))
    srv.submit(Request(rid=1, prompt=prompt[2:], max_tokens=3))
    r0, r1 = srv.serve_once()
    padded = np.zeros((1, 6), np.int32)
    padded[0, 2:] = prompt[2:]
    solo = generate(params, cfg, RUN, padded, steps=3, device="cpu")
    np.testing.assert_array_equal(r1.tokens, solo.tokens[0])
    solo0 = generate(params, cfg, RUN, prompt[None], steps=3, device="cpu")
    np.testing.assert_array_equal(r0.tokens, solo0.tokens[0])


def test_batch_server_reuse_is_deterministic(tiny):
    params, cfg = tiny
    prompt = _prompts(cfg, 1, 8, seed=6)[0]
    srv = BatchServer(params, cfg, RUN, max_batch=2, max_wait_s=0.01,
                      device="cpu")
    outs = []
    for _ in range(2):
        srv.submit(Request(rid=0, prompt=prompt, max_tokens=4))
        srv.submit(Request(rid=1, prompt=prompt[::-1].copy(), max_tokens=4))
        outs.append(srv.serve_once())
    for a, b in zip(outs[0], outs[1]):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert srv.stats == {"batches": 2, "requests": 4, "tokens": 16}


def test_batch_server_queue_depth_and_close_drain(tiny):
    params, cfg = tiny
    srv = BatchServer(params, cfg, RUN, max_batch=4, max_wait_s=0.01,
                      device="cpu")
    rng = np.random.default_rng(1)
    for i in range(3):
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=5),
                           max_tokens=2))
    assert srv.queue_depth == 3 and not srv.closed
    out = srv.close(drain=True)
    assert [r.rid for r in out] == [0, 1, 2]
    assert srv.closed and srv.queue_depth == 0
    with pytest.raises(RuntimeError):
        srv.submit(Request(rid=9, prompt=rng.integers(0, cfg.vocab, size=5),
                           max_tokens=1))
    assert srv.serve_once() == []


def test_batch_server_close_without_drain_drops_queue(tiny):
    params, cfg = tiny
    srv = BatchServer(params, cfg, RUN, max_batch=4, max_wait_s=0.01,
                      device="cpu")
    srv.submit(Request(rid=0, prompt=np.zeros(4, np.int32), max_tokens=1))
    assert srv.close(drain=False) == []
    assert srv.queue_depth == 0 and srv.stats["requests"] == 0
