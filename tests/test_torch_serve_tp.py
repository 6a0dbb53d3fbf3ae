"""Serving on a mesh (prefill and decode on each rank's blocks, caches laid
out by ``CACHE_RULES``) against one process and against the reference,
and the stream options of the plain attention and SSD.

The port runs on four gloo ranks on the CPU, once for the module
(``launch.mesh.spawn_ranks``; the rank code is
``tests/torch_serve_tp_ranks.py``, which imports no JAX), the reference in
a subprocess of this file with 4 forced host devices on a mesh with Auto
axes, as ``tests/test_torch_tp.py`` builds it. Every run is a smoke config
in f32 with f32 caches (``RUN_KW``: the vocabulary padded to a multiple of
96, so that the last vocabulary block holds padding) from the port's
seeded ``model_init``: B = 4 rows, a 70-token prompt (hymba's 64-slot ring
wraps in the prefill), then 6 teacher-forced decode steps, the caches 76
positions long. A rank takes its ``tree_shardings`` blocks of the
parameters and serves under ``shardctx.set_ctx(mesh, blocks=True)``.

- **(2, 2) ``("data", "model")``**: all ten configurations; the logits of
  the prefill and of every step within 1e-5 of one process's, on every
  rank (they are whole); every cache leaf, after the prefill and after
  the last step, has the shape of its ``CACHE_RULES`` block of one
  process's cache and equals it within 1e-5 of the leaf's largest
  magnitude (the residual stream's sums over ``model`` round otherwise
  than one process's: up to 1.7e-6 of it on hymba's SSD state).
- **int8 caches** (smollm, and hymba's ring beside its global layers):
  codes equal save flips of one quantum (values within rounding of a
  tie) in at most 1e-3 of them; the prefill's logits and caches, which
  read no code, under the rules above; the decode steps read the codes,
  and a flipped code moves a score by up to a quantum's share, which
  carries into the later steps: their logits within 1e-4 and their f32
  leaves within 1e-4 of the leaf's largest magnitude (measured: 5.5e-5
  and 2.5e-5).
- **A 4-rank ``model`` axis**: smollm, whose 6 q and 2 kv heads split
  mid-head (the prefill's k/v come whole from the head split's gather).
- **Expert parallelism on the blocks**: moonshot under ``moe_impl="ep"``
  (``dist.ep`` on the rank's rows and experts, the router and shared
  expert gathered) at a capacity factor that drops nothing equals the
  one-process dense serve within 1e-5.
- **init_caches** on the mesh gives each rank its zeroed blocks; a cache
  length the ``model`` axis does not divide raises.
- **The reference**: smollm, moonshot, deepseek (MLA) and hymba against
  the reference's ``prefill``/``decode_step`` jitted with
  ``prefill_cell``/``decode_cell``'s shardings (caches under
  ``CACHE_RULES``, the logits left whole) on the Auto (2, 2) mesh: logits
  within 1e-5, the ranks' cache blocks equal the reference's under the
  rule above.
- **Stream options**: ``flash_attention_ref(stream_bf16=True)`` against
  the reference's ``chunked_attention(..., stream_bf16=True)`` (one block
  of keys, so that both round the same probabilities; atol 2e-5, the
  reference's own test's) and ``ssd_scan(stream_bf16=True)`` against the
  reference's (atol 2e-4, likewise).
"""
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the reference's side, in its own process
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_serve_tp_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 300
TOL = 1e-5
# int8 caches: the decode logits' bound (a one-quantum flip of a code at
# a tie: module docstring)
INT8_DECODE_TOL = 1e-4


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


# --------------------------------------------------------------- reference
def _reference(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import SMOKES
    from repro.dist.sharding import CACHE_RULES, spec_for_shape, tree_shardings
    from repro.models import RunConfig
    from repro.models.model import (abstract_init, cache_axes, decode_step,
                                    init_caches, prefill)

    assert jax.device_count() == 4, jax.devices()
    tmp = Path(tmp)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    run = RunConfig(**R.RUN_KW)
    out = {}
    for name in R.REF_NAMES:
        cfg = SMOKES[name]
        init = dict(np.load(tmp / f"init_{name}.npz"))
        params = jax.tree.map(jnp.asarray, _nest(init))
        _, pspecs = abstract_init(cfg, run)
        psh = tree_shardings(pspecs, params, mesh)
        cshape = jax.eval_shape(lambda: init_caches(cfg, run, R.B,
                                                    R.CACHE_LEN))
        csh = tree_shardings(cache_axes(cfg, run), cshape, mesh, CACHE_RULES)

        def rows(S):
            return NamedSharding(mesh, spec_for_shape(("batch", "seq"),
                                                      (R.B, S), mesh))

        toks = jnp.asarray(R.inputs(cfg)["tokens"])
        pre = jax.jit(lambda p, b: prefill(p, b, cfg, run,
                                           cache_len=R.CACHE_LEN),
                      in_shardings=(psh, {"tokens": rows(R.PROMPT)}),
                      out_shardings=(None, csh))
        dec = jax.jit(lambda p, c, b: decode_step(p, c, b, cfg, run),
                      in_shardings=(psh, csh, {"tokens": rows(1),
                                               "pos": NamedSharding(mesh,
                                                                    P())}),
                      out_shardings=(None, csh), donate_argnums=1)
        logits, caches = pre(params, {"tokens": toks[:, :R.PROMPT]})
        seq = [np.asarray(logits)]
        for i in range(R.STEPS):
            pos = R.PROMPT + i
            logits, caches = dec(params, caches, {
                "tokens": toks[:, pos:pos + 1], "pos": jnp.int32(pos)})
            seq.append(np.asarray(logits))
        out[f"{name}/logits"] = np.stack(seq)
        for path, x in jax.tree_util.tree_flatten_with_path(caches)[0]:
            g = path[0].key
            leaf = "/".join(str(k.key) for k in path[1:])
            for i, layer in enumerate(np.asarray(x)):
                out[f"{name}/caches/{g}/{i}/{leaf}"] = layer
    np.savez(tmp / "ref.npz", **out)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess beside the four ranks, then the
    one-process runs."""
    import torch

    from repro_torch.configs import SMOKES
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.layers import tree_flatten

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_serve_tp")
    for name in R.REF_NAMES:
        params, _ = R.whole_params(name, R.run_config())
        np.savez(tmp / f"init_{name}.npz", **{
            k: t.numpy() for k, t in tree_flatten(params)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        ranks = spawn_ranks(R.mesh_ranks, 4, (), out_dir=tmp / "ranks",
                            device_type="cpu", timeout_s=SPAWN_TIMEOUT_S)
        one = {}
        for name in R.NAMES:
            run = R.run_config()
            one[name] = R.serve(R.whole_params(name, run)[0], SMOKES[name],
                                run, R.inputs(SMOKES[name]))
        for name in R.INT8_NAMES:
            run = R.run_config(kv_cache_dtype="int8")
            one[f"{name}/int8"] = R.serve(R.whole_params(name, run)[0],
                                          SMOKES[name], run,
                                          R.inputs(SMOKES[name]))
        run = R.run_config()
        one["ep"] = R.serve(R.whole_params(R.EP_NAME, run)[0], R.ep_cfg(), run,
                            R.inputs(R.ep_cfg()))
        log, _ = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    torch.set_num_threads(n_threads)
    assert ref.returncode == 0, log[-4000:]
    yield {"ref": dict(np.load(tmp / "ref.npz")), "ranks": ranks, "one": one}


# --------------------------------------------------------------- helpers
def _leaf_axes(cfg, run) -> dict:
    """``group/leaf`` -> one layer's logical axes of its cache leaf."""
    from repro_torch.models.layers import tree_flatten
    from repro_torch.models.model import cache_axes

    return {f"{g}/{path}": axes[1:]
            for g, tree in cache_axes(cfg, run).items()
            for path, axes in tree_flatten(tree)}


def _block(want: np.ndarray, axes, mesh, coords) -> np.ndarray:
    from repro_torch.dist.sharding import (CACHE_RULES, shard_slices,
                                           spec_for_shape)

    spec = spec_for_shape(axes, want.shape, mesh, CACHE_RULES)
    return want[shard_slices(spec, want.shape, mesh, coords)]


def _assert_caches(got: dict, want: dict, cfg, run, mesh, coords,
                   what: str, tol: float = TOL) -> None:
    """Every leaf of ``got`` (a rank's) is the ``CACHE_RULES`` block of
    ``want`` (one process's whole caches): the block's shape, f32 within
    ``TOL`` of the leaf's largest magnitude, int8 codes within one
    quantum, flipped only at a tie."""
    axes = _leaf_axes(cfg, run)
    assert set(got) == set(want), what
    for path, whole in want.items():
        g, _, leaf = path.split("/", 2)
        w = _block(whole, axes[f"{g}/{leaf}"], mesh, coords)
        x = got[path]
        assert x.shape == w.shape, (what, path, x.shape, w.shape)
        assert x.dtype == w.dtype, (what, path)
        if x.dtype == np.int8:
            diff = np.abs(x.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, (what, path, diff.max())
            assert (diff > 0).mean() <= 1e-3, (what, path, (diff > 0).mean())
            continue
        scale = max(1.0, float(np.abs(whole).max()))
        err = float(np.abs(x.astype(np.float64) - w).max())
        assert err <= tol * scale, (what, path, err, scale)


def _assert_logits(got, want, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _mesh(name: str):
    from repro_torch.dist.sharding import abstract_mesh

    return (abstract_mesh(("model", 4)) if name == "m4"
            else abstract_mesh(("data", 2), ("model", 2)))


# --------------------------------------------------------------- (2, 2)
@pytest.mark.parametrize("name", R.NAMES)
def test_each_configuration_serves_on_a_data_model_mesh_like_one_process(
        runs, name):
    from repro_torch.configs import SMOKES

    one = runs["one"][name]
    for r, got in enumerate(runs["ranks"]):
        _assert_logits(got[name]["logits"], one["logits"], f"{name} r{r}")
        for key in ("prefill_caches", "caches"):
            _assert_caches(got[name][key], one[key], SMOKES[name],
                           R.run_config(), _mesh("dm"), got["coords"]["dm"],
                           f"{name} r{r} {key}")


@pytest.mark.parametrize("name", R.INT8_NAMES)
def test_int8_caches_on_the_mesh_are_the_one_process_blocks(runs, name):
    from repro_torch.configs import SMOKES

    one = runs["one"][f"{name}/int8"]
    run = R.run_config(kv_cache_dtype="int8")
    for r, got in enumerate(runs["ranks"]):
        mine = got[f"{name}/int8"]
        # the prefill's logits and caches read no codes; the decode steps
        # read them, and a flip at a tie carries into the later steps
        for key, tol in (("prefill_caches", TOL),
                         ("caches", INT8_DECODE_TOL)):
            _assert_caches(mine[key], one[key], SMOKES[name], run,
                           _mesh("dm"), got["coords"]["dm"],
                           f"{name} int8 r{r} {key}", tol)
        _assert_logits(mine["logits"][0], one["logits"][0],
                       f"{name} int8 r{r} prefill")
        np.testing.assert_allclose(mine["logits"][1:], one["logits"][1:],
                                   rtol=0, atol=INT8_DECODE_TOL,
                                   err_msg=f"{name} int8 r{r} decode")


def test_heads_split_mid_head_on_a_four_rank_model_axis(runs):
    from repro_torch.configs import SMOKES

    one = runs["one"][R.M4_NAME]
    for r, got in enumerate(runs["ranks"]):
        _assert_logits(got["m4"]["logits"], one["logits"], f"m4 r{r}")
        for key in ("prefill_caches", "caches"):
            _assert_caches(got["m4"][key], one[key], SMOKES[R.M4_NAME],
                           R.run_config(), _mesh("m4"), got["coords"]["m4"],
                           f"m4 r{r} {key}")


def test_expert_parallel_serving_on_the_blocks_equals_dense(runs):
    one = runs["one"]["ep"]
    for r, got in enumerate(runs["ranks"]):
        _assert_logits(got["ep"]["logits"], one["logits"], f"ep r{r}")
        _assert_caches(got["ep"]["caches"], one["caches"], R.ep_cfg(),
                       R.run_config(), _mesh("dm"), got["coords"]["dm"],
                       f"ep r{r}")


def test_init_caches_on_the_mesh_gives_each_rank_its_blocks(runs):
    for got in runs["ranks"]:
        for name, (shapes, want) in got["init"].items():
            assert shapes == want, name
        assert "does not split over the 2 ranks of 'model'" in \
            got["init_refused"]


# --------------------------------------------------------------- reference
@pytest.mark.parametrize("name", R.REF_NAMES)
def test_mesh_serving_equals_the_references_jitted_prefill_and_decode(
        runs, name):
    from repro_torch.configs import SMOKES

    ref = runs["ref"]
    want = {k[len(f"{name}/caches/"):]: v for k, v in ref.items()
            if k.startswith(f"{name}/caches/")}
    for r, got in enumerate(runs["ranks"]):
        _assert_logits(got[name]["logits"], ref[f"{name}/logits"],
                       f"{name} r{r} vs reference")
        _assert_caches(got[name]["caches"], want, SMOKES[name],
                       R.run_config(), _mesh("dm"), got["coords"]["dm"],
                       f"{name} r{r} vs reference")


# --------------------------------------------------------------- stream
@pytest.mark.parametrize("window", [None, 16])
def test_stream_attention_matches_the_references_streamed_attention(window):
    import jax.numpy as jnp
    import torch

    from repro.models.attention import chunked_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(11)
    B, S, H, KH, D = 2, 48, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window, chunk_q=64, chunk_k=64,
                             stream_bf16=True)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              stream_bf16=True)
    plain = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the option rounds: it is not the f32 function
    assert float((got - plain).abs().max()) > 1e-4


def test_stream_ssd_matches_the_references_streamed_scan():
    import jax.numpy as jnp
    import torch

    from repro.models.ssm import ssd_scan as jax_ssd_scan
    from repro_torch.models.ssm import ssd_scan

    rng = np.random.default_rng(12)
    B, S, H, P, G, N, L = 2, 40, 4, 8, 2, 16, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    y_w, h_w = jax_ssd_scan(*(jnp.asarray(t) for t in (x, dt, A, Bm, Cm)),
                            L, return_state=True, stream_bf16=True)
    args = [torch.from_numpy(t) for t in (x, dt, A, Bm, Cm)]
    y, h = ssd_scan(*args, L, return_state=True, stream_bf16=True)
    y_plain = ssd_scan(*args, L)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_w), atol=2e-4)
    assert float((y - y_plain).abs().max()) > 1e-4


if __name__ == "__main__":
    _reference(sys.argv[1])
