"""The port's ``dist`` on ``torch.distributed`` against ``repro.dist``.

Both sides run the same seeded numpy inputs (``tests/torch_dist_ranks.py``):

- the reference in a subprocess of this file with 8 forced host devices
  (the pytest process keeps its one-device view), on meshes built as
  ``Mesh(np.array(jax.devices()[:n]).reshape(shape), names)``: those have
  Auto axes, under which the reference's shard_map EP and the ``jax.grad``
  of its pipeline run (``jax.make_mesh`` gives Explicit axes, under which
  they raise);
- the port on 8 gloo ranks on the CPU (``launch.mesh.spawn_ranks``, a
  ``file://`` init under ``tmp_path``), spawned once for the module, joined
  with a timeout so that a hang fails one test.

The cases: ``apply_schedule`` / ``apply_alltoall_schedule`` for n = 8 (an
(8,) mesh) and n = 4 (the ``model`` axis of a (2, 4) mesh), DPM, MU and the
ring schedules, outputs and ``jax.vjp`` gradients exact, and bf16 / int8
chunks crossing bit for bit; ``compressed_psum`` at lengths 1,024, 1,000
and 1,001 (a padded last chunk), two calls with error feedback: the int8
payloads, scales and residuals exact, the sums within 1e-6 of their max
(XLA orders the n-term f32 sum its own way); ``pipeline_apply`` (tanh
layers, L = 8, d = 16, 4 stages, M = 8) forward and ``jax.grad`` within
1e-6, the stage-count ``ValueError`` the same; ``moe_apply_ep`` on a
(2, 4) mesh at moonshot's smoke width, capacity factors 8.0 (no drops: also
equal to the port's dense path) and 1.25 (drops that depend on the shard)
within 2e-5 of the reference's EP with the same kept pairs and aux, the
exchange posting p2p batches and no ``all_to_all_single``, and the
gradient of x through EP equal to the dense path's (2e-5); a two-layer
moonshot smoke ``prefill`` with ``moe_impl="ep"`` under ``shardctx``
against the dense prefill (1e-5); ``to_placements`` on a (2, 2, 2) mesh
and its (2, 2) submesh against ``jax.device_put`` shards, and
``shardctx.constrain`` on a ``DTensor`` and a plain tensor.
"""
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # the reference's side, in its own process
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240


# --------------------------------------------------------------- reference
def _reference(out_path: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.dist.compress as jcomp
    from repro.configs import SMOKES
    from repro.dist.ep import moe_apply_ep
    from repro.dist.multicast import (alltoall_schedule, apply_alltoall_schedule,
                                      apply_schedule, dp_broadcast_schedule,
                                      ring_alltoall_schedule,
                                      ring_broadcast_schedule)
    from repro.dist.pipeline import pipeline_apply
    from repro.dist.sharding import spec_for_shape
    from repro.models.moe import capacity, dispatch_indices, route

    assert jax.device_count() == 8, jax.devices()

    def mesh(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

    inp = R.inputs()
    out = {}
    # executors: outputs and vjp
    for n in R.EXEC_NS:
        m = mesh((n,), ("r",))
        for kind in ("bcast", "a2a"):
            for algo in R.ALGOS:
                if kind == "bcast":
                    sched = (ring_broadcast_schedule(n) if algo == "ring"
                             else dp_broadcast_schedule(n, algo))
                    fn = apply_schedule
                else:
                    sched = (ring_alltoall_schedule(n) if algo == "ring"
                             else alltoall_schedule(n, algo))
                    fn = apply_alltoall_schedule
                f = jax.jit(shard_map(
                    lambda xl, s=sched, fn=fn: fn(xl[0], s, "r")[None],
                    mesh=m, in_specs=P("r"), out_specs=P("r"),
                    check_rep=False))
                y, vjp = jax.vjp(f, jnp.asarray(inp[f"{kind}_x{n}"]))
                (dx,) = vjp(jnp.asarray(inp[f"{kind}_ct{n}"]))
                out[f"{kind}{n}_{algo}_y"] = np.asarray(y)
                out[f"{kind}{n}_{algo}_dx"] = np.asarray(dx)
    # compressed psum, twice with error feedback
    m8 = mesh((8,), ("data",))
    for length in R.COMPRESS_LENGTHS:
        def two(gl):
            g = gl[0]
            s1, e1 = jcomp.compressed_psum(g, jnp.zeros_like(g), "data")
            s2, e2 = jcomp.compressed_psum(g, e1, "data")
            return s1[None], e1[None], s2[None], e2[None]

        res = jax.jit(shard_map(two, mesh=m8, in_specs=P("data"),
                                out_specs=(P("data"),) * 4,
                                check_rep=False))(inp[f"comp_g{length}"])
        for k, a in zip(("s1", "e1", "s2", "e2"), res):
            out[f"comp{length}_{k}"] = np.asarray(a)
        g = jnp.asarray(inp[f"comp_g{length}"])
        v = jnp.pad(g, ((0, 0), (0, (-length) % R.N_RANKS)))
        q, scale = jax.jit(jax.vmap(jcomp._quantize_int8))(
            v.reshape(R.N_RANKS, R.N_RANKS, -1))
        out[f"comp{length}_q"] = np.asarray(q)
        out[f"comp{length}_scale"] = np.asarray(scale)
    # pipeline: forward, grad of sum(y**2) in (stage params, x), the error
    S, L, d = R.PIPE_S, R.PIPE_L, R.PIPE_D
    mp = mesh((S,), ("pipe",))
    sp = jnp.asarray(inp["pipe_w"]).reshape(S, L // S, d, d)
    x = jnp.asarray(inp["pipe_x"])

    def layer(w, h):
        return jnp.tanh(h @ w)

    def loss(sp, x):
        return jnp.sum(pipeline_apply(layer, sp, x, mp, axis="pipe") ** 2)

    out["pipe_y"] = np.asarray(jax.jit(
        lambda sp, x: pipeline_apply(layer, sp, x, mp, axis="pipe"))(sp, x))
    dw, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(sp, x)
    out["pipe_dw"], out["pipe_dx"] = np.asarray(dw), np.asarray(dx)
    try:
        pipeline_apply(layer, sp[:2], x, mp, axis="pipe")
        out["pipe_err"] = np.asarray("")
    except ValueError as e:
        out["pipe_err"] = np.asarray(str(e))
    # expert parallelism on (2, 4); the kept pairs of each token shard
    mdm = mesh((2, 4), ("data", "model"))
    p = jax.tree.map(jnp.asarray, R.ep_params(inp))
    x = jnp.asarray(inp["ep_x"])
    for cf in R.EP_CFS:
        c = SMOKES[R.EP_ARCH]
        cfg = dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
        y, aux = jax.jit(lambda p, x, cfg=cfg: moe_apply_ep(p, x, cfg, mdm))(
            p, x)
        out[f"ep{cf}_y"], out[f"ep{cf}_aux"] = np.asarray(y), np.asarray(aux)
        xt = x.reshape(-1, x.shape[-1])
        t_loc = xt.shape[0] // R.N_RANKS
        cap = capacity(cfg.moe, t_loc)
        for s in range(R.N_RANKS):
            ids, _, _ = route(p, xt[s * t_loc:(s + 1) * t_loc], cfg.moe)
            out[f"ep{cf}_keep_r{s}"] = np.asarray(
                dispatch_indices(ids, cfg.moe, cap)[1])
    # placements: each rank's shard of device_put (rank k is device k)
    meshes = {"pdm": mesh((2, 2, 2), ("pod", "data", "model")),
              "dm": mesh((2, 2), ("data", "model"))}
    for i, (name, shape, spec) in enumerate(R.PLACE_CASES):
        a = inp["place_x" if shape == (8, 4, 6) else "place_y"]
        sh = NamedSharding(meshes[name], P(*spec))
        idx = sh.devices_indices_map(a.shape)
        devs = jax.devices()
        for k in range(R.N_RANKS):
            out[f"place{i}_r{k}"] = a[idx[devs[k % meshes[name].size]]]
    h = inp["place_x"].reshape(8, 24)
    spec = spec_for_shape(("batch", "mlp"), h.shape, meshes["dm"])
    idx = NamedSharding(meshes["dm"], spec).devices_indices_map(h.shape)
    for k in range(R.N_RANKS):
        out[f"constrain_r{k}"] = h[idx[jax.devices()[k % 4]]]
    np.savez(out_path, **out)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, the port's outputs per rank): the reference's
    subprocess runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    np.savez(tmp / "inputs.npz", **R.inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "ref.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        from repro_torch.launch.mesh import spawn_ranks

        port = spawn_ranks(R.port_rank, R.N_RANKS, (str(tmp / "inputs.npz"),),
                           out_dir=tmp / "ranks", device_type="cpu",
                           timeout_s=SPAWN_TIMEOUT_S)
        log, _ = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    return dict(np.load(tmp / "ref.npz")), port


def _coord(rank: int, axis: str) -> int:
    """The rank's coordinate on the test's meshes: the (8,) mesh's
    ``data``, the (2, 4) meshes' ``model`` / ``pipe``."""
    return rank if axis == "data" else rank % 4


def test_executors_match_reference(runs):
    ref, port = runs
    for n, axis in zip(R.EXEC_NS, ("data", "model")):
        for kind in ("bcast", "a2a"):
            for algo in R.ALGOS:
                for r, got in enumerate(port):
                    me = _coord(r, axis)
                    for k in ("y", "dx"):
                        key = f"{kind}{n}_{algo}_{k}"
                        np.testing.assert_array_equal(got[key], ref[key][me],
                                                      err_msg=f"{key} r{r}")
    for got in port:
        assert got["a2a_bytes_torch.bfloat16"] and got["a2a_bytes_torch.int8"]


def test_compressed_psum_matches_reference(runs):
    ref, port = runs
    for length in R.COMPRESS_LENGTHS:
        for r, got in enumerate(port):
            for k in ("e1", "e2"):
                key = f"comp{length}_{k}"
                np.testing.assert_array_equal(got[key], ref[key][r],
                                              err_msg=f"{key} r{r}")
            for k in ("q", "scale"):
                key = f"comp{length}_{k}"
                np.testing.assert_array_equal(got[key], ref[key][r],
                                              err_msg=f"{key} r{r}")
            for k in ("s1", "s2"):
                key = f"comp{length}_{k}"
                want = ref[key][r]
                np.testing.assert_allclose(got[key], want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{key} r{r}")
                np.testing.assert_array_equal(got[key], port[0][key])
        # against the exact sum, the reference's own bound
        total = R.inputs()[f"comp_g{length}"].sum(0)
        rel = np.abs(port[0][f"comp{length}_s1"] - total).max() / np.abs(
            total).max()
        assert rel < 0.05, (length, rel)


def test_pipeline_matches_reference_and_grad(runs):
    ref, port = runs
    for r, got in enumerate(port):
        stage = _coord(r, "pipe")
        scale = np.abs(ref["pipe_y"]).max()
        np.testing.assert_allclose(got["pipe_y"], ref["pipe_y"], rtol=0,
                                   atol=1e-6 * scale)
        # each leaf within 1e-6 of its max: the stage parameters and x
        for key, want, leaf in (
                ("pipe_dw_stage", ref["pipe_dw"][stage], ref["pipe_dw"]),
                ("pipe_dx", ref["pipe_dx"], ref["pipe_dx"])):
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=1e-6 * np.abs(leaf).max(),
                                       err_msg=f"{key} r{r}")
        assert got["pipe_dw_others_zero"]
        assert str(got["pipe_err"]) == str(ref["pipe_err"]) != ""


def test_moe_apply_ep_matches_reference_and_dense(runs):
    ref, port = runs
    for cf in R.EP_CFS:
        scale = np.abs(ref[f"ep{cf}_y"]).max()
        dropped = 0
        for r, got in enumerate(port):
            np.testing.assert_allclose(got[f"ep{cf}_y"], ref[f"ep{cf}_y"],
                                       rtol=0, atol=2e-5 * scale)
            np.testing.assert_allclose(got[f"ep{cf}_aux"], ref[f"ep{cf}_aux"],
                                       rtol=1e-6)
            np.testing.assert_array_equal(got[f"ep{cf}_keep"],
                                          ref[f"ep{cf}_keep_r{r}"])
            dropped += int((~got[f"ep{cf}_keep"]).sum())
            if cf == 8.0:  # no drops: the dense path too
                np.testing.assert_allclose(got[f"ep{cf}_y"],
                                           got[f"ep{cf}_dense_y"], rtol=0,
                                           atol=2e-5 * scale)
            # the exchange: two schedule executions of p2p batches, one a
            # round this rank takes part in, and no bare all-to-all
            assert got[f"ep{cf}_a2a"] == 0
            assert got[f"ep{cf}_p2p"] == 2 * got["ep_my_rounds"]
        assert (dropped == 0) == (cf == 8.0), (cf, dropped)
        group = sum(int(g[f"ep{cf}_p2p"]) for g in port[:4])
        assert group >= 2 * int(port[0]["ep_rounds"])
    for got in port:
        want = got["ep_dx_dense"]
        np.testing.assert_allclose(got["ep_dx_ep"], want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())
        want = got["prefill_dense"]
        np.testing.assert_allclose(got["prefill_ep"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_to_placements_and_constrain(runs):
    ref, port = runs
    for r, got in enumerate(port):
        for i in range(len(R.PLACE_CASES)):
            np.testing.assert_array_equal(got[f"place{i}"],
                                          ref[f"place{i}_r{r}"],
                                          err_msg=f"case {i} r{r}")
        np.testing.assert_array_equal(got["constrain"], ref[f"constrain_r{r}"])
        assert got["constrain_plain"]


def test_a_hung_or_failed_rank_fails_within_the_timeout(tmp_path):
    import time

    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(R.hang, 2, out_dir=tmp_path / "hang", device_type="cpu",
                    timeout_s=10)
    with pytest.raises(RuntimeError, match="exited with code 1"):
        spawn_ranks(R.fail, 2, out_dir=tmp_path / "fail", device_type="cpu",
                    timeout_s=60)
    assert time.monotonic() - t0 < 60


if __name__ == "__main__":
    _reference(sys.argv[1])
