"""Seeded inputs and the port's side of ``tests/test_torch_dist.py``.

``inputs()`` builds every case's numpy inputs; the reference's subprocess
and the port's gloo ranks both read them. ``port_rank`` runs on each of
eight CPU ranks (``launch.mesh.spawn_ranks``) and returns its outputs as
numpy. This module imports no JAX: the ranks load it by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np

N_RANKS = 8
EXEC_NS = (8, 4)  # the executors on the (8,) mesh and on the (2, 4) "model"
ALGOS = ("DPM", "MU", "ring")
COMPRESS_LENGTHS = (1024, 1000, 1001)
PIPE_L, PIPE_D, PIPE_S, PIPE_M = 8, 16, 4, 8
EP_ARCH = "moonshot-v1-16b-a3b"
EP_CFS = (8.0, 1.25)
EP_SHAPE = (4, 32)  # (B, S): 128 tokens, 16 to a shard on the (2, 4) mesh
# DTensor placements on the (2, 2, 2) ("pod", "data", "model") mesh and
# its (2, 2) ("data", "model") submesh: (mesh, shape, spec)
PLACE_CASES = (
    ("pdm", (8, 4, 6), (("pod", "data"), "model", None)),
    ("pdm", (8, 4, 6), ("pod", ("data", "model"), None)),
    ("pdm", (4, 6, 2), (None, None, None)),
    ("dm", (4, 6, 2), ("data", "model", None)),
    ("dm", (4, 6, 2), (("data", "model"), None, None)),
)


def ep_cfg(cf: float):
    """The port's smoke config at capacity factor ``cf``."""
    from repro_torch.configs import SMOKES

    c = SMOKES[EP_ARCH]
    return dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                          capacity_factor=cf))


def inputs() -> dict:
    rng = np.random.default_rng(26)
    f32 = np.float32
    out = {}
    for n in EXEC_NS:
        out[f"bcast_x{n}"] = rng.standard_normal((n, 3, 5)).astype(f32)
        out[f"bcast_ct{n}"] = rng.standard_normal((n, 3, 5)).astype(f32)
        out[f"a2a_x{n}"] = rng.standard_normal((n, n, 2, 3)).astype(f32)
        out[f"a2a_ct{n}"] = rng.standard_normal((n, n, 2, 3)).astype(f32)
    for length in COMPRESS_LENGTHS:
        out[f"comp_g{length}"] = rng.standard_normal(
            (N_RANKS, length)).astype(f32)
    L, d = PIPE_L, PIPE_D
    out["pipe_w"] = (rng.standard_normal((L, d, d)) * 0.1).astype(f32)
    out["pipe_x"] = rng.standard_normal((PIPE_M, 4, d)).astype(f32)
    # the MoE layer's leaves at the smoke widths (moe_init's shapes and
    # scales)
    E, dm, f = 8, 128, 64
    out["ep_router"] = (rng.standard_normal((dm, E)) / np.sqrt(dm)).astype(f32)
    for k, shape, std in (("wi", (E, dm, f), dm**-0.5),
                          ("wg", (E, dm, f), dm**-0.5),
                          ("wo", (E, f, dm), f**-0.5),
                          ("shared_wi", (dm, f), dm**-0.5),
                          ("shared_wg", (dm, f), dm**-0.5),
                          ("shared_wo", (f, dm), f**-0.5)):
        out[f"ep_{k}"] = (rng.standard_normal(shape) * std).astype(f32)
    # tokens leaning towards expert 0, so that the smoke capacity drops
    # pairs, and a different number on each shard
    w0 = out["ep_router"][:, 0]
    out["ep_x"] = (rng.standard_normal((*EP_SHAPE, dm))
                   + w0 / np.linalg.norm(w0)).astype(f32)
    out["ep_ct"] = rng.standard_normal((*EP_SHAPE, dm)).astype(f32)
    out["place_x"] = rng.standard_normal((8, 4, 6)).astype(f32)
    out["place_y"] = rng.standard_normal((4, 6, 2)).astype(f32)
    return out


def ep_params(inp: dict) -> dict:
    p = {k[3:]: inp[k] for k in inp if k.startswith("ep_")
         and k not in ("ep_x", "ep_router")}
    p["router"] = {"w": inp["ep_router"]}
    return p


def tree_to_torch(tree):
    import torch

    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _schedules(n: int, kind: str) -> dict:
    from repro_torch.dist import (alltoall_schedule, dp_broadcast_schedule,
                                  ring_alltoall_schedule,
                                  ring_broadcast_schedule)

    out = {}
    for algo in ALGOS:
        if kind == "bcast":
            out[algo] = (ring_broadcast_schedule(n) if algo == "ring" else
                         dp_broadcast_schedule(n, algo, device="cpu"))
        else:
            out[algo] = (ring_alltoall_schedule(n) if algo == "ring" else
                         alltoall_schedule(n, algo, device="cpu"))
    return out


def _executors(inp, meshes, rank) -> dict:
    import torch

    from repro_torch.dist import apply_alltoall_schedule, apply_schedule

    out = {}
    for n, (mesh, axis) in zip(EXEC_NS, ((meshes["d8"], "data"),
                                         (meshes["dm"], "model"))):
        me = mesh.get_local_rank(axis)
        for kind, fn in (("bcast", apply_schedule),
                         ("a2a", apply_alltoall_schedule)):
            for algo, sched in _schedules(n, kind).items():
                x = torch.from_numpy(inp[f"{kind}_x{n}"][me]).requires_grad_()
                y = fn(x, sched, mesh, axis)
                y.backward(torch.from_numpy(inp[f"{kind}_ct{n}"][me]))
                out[f"{kind}{n}_{algo}_y"] = y.detach().numpy()
                out[f"{kind}{n}_{algo}_dx"] = x.grad.numpy()
    # bytes cross bit for bit: a bf16 and an int8 all-to-all
    sched = _schedules(8, "a2a")["DPM"]
    me = meshes["d8"].get_local_rank("data")
    for dt in (torch.bfloat16, torch.int8):
        src = (torch.arange(8 * 8 * 6) % 251 - 125).reshape(8, 8, 6).to(dt)
        got = apply_alltoall_schedule(src[me], sched, meshes["d8"], "data")
        want = src[:, me]
        out[f"a2a_bytes_{dt}"] = np.asarray(bool(torch.equal(got, want)))
    return out


def _compress(inp, mesh, rank) -> dict:
    import torch

    from repro_torch.dist import compressed_psum
    from repro_torch.dist.compress import _quantize_int8

    out = {}
    for length in COMPRESS_LENGTHS:
        g = torch.from_numpy(inp[f"comp_g{length}"][rank])
        s1, e1 = compressed_psum(g, torch.zeros_like(g), mesh, "data")
        s2, e2 = compressed_psum(g, e1, mesh, "data")
        v = torch.nn.functional.pad(g, (0, (-length) % N_RANKS))
        q, scale = _quantize_int8(v.reshape(N_RANKS, -1))
        out.update({f"comp{length}_{k}": t.numpy() for k, t in (
            ("s1", s1), ("e1", e1), ("s2", s2), ("e2", e2), ("q", q),
            ("scale", scale))})
    return out


def _pipe_layer(w, h):
    import torch

    return torch.tanh(h @ w)


def _pipeline(inp, mesh) -> dict:
    import torch

    from repro_torch.dist import pipeline_apply

    S, L = PIPE_S, PIPE_L
    sp = torch.from_numpy(inp["pipe_w"]).reshape(
        S, L // S, PIPE_D, PIPE_D).requires_grad_()
    x = torch.from_numpy(inp["pipe_x"]).requires_grad_()
    y = pipeline_apply(_pipe_layer, sp, x, mesh, axis="pipe")
    (y**2).sum().backward()
    stage = mesh.get_local_rank("pipe")
    try:
        pipeline_apply(_pipe_layer, sp.detach()[:2], x.detach(), mesh,
                       axis="pipe")
        err = ""
    except ValueError as e:
        err = str(e)
    return {"pipe_y": y.detach().numpy(),
            "pipe_dw_stage": sp.grad[stage].numpy(),
            "pipe_dw_others_zero": np.asarray(bool(
                sp.grad[torch.arange(S) != stage].eq(0).all())),
            "pipe_dx": x.grad.numpy(), "pipe_err": np.asarray(err)}


class _Counts:
    """Counts the p2p batches and all-to-alls a call posts."""

    def __init__(self, dist):
        self.dist, self.p2p, self.a2a = dist, 0, 0
        self._b, self._a = dist.batch_isend_irecv, dist.all_to_all_single

    def __enter__(self):
        def b(ops):
            self.p2p += 1
            return self._b(ops)

        def a(*args, **kw):
            self.a2a += 1
            return self._a(*args, **kw)

        self.dist.batch_isend_irecv, self.dist.all_to_all_single = b, a
        return self

    def __exit__(self, *exc):
        self.dist.batch_isend_irecv = self._b
        self.dist.all_to_all_single = self._a


def _ep(inp, mesh, rank) -> dict:
    import torch
    import torch.distributed as dist

    import repro_torch.dist.ep as ep
    from repro_torch.dist import alltoall_schedule
    from repro_torch.models.moe import moe_apply_dense

    p = tree_to_torch(ep_params(inp))
    x = torch.from_numpy(inp["ep_x"])
    out = {}
    me = mesh.get_local_rank("model")
    sched = alltoall_schedule(4, "DPM", device="cpu")
    mine = sum(any(me in pair for pair in rnd) for rnd in sched.rounds)
    for cf in EP_CFS:
        cfg = ep_cfg(cf)
        keeps = []
        real = ep.dispatch_indices

        def rec(ids, m, cap):
            slot, keep = real(ids, m, cap)
            keeps.append(keep)
            return slot, keep

        ep.dispatch_indices = rec
        try:
            with _Counts(dist) as c:
                y, aux = ep.moe_apply_ep(p, x, cfg, mesh)
        finally:
            ep.dispatch_indices = real
        yd, auxd = moe_apply_dense(p, x, cfg)
        out.update({f"ep{cf}_y": y.numpy(), f"ep{cf}_aux": aux.numpy(),
                    f"ep{cf}_dense_y": yd.numpy(),
                    f"ep{cf}_dense_aux": auxd.numpy(),
                    f"ep{cf}_keep": keeps[0].numpy(),
                    f"ep{cf}_p2p": np.asarray(c.p2p),
                    f"ep{cf}_a2a": np.asarray(c.a2a)})
    # gradients through the exchange, the row shards and the gather: every
    # rank's loss is the same, so x's gradient is the dense path's
    cfg = ep_cfg(EP_CFS[0])
    ct = torch.from_numpy(inp["ep_ct"])
    for name, fn in (("ep", lambda xx: ep.moe_apply_ep(p, xx, cfg, mesh)),
                     ("dense", lambda xx: moe_apply_dense(p, xx, cfg))):
        xx = x.clone().requires_grad_()
        (fn(xx)[0] * ct).sum().backward()
        out[f"ep_dx_{name}"] = xx.grad.numpy()
    out["ep_rounds"] = np.asarray(sched.num_rounds)
    out["ep_my_rounds"] = np.asarray(mine)
    return out


def _ep_prefill(mesh) -> dict:
    import torch

    from repro_torch.models import RunConfig, model_init, prefill
    from repro_torch.shardctx import clear_ctx, set_ctx

    cfg = ep_cfg(EP_CFS[0])  # no drops: EP equals dense up to f32 order
    run = RunConfig(moe_impl="ep", activations_dtype="float32")
    params, _ = model_init(0, cfg, run, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, EP_SHAPE))
    dense, _ = prefill(params, {"tokens": toks}, cfg, run)
    set_ctx(mesh)
    try:
        got, _ = prefill(params, {"tokens": toks}, cfg, run)
    finally:
        clear_ctx()
    return {"prefill_ep": got.numpy(), "prefill_dense": dense.numpy()}


def _placements(inp, meshes) -> dict:
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import to_placements
    from repro_torch.shardctx import clear_ctx, constrain, set_ctx

    out = {}
    for i, (name, shape, spec) in enumerate(PLACE_CASES):
        mesh = meshes[name]
        x = torch.from_numpy(inp["place_x" if shape == (8, 4, 6)
                                 else "place_y"])
        dt = distribute_tensor(x, mesh, to_placements(spec, mesh))
        out[f"place{i}"] = dt.to_local().numpy()
    # shardctx.constrain: a DTensor redistributes to its axes' spec, a
    # plain tensor comes back as it is
    mesh = meshes["dm"]
    h = torch.from_numpy(inp["place_x"]).reshape(8, 24)
    set_ctx(mesh)
    try:
        rep = distribute_tensor(h, mesh, [Replicate(), Replicate()])
        out["constrain"] = constrain(rep, ("batch", "mlp")).to_local().numpy()
        out["constrain_plain"] = np.asarray(
            constrain(h, ("batch", "mlp")) is h)
    finally:
        clear_ctx()
    return out


def hang(rank: int) -> None:
    """Rank 1 waits on a message rank 0 never sends."""
    import time

    import torch
    import torch.distributed as dist

    if rank == 1:
        dist.recv(torch.empty(1), src=0)
    time.sleep(60)


def fail(rank: int) -> None:
    import torch
    import torch.distributed as dist

    if rank == 0:
        raise RuntimeError("planted failure")
    dist.recv(torch.empty(1), src=0)


def port_rank(rank: int, npz: str) -> dict:
    """Every case on this rank of eight CPU gloo ranks."""
    from repro_torch.launch.mesh import make_mesh

    inp = dict(np.load(npz))
    meshes = {"d8": make_mesh((8,), ("data",), "cpu"),
              "dm": make_mesh((2, 4), ("data", "model"), "cpu"),
              "dp": make_mesh((2, 4), ("data", "pipe"), "cpu"),
              "pdm": make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")}
    meshes["sub"] = meshes["pdm"]["data", "model"]
    out = {}
    out.update(_executors(inp, meshes, rank))
    out.update(_compress(inp, meshes["d8"], rank))
    out.update(_pipeline(inp, meshes["dp"]))
    out.update(_ep(inp, meshes["dm"], rank))
    out.update(_ep_prefill(meshes["dm"]))
    out.update(_placements(inp, {"pdm": meshes["pdm"],
                                 "dm": meshes["sub"]}))
    return out
