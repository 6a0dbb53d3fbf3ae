"""The port's side of ``tests/test_torch_serve_tp.py`` on gloo ranks.

``mesh_ranks`` (and ``count_ranks``, for ``tests/test_torch_dryrun.py``)
runs on four CPU ranks spawned by ``launch.mesh.spawn_ranks`` and returns
plain Python and numpy. This
module imports no JAX: the ranks load it by name, and the test process
runs ``serve`` in one process for the comparison.
"""
from __future__ import annotations

import numpy as np

NAMES = ("smollm-135m", "stablelm-1.6b", "starcoder2-7b", "qwen1.5-32b",
         "musicgen-medium", "qwen2-vl-72b", "moonshot-v1-16b-a3b",
         "deepseek-v2-236b", "mamba2-1.3b", "hymba-1.5b")
# the reference's jitted prefill and decode cover these
REF_NAMES = ("smollm-135m", "moonshot-v1-16b-a3b", "deepseek-v2-236b",
             "hymba-1.5b")
# int8 KV caches: a full-attention cache, and hymba's ring beside its
# global layers
INT8_NAMES = ("smollm-135m", "hymba-1.5b")
# smollm's 6 q / 2 kv heads of 16 split mid-head over a 4-rank model axis
M4_NAME = "smollm-135m"
# f32 throughout, the caches f32 too; vocab_round=96 pads every smoke
# vocabulary (512 -> 576, 256 -> 288), so the padded columns fall in the
# last model block
RUN_KW = dict(params_dtype="float32", activations_dtype="float32",
              kv_cache_dtype="float32", vocab_round=96, attn_chunk_q=32,
              attn_chunk_k=32, remat="none")
# B = 4 rows (2 a data rank); a 70-token prompt wraps hymba's 64-slot ring
# in the prefill and the 6 decode steps write past it again; the caches of
# 76 positions split over 2 and over 4 model ranks
B, PROMPT, STEPS = 4, 70, 6
CACHE_LEN = PROMPT + STEPS
SEED = 0
# moonshot under moe_impl="ep" on the blocks
EP_NAME = "moonshot-v1-16b-a3b"
# init_caches on the mesh: every cache kind (GQA, ring, SSD, MLA, int8)
INIT_NAMES = ("hymba-1.5b", "deepseek-v2-236b")
# the dry run's smoke cells, counted on rank 0 here and on a fake world
COUNT_CELLS = (("smollm-135m", "train"), ("moonshot-v1-16b-a3b", "prefill"),
               ("hymba-1.5b", "decode"))
COUNT_SHAPE = dict(seq_len=32, global_batch=4)


def run_config(**kw):
    from repro_torch.models import RunConfig

    return RunConfig(**dict(RUN_KW, **kw))


def inputs(cfg, seed: int = 5) -> dict:
    """The prompt and the teacher-forced decode inputs, seeded."""
    rng = np.random.default_rng(seed)
    n = PROMPT + STEPS
    if cfg.embed_input == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    return {"frames": rng.standard_normal((B, n, cfg.d_model))
            .astype(np.float32)}


def _flat(caches) -> dict:
    from repro_torch.models.layers import tree_flatten

    return {f"{g}/{i}/{path}": t.detach().clone().numpy()
            for g, layers in caches.items() for i, layer in enumerate(layers)
            for path, t in tree_flatten(layer)}


def serve(params, cfg, run, inp: dict) -> dict:
    """A prefill of the prompt and ``STEPS`` teacher-forced decode steps:
    the logits of each, the caches after the prefill and after the last
    step (``{group/layer/leaf: array}``)."""
    import torch

    from repro_torch.models import decode_step, prefill

    key = "tokens" if "tokens" in inp else "frames"
    seq = torch.from_numpy(inp[key])
    logits, caches = prefill(params, {key: seq[:, :PROMPT]}, cfg, run,
                             cache_len=CACHE_LEN)
    out = {"logits": [logits.numpy()], "prefill_caches": _flat(caches)}
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = decode_step(
            params, caches, {key: seq[:, pos:pos + 1], "pos": pos}, cfg, run)
        out["logits"].append(logits.numpy())
    out["logits"] = np.stack(out["logits"])
    out["caches"] = _flat(caches)
    return out


def whole_params(name: str, run):
    from repro_torch.configs import SMOKES
    from repro_torch.models import model_init

    return model_init(SEED, SMOKES[name], run, device="cpu")


def blocks(params, specs, mesh):
    """This rank's ``tree_shardings`` blocks of a parameter tree."""
    from repro_torch.dist.sharding import (mesh_coords, shard_slices,
                                           tree_shardings)
    from repro_torch.models.layers import tree_map

    coords = mesh_coords(mesh)
    return tree_map(lambda t, spec: t[shard_slices(spec, t.shape, mesh,
                                                   coords)].clone(),
                    params, tree_shardings(specs, params, mesh))


def ep_cfg():
    """moonshot's smoke config at a capacity factor that drops nothing,
    per ``dist.ep`` shard or over the whole batch."""
    import dataclasses

    from repro_torch.configs import SMOKES

    cfg = SMOKES[EP_NAME]
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def served_on(name: str, mesh, cfg=None, **run_kw) -> dict:
    from repro_torch.configs import SMOKES
    from repro_torch.shardctx import clear_ctx, set_ctx

    cfg = cfg or SMOKES[name]
    run = run_config(**run_kw)
    params, specs = whole_params(name, run)
    mine = blocks(params, specs, mesh)
    set_ctx(mesh, blocks=True)
    try:
        return serve(mine, cfg, run, inputs(cfg))
    finally:
        clear_ctx()


def init_blocks(mesh) -> tuple[dict, str]:
    """``init_caches`` on the mesh: per configuration (f32 and int8) the
    shapes of this rank's leaves and of their ``CACHE_RULES`` blocks of
    the whole caches; and the error of a length ``model`` does not
    divide."""
    from repro_torch.configs import SMOKES
    from repro_torch.dist.sharding import (CACHE_RULES, mesh_coords,
                                           shard_slices, spec_for_shape)
    from repro_torch.models import init_caches
    from repro_torch.models.layers import tree_flatten
    from repro_torch.models.model import cache_axes
    from repro_torch.shardctx import clear_ctx, set_ctx

    coords = mesh_coords(mesh)
    out = {}
    for name in INIT_NAMES:
        for kv in ("float32", "int8"):
            cfg, run = SMOKES[name], run_config(kv_cache_dtype=kv)
            whole = init_caches(cfg, run, B, CACHE_LEN, device="cpu")
            axes = cache_axes(cfg, run)
            want = {}
            for g, layers in whole.items():
                ax = dict(tree_flatten(axes[g]))
                for i, layer in enumerate(layers):
                    for path, t in tree_flatten(layer):
                        spec = spec_for_shape(ax[path][1:], t.shape, mesh,
                                              CACHE_RULES)
                        sl = shard_slices(spec, t.shape, mesh, coords)
                        want[f"{g}/{i}/{path}"] = tuple(
                            x.stop - x.start for x in sl)
            set_ctx(mesh, blocks=True)
            try:
                mine = init_caches(cfg, run, B, CACHE_LEN, device="cpu")
            finally:
                clear_ctx()
            got = {f"{g}/{i}/{path}": tuple(t.shape)
                   for g, layers in mine.items()
                   for i, layer in enumerate(layers)
                   for path, t in tree_flatten(layer) if not t.any()}
            out[f"{name}/{kv}"] = (got, want)
    set_ctx(mesh, blocks=True)
    try:
        init_caches(SMOKES["smollm-135m"], run_config(), B, CACHE_LEN - 1,
                    device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    finally:
        clear_ctx()
    return out, refused


def count_shape(kind: str):
    from repro_torch.models.config import ShapeConfig

    return ShapeConfig(f"smoke_{kind}", kind, **COUNT_SHAPE)


def counted(mesh) -> dict:
    """The dry run's counts of ``COUNT_CELLS`` on this rank's real
    tensors."""
    from repro_torch.configs import SMOKES
    from repro_torch.launch.dryrun import measure

    return {f"{name}/{kind}": measure(SMOKES[name], count_shape(kind), mesh,
                                      device="cpu")["counts"]
            for name, kind in COUNT_CELLS}


def mesh_ranks(rank: int) -> dict:
    """Every configuration served on a (2, 2) ``("data", "model")`` mesh,
    the int8 runs, smollm on a (4,) ``model`` mesh, moonshot under
    ``moe_impl="ep"`` and ``init_caches`` on the (2, 2) mesh."""
    from repro_torch.dist.sharding import mesh_coords
    from repro_torch.launch.mesh import make_mesh

    dm = make_mesh((2, 2), ("data", "model"), "cpu")
    m4 = make_mesh((4,), ("model",), "cpu")
    out = {name: served_on(name, dm) for name in NAMES}
    for name in INT8_NAMES:
        out[f"{name}/int8"] = served_on(name, dm, kv_cache_dtype="int8")
    out["m4"] = served_on(M4_NAME, m4)
    out["ep"] = served_on(EP_NAME, dm, cfg=ep_cfg(), moe_impl="ep")
    out["init"], out["init_refused"] = init_blocks(dm)
    out["coords"] = {"dm": mesh_coords(dm), "m4": mesh_coords(m4)}
    return out


def count_ranks(rank: int) -> dict:
    """The dry run's counts of ``COUNT_CELLS`` on a (2, 2) mesh of real
    gloo ranks (``tests/test_torch_dryrun.py``)."""
    from repro_torch.launch.mesh import make_mesh

    return counted(make_mesh((2, 2), ("data", "model"), "cpu"))
