"""Input and state stand-ins, with their shardings, for every cell of the
dry run. Twin of ``repro.launch.specs``.

Nothing is allocated: parameters, optimizer state, caches and batches are
tensors on ``torch.device("meta")`` (the reference's ``ShapeDtypeStruct``),
each paired with its spec tuple (the ``PartitionSpec`` of the reference's
``NamedSharding``, read as a tuple) that ``dist.sharding`` resolves on
``mesh``: a ``DeviceMesh`` or a ``sharding.AbstractMesh``, so a cell needs
no process group. On a ``DeviceMesh``, ``dist.sharding.to_placements``
turns a spec into DTensor placements. The parameters are the reference's
f32 tree (its ``model_init`` draws and keeps every leaf in f32); the caches
carry a leading "layers" dim per group, as the reference's ``init_caches``
stacks them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from ..dist.sharding import (
    CACHE_RULES,
    _axis_sizes,
    spec_for_shape,
    tree_shardings,
    zero1_shardings,
)
from ..models.blocks import block_init_cache
from ..models.config import ArchConfig, RunConfig, ShapeConfig
from ..models.layers import tree_leaves, tree_map
from ..models.model import abstract_init, cache_axes
from ..train.optim import TrainState

META = torch.device("meta")


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def make_run_config(cfg: ArchConfig, shape: ShapeConfig, mesh) -> RunConfig:
    """Per-cell execution config: remat for training, int8 KV when a bf16
    cache would not fit a chip (the reference's 11 GB a chip), chunked
    attention sized to the sequence."""
    kv_dtype = "bfloat16"
    if shape.kind == "decode":
        # estimate bf16 KV bytes/chip: batch over data axes, seq over model
        sizes = _axis_sizes(mesh)
        n_data = 1
        for a in ("pod", "data"):
            if a in sizes:
                n_data *= sizes[a]
        n_model = sizes.get("model", 1)
        b_local = max(1, shape.global_batch // n_data)
        if cfg.mla:
            per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
        layers_full = sum(
            c for k, c in cfg.layout if not k.endswith("_w") and k != "ssd"
        )
        gb = (b_local * (shape.seq_len / n_model) * per_tok * 2
              * layers_full / 1e9)
        if gb > 11.0:
            kv_dtype = "int8"
    return RunConfig(
        remat="block" if shape.kind == "train" else "none",
        attn_chunk_q=min(512, shape.seq_len),
        attn_chunk_k=min(1024, shape.seq_len),
        kv_cache_dtype=kv_dtype,
        zero1=True,
    )


@dataclass
class CellSpecs:
    kind: str  # train | prefill | decode
    args: tuple  # meta-tensor trees, in call order
    in_shardings: tuple  # spec-tuple trees, in call order
    out_shardings: Any  # None: left to the caller
    donate: tuple[int, ...]
    run: RunConfig
    meta: dict


def _params(cfg: ArchConfig, run: RunConfig):
    """``(shapes, specs)`` of the reference's f32 parameter tree."""
    return abstract_init(cfg, dataclasses.replace(run,
                                                  activations_dtype="float32"))


def _cache_shapes(cfg: ArchConfig, run: RunConfig, batch: int,
                  max_len: int) -> dict:
    """The decode caches of ``models.model.init_caches`` on ``meta``, each
    group's layers stacked on a leading dim."""
    return {
        f"g{gi}": tree_map(lambda t: t.new_empty((count, *t.shape)),
                           block_init_cache(kind, cfg, run, batch, max_len,
                                            META))
        for gi, (kind, count) in enumerate(cfg.layout)
    }


def _batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, run: RunConfig,
                 decode: bool):
    B = shape.global_batch
    S = 1 if decode else shape.seq_len
    specs: dict[str, Any] = {}
    shard: dict[str, Any] = {}
    if cfg.embed_input == "tokens":
        specs["tokens"] = _meta((B, S), torch.int32)
        shard["tokens"] = spec_for_shape(("batch", "seq"), (B, S), mesh)
    else:
        specs["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        shard["frames"] = spec_for_shape(("batch", "seq", "embed"),
                                         (B, S, cfg.d_model), mesh)
    if decode:
        specs["pos"] = _meta((), torch.int32)
        shard["pos"] = ()
    else:
        specs["labels"] = _meta((B, S), torch.int32)
        shard["labels"] = spec_for_shape(("batch", "seq"), (B, S), mesh)
    return specs, shard


def _run(cfg, shape, mesh, run_overrides) -> RunConfig:
    run = make_run_config(cfg, shape, mesh)
    if run_overrides:
        run = dataclasses.replace(run, **run_overrides)
    return run


def train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               run_overrides: dict | None = None) -> CellSpecs:
    run = _run(cfg, shape, mesh, run_overrides)
    pshapes, pspecs = _params(cfg, run)
    state_shapes = TrainState(step=_meta((), torch.int32), params=pshapes,
                              m=pshapes, v=pshapes)
    psh = (zero1_shardings(pspecs, pshapes, mesh) if run.zero1
           else tree_shardings(pspecs, pshapes, mesh))
    state_sh = TrainState(step=(), params=psh, m=psh, v=psh)
    bspec, bshard = _batch_specs(cfg, shape, mesh, run, decode=False)
    return CellSpecs(
        kind="train",
        args=(state_shapes, bspec),
        in_shardings=(state_sh, bshard),
        out_shardings=(state_sh, None),  # metrics: the caller's choice
        donate=(0,),
        run=run,
        meta={"tokens": shape.global_batch * shape.seq_len},
    )


def prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 run_overrides: dict | None = None) -> CellSpecs:
    run = _run(cfg, shape, mesh, run_overrides)
    pshapes, pspecs = _params(cfg, run)
    psh = tree_shardings(pspecs, pshapes, mesh)
    bspec, bshard = _batch_specs(cfg, shape, mesh, run, decode=False)
    bspec.pop("labels", None)
    bshard.pop("labels", None)
    # out: (last-token logits, caches)
    cshape = _cache_shapes(cfg, run, shape.global_batch, shape.seq_len)
    csh = tree_shardings(cache_axes(cfg, run), cshape, mesh, CACHE_RULES)
    return CellSpecs(
        kind="prefill",
        args=(pshapes, bspec),
        in_shardings=(psh, bshard),
        out_shardings=(None, csh),
        donate=(),
        run=run,
        meta={"tokens": shape.global_batch * shape.seq_len},
    )


def decode_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
                run_overrides: dict | None = None) -> CellSpecs:
    run = _run(cfg, shape, mesh, run_overrides)
    pshapes, pspecs = _params(cfg, run)
    psh = tree_shardings(pspecs, pshapes, mesh)
    cshape = _cache_shapes(cfg, run, shape.global_batch, shape.seq_len)
    csh = tree_shardings(cache_axes(cfg, run), cshape, mesh, CACHE_RULES)
    bspec, bshard = _batch_specs(cfg, shape, mesh, run, decode=True)
    return CellSpecs(
        kind="decode",
        args=(pshapes, cshape, bspec),
        in_shardings=(psh, csh, bshard),
        out_shardings=(None, csh),
        donate=(1,),
        run=run,
        meta={"tokens": shape.global_batch},
    )


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               run_overrides: dict | None = None) -> CellSpecs:
    if shape.kind == "train":
        return train_cell(cfg, shape, mesh, run_overrides)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh, run_overrides)
    return decode_cell(cfg, shape, mesh, run_overrides)


# ---------------------------------------------------------------------------
# model-FLOPs accounting (roofline's "useful compute")
# ---------------------------------------------------------------------------
def param_counts(cfg: ArchConfig, run: RunConfig) -> dict:
    pshapes, _ = _params(cfg, run)
    total = sum(t.numel() for t in tree_leaves(pshapes))
    active = total
    if cfg.moe:
        m = cfg.moe
        for gi, (kind, count) in enumerate(cfg.layout):
            if not kind.endswith("_moe"):
                continue
            g = pshapes[f"g{gi}"]["ffn"]
            routed = sum(g[k].numel() for k in ("wi", "wg", "wo"))
            active -= routed
            active += int(routed * m.top_k / m.n_experts)
    return {"total": total, "active": active}


def model_flops(cfg: ArchConfig, shape: ShapeConfig, run: RunConfig) -> float:
    """6 N_active D for training, 2 N_active D for inference forward."""
    n = param_counts(cfg, run)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


__all__ = [
    "CellSpecs", "build_cell", "decode_cell", "make_run_config",
    "model_flops", "param_counts", "prefill_cell", "train_cell",
]
