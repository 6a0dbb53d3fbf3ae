"""Ambient sharding context. Twin of ``repro.shardctx``.

The launcher sets a mesh (and optionally a rule table) before running the
model; without a context every call is a no-op, so single-process tests
and one-card runs are unaffected. Readers: ``models.blocks._moe_ffn``
takes the expert-parallel path (``dist.ep``) under ``moe_impl="ep"`` when
a mesh is set, and ``constrain`` redistributes a ``DTensor`` to the spec
its logical axes resolve to. The port's models run on rank-local tensors,
which ``constrain`` returns as they are, and no model calls it.

A third entry holds a ``dist.comm.TensorParallel`` for the span of a step
on a mesh, which the models read through ``tensor_parallel`` to run on
their ``model`` blocks of the parameters and on this rank's rows of the
batch: training sets it for a step's forward and backward
(``training_on``), serving for a prefill or a decode step
(``serving_on``) when the mesh was set with ``blocks=True``.
Serving on a mesh set without ``blocks`` keeps every parameter whole on
every rank (the expert-parallel MoE layers of ``moe_impl="ep"`` aside).
Outside both spans the models read the one-rank view,
``dist.comm.ONE_RANK``.

Standalone module (not inside ``repro_torch.dist``) to avoid import
cycles; the resolver is imported at call time.
"""
from __future__ import annotations

import contextlib
from typing import Any

_CTX: dict[str, Any] = {"mesh": None, "rules": None, "blocks": False,
                        "tp": None, "span": None}


def set_ctx(mesh, rules=None, *, blocks: bool = False) -> None:
    """Set the mesh (and rule table). ``blocks``: serving's entry points
    (``models.model.prefill``, ``init_caches``, ``decode_step``) take and
    return this rank's blocks of the parameters and caches and run under
    ``serving_on``."""
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules
    _CTX["blocks"] = bool(blocks) and mesh is not None


def clear_ctx() -> None:
    set_ctx(None, None)
    _CTX["tp"] = None
    _CTX["span"] = None


def serving_blocks() -> bool:
    """Whether serving runs on the rank's blocks of the ``shardctx``
    mesh (``set_ctx(..., blocks=True)``)."""
    return _CTX["blocks"]


def tensor_parallel():
    """The step's ``dist.comm.TensorParallel``; outside training on a mesh
    ``dist.comm.ONE_RANK``, whose operators are the identity."""
    if _CTX["tp"] is not None:
        return _CTX["tp"]
    from .dist.comm import ONE_RANK

    return ONE_RANK


def training_on_mesh() -> bool:
    """Whether a training step on a mesh's ranks is running
    (``training_on``)."""
    return _CTX["span"] == "train"


def serving_on_mesh() -> bool:
    """Whether serving on a mesh's ranks is running (``serving_on``)."""
    return _CTX["span"] == "serve"


@contextlib.contextmanager
def _span(tp, span: str):
    prev = _CTX["tp"], _CTX["span"]
    _CTX["tp"], _CTX["span"] = tp, span
    try:
        yield tp
    finally:
        _CTX["tp"], _CTX["span"] = prev


def training_on(tp):
    """``tensor_parallel()`` is ``tp`` inside the block (a training
    step)."""
    return _span(tp, "train")


def serving_on(tp):
    """``tensor_parallel()`` is ``tp`` inside the block (a prefill or a
    decode step on the rank's blocks)."""
    return _span(tp, "serve")


def constrain(x, axes: tuple):
    """Redistribute a ``DTensor`` by logical axes (the reference's
    ``with_sharding_constraint``); a no-op without a mesh or on a plain
    (rank-local) tensor."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from .dist.sharding import spec_for_shape, to_placements

    spec = spec_for_shape(axes, x.shape, mesh, _CTX["rules"])
    return x.redistribute(mesh, to_placements(spec, mesh))
