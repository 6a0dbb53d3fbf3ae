"""Ambient sharding context. Twin of ``repro.shardctx``.

The launcher sets a mesh (and optionally a rule table) before running the
model; without a context every call is a no-op, so single-process tests
and one-card runs are unaffected. Two readers: ``models.blocks._moe_ffn``
takes the expert-parallel path (``dist.ep``) under ``moe_impl="ep"`` when
a mesh is set, and ``constrain`` redistributes a ``DTensor`` to the spec
its logical axes resolve to. The port's models run on rank-local tensors,
which ``constrain`` returns as they are, and no model calls it.

Training on a mesh sets a third entry for the span of a step's forward and
backward (``training_on``): a ``dist.comm.TensorParallel``, which the
models read through ``tensor_parallel`` to run on their ``model`` blocks
of the parameters and on this rank's rows of the batch. Serving never sets
it, and the models then read the one-rank view, ``dist.comm.ONE_RANK``.

Standalone module (not inside ``repro_torch.dist``) to avoid import
cycles; the resolver is imported at call time.
"""
from __future__ import annotations

import contextlib
from typing import Any

_CTX: dict[str, Any] = {"mesh": None, "rules": None, "tp": None}


def set_ctx(mesh, rules=None) -> None:
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules


def clear_ctx() -> None:
    set_ctx(None, None)
    _CTX["tp"] = None


def tensor_parallel():
    """The step's ``dist.comm.TensorParallel``; outside training on a mesh
    ``dist.comm.ONE_RANK``, whose operators are the identity."""
    if _CTX["tp"] is not None:
        return _CTX["tp"]
    from .dist.comm import ONE_RANK

    return ONE_RANK


def training_on_mesh() -> bool:
    """Whether a step on a mesh's ranks is running (``training_on``)."""
    return _CTX["tp"] is not None


@contextlib.contextmanager
def training_on(tp):
    """``tensor_parallel()`` is ``tp`` inside the block."""
    prev, _CTX["tp"] = _CTX["tp"], tp
    try:
        yield tp
    finally:
        _CTX["tp"] = prev


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
