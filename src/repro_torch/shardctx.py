"""Ambient sharding context. Twin of ``repro.shardctx``.

The launcher sets a mesh (and optionally a rule table) before running the
model; without a context every call is a no-op, so single-process tests
and one-card runs are unaffected. Two readers: ``models.blocks._moe_ffn``
takes the expert-parallel path (``dist.ep``) under ``moe_impl="ep"`` when
a mesh is set, and ``constrain`` redistributes a ``DTensor`` to the spec
its logical axes resolve to. The port's models run on rank-local tensors,
which ``constrain`` returns as they are, and no model calls it.

Standalone module (not inside ``repro_torch.dist``) to avoid import
cycles; the resolver is imported at call time.
"""
from __future__ import annotations

from typing import Any

_CTX: dict[str, Any] = {"mesh": None, "rules": None}


def set_ctx(mesh, rules=None) -> None:
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules


def clear_ctx() -> None:
    set_ctx(None, None)


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
