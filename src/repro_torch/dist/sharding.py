"""Logical-axis -> mesh-axis sharding rules. Twin of ``repro.dist.sharding``.

Every parameter/activation/cache array of the reference's models carries a
tuple of logical axis names. This module maps those names onto mesh axes
through *rule tables*: ``rules[logical] = (candidate, ...)`` where each
candidate is a tuple of mesh axes to co-shard that dimension over.
Candidates are tried in order (lookup precedence) and one is taken iff

* every mesh axis of the candidate exists in the mesh (so ``("pod",
  "data")`` naturally degrades to the ``("data",)`` fallback on a
  single-pod mesh),
* none of its mesh axes is already used by an earlier dimension of the
  same array (a mesh axis can shard at most one dim),
* the product of the candidate's axis sizes is > 1 and divides the dim
  (shape-aware calls only) — otherwise the dim falls back to replication.

``zero1_shardings`` layers ZeRO-1 on top: each optimizer-state leaf gains
one extra shard over the free data axes.

A spec is the reference's ``PartitionSpec`` read as a tuple: one entry per
tensor dim, ``None``, a mesh axis name or a tuple of names. The builders
read only the mesh's axis names and sizes, from a ``DeviceMesh`` or from
``abstract_mesh`` (no process group); ``to_placements`` turns a spec into
the DTensor placements of a ``DeviceMesh``, and ``shard_slices`` into the
block of a tensor that the ranks at given mesh coordinates hold (the
reference's ``devices_indices_map``; ``mesh_coords`` reads a rank's own).
Spec trees are nested dicts whose leaves are logical-axis tuples; a shapes
tree holds tensors (meta tensors will do) or shape tuples at the same keys.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# Rule tables.  Values are ordered candidate tuples; each candidate is the
# tuple of mesh axes that dimension shards over.  Absent names (and None
# placeholder entries in axis tuples) replicate.
Rules = dict[str, tuple[tuple[str, ...], ...]]

_DATA = (("pod", "data"), ("data",))
_MODEL = (("model",),)

DEFAULT_RULES: Rules = {
    "batch": _DATA,
    "seq": (),
    "embed": (),
    "heads": _MODEL,
    "kv_heads": _MODEL,
    "head_dim": (),
    "mlp": _MODEL,
    "vocab": _MODEL,
    "experts": _MODEL,
    "expert_mlp": (),
    "layers": (),
    "state": (),
    "conv": (),
    "qk_rope": (),
    "kv_lora": (),
    "q_lora": (),
}

# Sequence parallelism: the residual stream's seq dim takes the model axis;
# a later dim wanting "model" (mlp/vocab) then replicates because the axis
# is used.
SEQ_RULES: Rules = {**DEFAULT_RULES, "seq": _MODEL}

# Decode caches: batch over the data axes, seq over model; head dims
# replicate.
CACHE_RULES: Rules = {
    **DEFAULT_RULES,
    "seq": _MODEL,
    "heads": (),
    "kv_heads": (),
}


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, as a ``DeviceMesh`` exposes them,
    with no process group behind it."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def abstract_mesh(*axes: tuple[str, int]) -> AbstractMesh:
    """Device-free mesh of (name, size) axes for planning shardings."""
    return AbstractMesh(tuple(n for n, _ in axes), tuple(s for _, s in axes))


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _assign(
    axes: tuple, shape: tuple | None, mesh, rules: Rules | None
) -> list:
    """Per-dimension mesh-axis assignment (the engine behind every public
    helper).  ``shape`` entries of None skip the divisibility check."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = _axis_sizes(mesh)
    if shape is None:
        shape = (None,) * len(axes)
    used: set[str] = set()
    entries: list = []
    for name, dim in zip(axes, shape):
        assign = None
        for cand in rules.get(name, ()) if name is not None else ():
            if not cand or any(a not in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            n = math.prod(sizes[a] for a in cand)
            if n <= 1:
                continue
            if dim is not None and dim % n != 0:
                continue
            assign = cand[0] if len(cand) == 1 else cand
            used.update(cand)
            break
        entries.append(assign)
    return entries


def spec_for_shape(axes: tuple, shape, mesh, rules: Rules | None = None) -> tuple:
    """Shape-aware spec for one array: logical ``axes`` resolved through
    ``rules`` with divisibility fallback to replication."""
    return tuple(_assign(axes, tuple(shape), mesh, rules))


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _map(fn, specs, *rest):
    """``fn`` over the logical-axis tuples of a spec tree and the entries
    of ``rest`` at the same keys."""
    if isinstance(specs, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return fn(specs, *rest)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_shardings(specs, shapes, mesh, rules: Rules | None = None):
    """Spec tree: ``specs`` leaves are logical-axis tuples, ``shapes`` the
    matching tensors (or shape tuples)."""
    return _map(lambda axes, s: spec_for_shape(axes, _shape(s), mesh, rules),
                specs, shapes)


def param_shardings(specs, mesh, shapes=None, rules: Rules | None = None):
    """Parameter specs from logical axes alone.

    Without ``shapes`` the divisibility check is skipped (structural
    mapping); pass ``shapes`` for the shape-checked variant (==
    ``tree_shardings``).
    """
    if shapes is not None:
        return tree_shardings(specs, shapes, mesh, rules)
    return _map(lambda axes: tuple(_assign(axes, None, mesh, rules)), specs)


def _flat_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def zero1_shardings(specs, shapes, mesh, rules: Rules | None = None):
    """ZeRO-1 optimizer-state specs: the parameter spec plus one extra
    shard over the free data axes per leaf.

    The first still-replicated dim whose size is divisible by the full free
    data-parallel degree takes it (then single data axes are tried in
    order); a leaf with no divisible dim keeps the plain parameter spec.
    """
    sizes = _axis_sizes(mesh)
    data_axes = tuple(
        a for a in ("pod", "data") if a in sizes and sizes[a] > 1
    )

    def one(axes, s):
        shape = _shape(s)
        entries = _assign(axes, shape, mesh, rules)
        used = {a for e in entries for a in _flat_axes(e)}
        free = tuple(a for a in data_axes if a not in used)
        cands = [free] if free else []
        if len(free) > 1:  # then single axes, biggest shard degree first
            cands += [(a,) for a in sorted(free, key=lambda a: -sizes[a])]
        done = False
        for cand in cands:
            if done:
                break
            n = math.prod(sizes[a] for a in cand)
            for i, e in enumerate(entries):
                if e is None and shape[i] % n == 0:
                    entries[i] = cand[0] if len(cand) == 1 else cand
                    done = True
                    break
        return tuple(entries)

    return _map(one, specs, shapes)


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` shards over, ``Replicate()`` elsewhere. A dim
    co-sharded over several axes (``("pod", "data")``) takes ``Shard(d)`` on
    each, the major axis first; the axes must come in the mesh's order,
    which is the only order placements express."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        dims = [names.index(a) for a in _flat_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r}: axes out of the mesh's "
                             f"order {tuple(names)}")
        for m in dims:
            out[m] = Shard(d)
    return out


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate on every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def shard_slices(spec: tuple, shape, mesh, coords: dict[str, int]) -> tuple:
    """The block of a tensor of ``shape`` under ``spec`` that the ranks at
    mesh ``coords`` hold, one ``slice`` a dim: a dim sharded over axes
    ``(a, b)`` is cut into ``size(a) * size(b)`` equal blocks, and block
    ``coord(a) * size(b) + coord(b)`` is theirs (the major axis first, as
    the reference's ``NamedSharding`` lays them out). A dim that the
    shards do not divide raises: the spec builders never shard one."""
    sizes = _axis_sizes(mesh)
    out = []
    for d, dim in enumerate(shape):
        axes = _flat_axes(spec[d] if d < len(spec) else None)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"spec {spec!r}: dim {d} of {tuple(shape)} does "
                             f"not split into {n} shards")
        block = dim // n
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)
