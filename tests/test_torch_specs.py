"""The models' logical-axis spec trees and ``launch.specs`` against the
reference, in process (the reference's cells build on a
``jax.sharding.AbstractMesh``, the port's on ``dist.sharding``'s; neither
needs a device).

- ``model_init``'s spec tree (``abstract_init``) equals the reference's
  for all ten configurations at full width: the same keys and every
  logical-axis tuple equal, one axis a tensor dim.
- ``build_cell`` for every configuration, shape of ``SHAPES`` and the
  pod (16 x 16 ``("data", "model")``) and multi-pod (2 x 16 x 16
  ``("pod", "data", "model")``) meshes: ``make_run_config`` equal; every
  argument leaf's shape and dtype equal (meta tensors against
  ``ShapeDtypeStruct``); every in and out spec equal (spec tuples against
  ``NamedSharding.spec``); ``donate``, ``kind`` and ``meta`` equal.
- ``param_counts`` and ``model_flops`` equal to the integer for every
  configuration and shape.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import RunConfig as JaxRun
from repro.models import abstract_init as jax_abstract_init
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.dist import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import RunConfig, abstract_init

MESHES = {"pod": (("data", 16), ("model", 16)),
          "multi_pod": (("pod", 2), ("data", 16), ("model", 16))}


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _is_leaf(x) -> bool:
    """A ``NamedSharding``, an axes tuple or ``None`` (an unset
    sharding)."""
    return (x is None or isinstance(x, jax.sharding.NamedSharding)
            or (type(x) is tuple
                and all(e is None or isinstance(e, str) for e in x)))


def _jax_flat(tree) -> dict:
    """``{path: leaf}`` of a reference tree (``_is_leaf``)."""
    return {"/".join(_key(k) for k in path): x for path, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_leaf)[0]}


def _port_flat(tree, prefix: str = "") -> dict:
    """The same paths over the port's trees: tuples of trees (call order),
    ``TrainState`` fields and dicts; a spec tuple or a tensor a leaf."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {p: x for k in sorted(tree)
                for p, x in _port_flat(tree[k], join(k)).items()}
    if hasattr(tree, "_fields"):
        return {p: x for f, part in zip(tree._fields, tree)
                for p, x in _port_flat(part, join(f)).items()}
    if isinstance(tree, list):
        return {p: x for i, part in enumerate(tree)
                for p, x in _port_flat(part, join(i)).items()}
    return {prefix: tree}


def _spec(x):
    """A reference sharding entry as the port writes it: ``None`` stays,
    a ``NamedSharding`` becomes its spec tuple."""
    return None if x is None else tuple(x.spec)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_spec_tree_matches_reference(name):
    _, want = jax_abstract_init(JAX_ARCHS[name], JaxRun())
    shapes, got = abstract_init(ARCHS[name], RunConfig())
    want, got, shapes = _jax_flat(want), _port_flat(got), _port_flat(shapes)
    assert got == want
    assert set(shapes) == set(got)
    for path, axes in got.items():
        assert isinstance(axes, tuple) and len(axes) == shapes[path].dim(), \
            path


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_cells_match_reference(name):
    for mesh_name, axes in MESHES.items():
        jm, tm = jsh.abstract_mesh(*axes), tsh.abstract_mesh(*axes)
        for shape in JAX_SHAPES:
            where = f"{name} {shape} {mesh_name}"
            want = jspecs.build_cell(JAX_ARCHS[name], JAX_SHAPES[shape], jm)
            got = tspecs.build_cell(ARCHS[name], SHAPES[shape], tm)
            assert dataclasses.asdict(got.run) == dataclasses.asdict(
                want.run), where
            assert dataclasses.asdict(
                tspecs.make_run_config(ARCHS[name], SHAPES[shape], tm)) == \
                dataclasses.asdict(jspecs.make_run_config(
                    JAX_ARCHS[name], JAX_SHAPES[shape], jm)), where
            assert (got.kind, got.donate, got.meta) == (
                want.kind, want.donate, want.meta), where
            wa, ga = _jax_flat(list(want.args)), _port_flat(list(got.args))
            assert set(ga) == set(wa), where
            for p, x in wa.items():
                assert tuple(ga[p].shape) == tuple(x.shape), (where, p)
                assert str(ga[p].dtype) == f"torch.{np.dtype(x.dtype)}", \
                    (where, p)
                assert ga[p].device.type == "meta"
            for field in ("in_shardings", "out_shardings"):
                ws = _jax_flat(list(getattr(want, field)))
                gs = _port_flat(list(getattr(got, field)))
                assert set(gs) == set(ws), (where, field)
                for p, x in ws.items():
                    assert gs[p] == _spec(x), (where, field, p)


def test_param_counts_and_model_flops_match_reference():
    run, jrun = RunConfig(), JaxRun()
    for name in JAX_ARCHS:
        assert tspecs.param_counts(ARCHS[name], run) == \
            jspecs.param_counts(JAX_ARCHS[name], jrun), name
        for shape in JAX_SHAPES:
            assert tspecs.model_flops(ARCHS[name], SHAPES[shape], run) == \
                jspecs.model_flops(JAX_ARCHS[name], JAX_SHAPES[shape],
                                   jrun), (name, shape)
    counts = tspecs.param_counts(ARCHS["deepseek-v2-236b"], run)
    assert 15e9 < counts["active"] < 35e9 < 200e9 < counts["total"] < 250e9
