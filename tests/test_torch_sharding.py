"""The port's sharding rules (``repro_torch.dist.sharding``), ``cache_axes``
and mesh entry points against the reference, in process (no ranks).

- ``spec_for_shape`` equals ``repro.dist.sharding.spec_for_shape`` (its
  ``PartitionSpec`` read as a tuple) on seeded (logical axes, shape)
  samples under the three rule tables, on abstract meshes (16, 16),
  (2, 16, 16), (2, 4) and (4,);
- ``tree_shardings``, ``param_shardings`` (structural and shape-checked)
  and ``zero1_shardings`` equal the reference's on the reference's own
  ``abstract_init`` specs of smollm-135m and moonshot's smoke config, the
  port's meta-tensor parameters as shapes;
- ``models.model.cache_axes`` equals the reference's for all ten
  configurations, bf16 and int8 caches;
- ``to_placements`` refuses co-sharded axes out of the mesh's order, and
  ``launch.mesh`` refuses to build a mesh without a process group of its
  size (the reference's ``make_production_mesh`` raises without 256
  devices).
"""
import jax
import numpy as np
import pytest

import repro.dist.sharding as jsh
import repro_torch.dist.sharding as tsh
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SMOKES as JAX_SMOKES
from repro.models import RunConfig as JaxRunConfig
from repro.models.model import abstract_init as jax_abstract_init
from repro.models.model import cache_axes as jax_cache_axes
from repro_torch.configs import ARCHS, SMOKES
from repro_torch.models import RunConfig, abstract_init
from repro_torch.models.model import cache_axes

MESHES = (
    (("data", 16), ("model", 16)),
    (("pod", 2), ("data", 16), ("model", 16)),
    (("data", 2), ("model", 4)),
    (("model", 4),),
)
RULES = {"default": None, "seq": "SEQ_RULES", "cache": "CACHE_RULES"}
NAMES = tuple(jsh.DEFAULT_RULES) + (None, "unknown")
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512, 4096)


def _rules(pkg, key):
    return None if RULES[key] is None else getattr(pkg, RULES[key])


def _tree_equal(got, want, path=""):
    """Port spec tree (tuples) against the reference's (NamedSharding or
    PartitionSpec leaves)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    spec = getattr(want, "spec", want)
    assert got == tuple(spec), (path, got, spec)


def test_spec_for_shape_matches_reference():
    rng = np.random.default_rng(26)
    n = 0
    for axes_sizes in MESHES:
        jm = jsh.abstract_mesh(*axes_sizes)
        tm = tsh.abstract_mesh(*axes_sizes)
        for key in RULES:
            for _ in range(150):
                rank = int(rng.integers(1, 5))
                axes = tuple(NAMES[i] for i in rng.integers(0, len(NAMES),
                                                            rank))
                shape = tuple(int(DIMS[i]) for i in rng.integers(
                    0, len(DIMS), rank))
                want = jsh.spec_for_shape(axes, shape, jm, _rules(jsh, key))
                got = tsh.spec_for_shape(axes, shape, tm, _rules(tsh, key))
                assert got == tuple(want), (axes_sizes, key, axes, shape)
                n += 1
    assert n == 1800


def test_tree_param_zero1_shardings_match_reference():
    for name in ("smollm-135m", "moonshot-v1-16b-a3b"):
        jshapes, jspecs = jax_abstract_init(JAX_SMOKES[name], JaxRunConfig())
        tshapes, _ = abstract_init(SMOKES[name], RunConfig())
        for axes_sizes in MESHES[:3]:
            jm = jsh.abstract_mesh(*axes_sizes)
            tm = tsh.abstract_mesh(*axes_sizes)
            for key in RULES:
                jr, tr = _rules(jsh, key), _rules(tsh, key)
                _tree_equal(tsh.tree_shardings(jspecs, tshapes, tm, tr),
                            jsh.tree_shardings(jspecs, jshapes, jm, jr))
                _tree_equal(tsh.param_shardings(jspecs, tm, rules=tr),
                            jsh.param_shardings(jspecs, jm, rules=jr))
                _tree_equal(
                    tsh.param_shardings(jspecs, tm, tshapes, rules=tr),
                    jsh.param_shardings(jspecs, jm, jshapes, rules=jr))
                _tree_equal(tsh.zero1_shardings(jspecs, tshapes, tm, tr),
                            jsh.zero1_shardings(jspecs, jshapes, jm, jr))
        # the spec tree also takes shape tuples
        jm, tm = (jsh.abstract_mesh(*MESHES[2]), tsh.abstract_mesh(*MESHES[2]))
        as_tuples = jax.tree.map(lambda s: tuple(s.shape), jshapes)
        _tree_equal(tsh.zero1_shardings(jspecs, as_tuples, tm),
                    jsh.zero1_shardings(jspecs, jshapes, jm))


def test_cache_axes_match_reference():
    assert set(ARCHS) == set(JAX_ARCHS) and len(ARCHS) == 10
    for name in ARCHS:
        for kv in ("bfloat16", "int8"):
            got = cache_axes(ARCHS[name], RunConfig(kv_cache_dtype=kv))
            want = jax_cache_axes(JAX_ARCHS[name],
                                  JaxRunConfig(kv_cache_dtype=kv))
            assert got == want, (name, kv)


def test_placements_and_meshes_refuse_what_they_cannot_express():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    m = tsh.abstract_mesh(("pod", 2), ("data", 2), ("model", 2))
    assert tsh.to_placements((("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsh.to_placements((None,), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements((("data", "pod"),), m)
    for build in (make_production_mesh,
                  lambda: make_production_mesh(multi_pod=True),
                  lambda: make_mesh((2, 4), ("data", "model"), "cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            build()
