"""``launch.dryrun``: rank 0's step on meta tensors under a fake process
group, against the reference's cells and against real ranks.

Each fake world runs in a subprocess of this file (``port`` mode; no
JAX), the reference's shardings and compile in two more (``ref512``: 512
forced host devices, shard shapes only, nothing compiled; ``ref4``: 4,
one compiled smoke cell), the real ranks through
``launch.mesh.spawn_ranks`` (``tests/torch_serve_tp_ranks.count_ranks``),
all at once.

- **(a) Full size**, stablelm ``train_4k``, moonshot ``prefill_32k``,
  deepseek ``decode_32k`` and mamba2 ``long_500k`` on the pod (256) and
  multi-pod (512) meshes: ``argument_size_in_bytes``,
  ``output_size_in_bytes`` and ``alias_size_in_bytes`` equal the bytes
  of device 0's shards under the reference's ``build_cell`` in/out
  shardings (``None``: whole; the outputs' shapes from ``jax.eval_shape``)
  and of its donated arguments; ``params_*`` and ``model_flops_*`` equal
  the reference's; every count is positive and the useful share at most
  1.
- **(b) Smoke size** on a fake (2, 2) world: for a smollm train, a
  moonshot prefill and a hymba decode cell, the flops, bytes and
  collectives by c10d operation and mesh axis equal what the same
  ``Counter`` counts on rank 0 of four real gloo ranks running the same
  cells on zeros: the dry run does what the ranks do.
- **(c)** The reference's ``launch.hlo.analyze`` flops of the smollm smoke
  train cell, compiled on 4 forced host devices, printed beside the
  port's; the port's useful share (model flops over counted flops) is at
  most 1.
- **(d)** ``sp`` refuses, naming ``SEQ_RULES``, through ``run_cell`` and
  through the CLI (a ``FAILURES`` report and exit code 1); a ``fake``
  group's axes stage nothing through the host.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_serve_tp_ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
FULL_CELLS = (("stablelm-1.6b", "train_4k"),
              ("moonshot-v1-16b-a3b", "prefill_32k"),
              ("deepseek-v2-236b", "decode_32k"),
              ("mamba2-1.3b", "long_500k"))
MESHES = ("pod", "multipod")
SMOKE_TRAIN = ("smollm-135m", "train")


# ------------------------------------------------------------- reference
def _ref_bytes(tmp: Path) -> None:
    """Device 0's shard bytes of every full cell's arguments, outputs and
    donated arguments under the reference's shardings; its parameter and
    model-flop counts."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import ARCHS, SHAPES
    from repro.launch.specs import build_cell, model_flops, param_counts
    from repro.models.model import decode_step, prefill
    from repro.train.step import build_train_step

    dev0 = jax.devices()[0]

    def shard_bytes(tree, shardings):
        leaves = jax.tree.leaves(tree)
        if shardings is None:
            shs = [None] * len(leaves)
        else:
            shs = jax.tree.leaves(shardings, is_leaf=lambda x: x is None)
            if len(shs) != len(leaves):  # a None sharding of a subtree
                shs = jax.tree.leaves(jax.tree.map(
                    lambda _, s: s, tree, shardings,
                    is_leaf=lambda x: x is None))
        total = 0
        for x, sh in zip(leaves, shs):
            shape = (x.shape if sh is None
                     else sh.shard_shape(x.shape))
            total += int(np.prod(shape, dtype=np.int64)) * x.dtype.itemsize
        return total

    out = {}
    for mesh_name in MESHES:
        shape = (2, 16, 16) if mesh_name == "multipod" else (16, 16)
        axes = ("pod", "data", "model") if mesh_name == "multipod" else (
            "data", "model")
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
        assert mesh.devices.flat[0] == dev0
        for arch, shape_name in FULL_CELLS:
            cfg, sh = ARCHS[arch], SHAPES[shape_name]
            cell = build_cell(cfg, sh, mesh)
            run = cell.run
            if cell.kind == "train":
                fn = build_train_step(cfg, run)
            elif cell.kind == "prefill":
                fn = lambda p, b: prefill(p, b, cfg, run)  # noqa: E731
            else:
                fn = lambda p, c, b: decode_step(p, c, b, cfg,  # noqa: E731
                                                 run)
            outs = jax.eval_shape(fn, *cell.args)
            osh = cell.out_shardings
            counts = param_counts(cfg, run)
            out[f"{arch}__{shape_name}__{mesh_name}"] = {
                "args": sum(shard_bytes(a, s) for a, s in
                            zip(cell.args, cell.in_shardings)),
                "outs": sum(shard_bytes(o, s) for o, s in zip(outs, osh)),
                "donated": sum(shard_bytes(cell.args[i],
                                           cell.in_shardings[i])
                               for i in cell.donate),
                "params_total": counts["total"],
                "params_active": counts["active"],
                "model_flops_global": model_flops(cfg, sh, run),
            }
    (tmp / "ref512.json").write_text(json.dumps(out))


def _ref_flops(tmp: Path) -> None:
    """The reference's ``hlo.analyze`` flops of the smollm smoke train
    cell compiled on a (2, 2) mesh of 4 host devices."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import SMOKES
    from repro.launch.hlo import analyze
    from repro.launch.specs import build_cell
    from repro.train.step import build_train_step

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    name, kind = SMOKE_TRAIN
    cell = build_cell(SMOKES[name], R.count_shape(kind), mesh)
    jitted = jax.jit(build_train_step(SMOKES[name], cell.run),
                     in_shardings=cell.in_shardings,
                     out_shardings=cell.out_shardings,
                     donate_argnums=cell.donate)
    compiled = jitted.lower(*cell.args).compile()
    (tmp / "ref4.json").write_text(json.dumps(
        {"flops": float(analyze(compiled.as_text())["flops"])}))


# ------------------------------------------------------------- port
def _port(world: str, tmp: Path) -> None:
    """One fake world's figures (no JAX): the full cells of a production
    mesh, or the smoke cells and refusals on (2, 2)."""
    import torch

    from repro_torch.launch import dryrun as D

    out = {}
    if world in MESHES:
        for arch, shape_name in FULL_CELLS:
            out[f"{arch}__{shape_name}__{world}"] = D.run_cell(
                arch, shape_name, world)
        try:
            D.run_cell("smollm-135m", "train_4k", world, "sp")
            out["sp"] = ""
        except NotImplementedError as e:
            out["sp"] = str(e)
    else:
        from repro_torch.configs import SMOKES
        from repro_torch.dist.comm import Axis
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.specs import model_flops

        D.fake_world(4)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        for name, kind in R.COUNT_CELLS:
            res = D.measure(SMOKES[name], R.count_shape(kind), mesh)
            out[f"{name}/{kind}"] = res["counts"]
            if (name, kind) == SMOKE_TRAIN:
                mf = model_flops(SMOKES[name], R.count_shape(kind),
                                 res["cell"].run)
                out["smoke_train_model_flops_per_chip"] = mf / 4
        ax = Axis(mesh, "model")
        out["staged"] = [ax.gloo, ax.staged(torch.empty(1, device="meta"))]
    (tmp / f"port_{world}.json").write_text(json.dumps(out))


# ------------------------------------------------------------- fixture
def _start(mode: str, tmp: Path, devices: int = 0):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices} " + env.get("XLA_FLAGS", ""))
    return subprocess.Popen([sys.executable, __file__, mode, str(tmp)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    from repro_torch.launch.mesh import spawn_ranks

    tmp = tmp_path_factory.mktemp("torch_dryrun")
    procs = {"ref512": _start("ref512", tmp, 512),
             "ref4": _start("ref4", tmp, 4),
             **{w: _start(w, tmp) for w in (*MESHES, "smoke")}}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn_ranks(R.count_ranks, 4, (), out_dir=tmp / "ranks",
                            device_type="cpu", timeout_s=TIMEOUT_S)
        logs = {k: p.communicate(timeout=TIMEOUT_S)[0]
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        torch.set_num_threads(n_threads)
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][-4000:])
    load = lambda n: json.loads((tmp / f"{n}.json").read_text())  # noqa
    yield {"ref512": load("ref512"), "ref4": load("ref4"),
           "port": {w: load(f"port_{w}") for w in (*MESHES, "smoke")},
           "ranks": ranks, "tmp": tmp}


# ------------------------------------------------------------- (a)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", FULL_CELLS)
def test_full_cells_bytes_and_counts_equal_the_references(runs, arch, shape,
                                                          mesh):
    tag = f"{arch}__{shape}__{mesh}"
    got, want = runs["port"][mesh][tag], runs["ref512"][tag]
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == want["args"], tag
    assert mem["output_size_in_bytes"] == want["outs"], tag
    assert mem["alias_size_in_bytes"] == want["donated"], tag
    for key in ("params_total", "params_active", "model_flops_global"):
        assert got[key] == want[key], (tag, key)
    assert got["n_chips"] == (512 if mesh == "multipod" else 256)
    assert got["flops_per_chip"] > 0 and got["bytes_per_chip"] > 0
    assert 0 < got["useful_flops_ratio"] <= 1, tag
    assert mem["peak_live_bytes_beyond_arguments"] > 0
    assert got["collectives_per_chip"]["total"] > 0
    assert set(got["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "pod_collective_bytes"}
    # the pod axis carries bytes where it splits the batch's rows: every
    # multi-pod cell but long_500k's one sequence
    assert (got["roofline"]["pod_collective_bytes"] > 0) == (
        mesh == "multipod" and shape != "long_500k"), tag


# ------------------------------------------------------------- (b)
@pytest.mark.parametrize("cell", [f"{n}/{k}" for n, k in R.COUNT_CELLS])
def test_smoke_counts_equal_those_of_real_ranks(runs, cell):
    got = runs["port"]["smoke"][cell]
    want = runs["ranks"][0][cell]
    assert got == want, (cell, got, want)
    assert got["collectives"]["total"] > 0


# ------------------------------------------------------------- (c)
def test_smoke_train_flops_beside_the_references_compiled_count(runs):
    port = runs["port"]["smoke"]
    got = port["/".join(SMOKE_TRAIN)]["flops"]
    ref = runs["ref4"]["flops"]
    useful = port["smoke_train_model_flops_per_chip"] / got
    print(f"smollm smoke train (2, 2): port flops/chip {got:.6g}, "
          f"reference hlo.analyze {ref:.6g}, ratio {got / ref:.4f}, "
          f"useful share {useful:.4f}")
    assert 0 < useful <= 1


# ------------------------------------------------------------- (d)
def test_sequence_parallelism_is_refused_by_name(runs):
    for mesh in MESHES:
        assert "SEQ_RULES" in runs["port"][mesh]["sp"], mesh
    out = runs["tmp"] / "cli"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--mesh", "pod", "--variant",
         "sp", "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 1, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "FAILURES:" in proc.stdout and "SEQ_RULES" in proc.stdout
    assert not list(out.glob("*.json"))


def test_a_fake_group_stages_nothing(runs):
    assert runs["port"]["smoke"]["staged"] == [False, False]


if __name__ == "__main__":
    mode, where = sys.argv[1], Path(sys.argv[2])
    if mode == "ref512":
        _ref_bytes(where)
    elif mode == "ref4":
        _ref_flops(where)
    else:
        _port(mode, where)
