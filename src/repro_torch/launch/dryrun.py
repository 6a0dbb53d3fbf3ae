"""Multi-pod dry run: rank 0's real step of every (arch x shape) cell on
the production meshes, run on ``meta`` tensors under a ``fake`` process
group, its operations and collectives counted. Twin of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh both

The reference lowers and compiles each cell with XLA and reads XLA's
figures. Here each mesh runs in a fresh process (``main`` starts one a
mesh) that joins a ``fake`` process group of the mesh's size (256 ranks
for the pod, 512 for the multi-pod mesh) as rank 0, builds
``launch.mesh.make_production_mesh`` on it and, for each cell,
``launch.specs.build_cell``'s stand-ins: rank 0's blocks of the arguments
as ``meta`` tensors (the batch whole, of which the step takes its rows).
It then runs the port's step under ``Counter``, a ``TorchDispatchMode``:
``train.step.build_train_step`` with ``optim.DataParallel`` (ZeRO-1,
``remat="block"``, AdamW) for a train cell, ``models.model.prefill`` and
``decode_step`` on the rank's blocks (``shardctx.set_ctx(mesh,
blocks=True)``) for the serving cells; a decode step writes position
``seq_len - 1``. Nothing is allocated and no card is used; the collectives
of the fake group complete at once. Kernels are not launched on ``meta``:
their plain versions give the shapes, and their operations are counted.

What stands in for each of XLA's figures (README "Dry run"):

* ``memory``: ``argument_size_in_bytes``, ``output_size_in_bytes`` and
  ``alias_size_in_bytes`` are the bytes of rank 0's blocks of the
  arguments, of its outputs and of the donated arguments (exact);
  ``peak_live_bytes_beyond_arguments`` is the peak of the bytes of the
  tensors the step allocates that are alive at once (no fusion: an
  estimate, not XLA's ``temp_size_in_bytes``);
* ``flops_per_chip`` and ``bytes_per_chip``: ``launch.hlo``'s rules over
  the operations run: a matrix product 2 x result x contracting, any
  other operation one per output element, bytes the operands' and the
  results' of each (views and allocations are free); no fusion, so the
  bytes are an upper bound;
* ``collectives_per_chip``: for each c10d operation and mesh axis the
  operand bytes, and their ``total``;
* ``params_*``, ``model_flops_*`` from ``launch.specs``; ``roofline`` from
  the H100 constants of ``launch.mesh`` (every axis at ``NVLINK_BW``; the
  ``pod`` axis's bytes also on their own); ``trace_s`` the step's wall
  time on the host. XLA's ``lower_s``, ``compile_s`` and its unscaled
  cost have no counterpart.

Results go to ``build/dryrun_results/`` (one JSON file a cell; nothing is
committed). Variants: those whose options the port runs; ``sp*`` (the
residual stream's sequence over ``model``, ``SEQ_RULES``) raise, and
``ep*`` on a train cell raise ``optim.DataParallel``'s refusal; a refusal
is a failure, as an exception is in the reference.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, SHAPES
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_production_mesh
from .specs import _params, build_cell, model_flops, param_counts

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
               / "dryrun_results")
MESHES = {"pod": 256, "multipod": 512}
DEVICE = "NVIDIA H100 80GB HBM3 (launch.mesh constants)"

# ---------------------------------------------------------------------------
# variants (the reference's perf levers): RunConfig overrides and the
# activation rule table
# ---------------------------------------------------------------------------
STREAM = {"attn_stream_bf16": True, "ssd_stream_bf16": True}
STREAM2 = dict(STREAM, norm_stats_only_f32=True, attn_chunk_q=2048,
               attn_chunk_k=2048)
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "stream_bf16": {"run": STREAM},
    "sp": {"rules": "seq"},
    "sp_stream": {"run": STREAM, "rules": "seq"},
    "ep": {"run": {"moe_impl": "ep"}},
    "ep_stream": {"run": dict(STREAM, moe_impl="ep"), "rules": None},
    "ep_sp_stream": {"run": dict(STREAM, moe_impl="ep"), "rules": "seq"},
    "remat_none": {"run": {"remat": "none"}},
    "no_zero1": {"run": {"zero1": False}},
    "chunk256": {"run": {"attn_chunk_q": 256, "attn_chunk_k": 256}},
    "chunk2k": {"run": {"attn_chunk_q": 2048, "attn_chunk_k": 2048}},
    "stream_chunk2k": {
        "run": dict(STREAM, attn_chunk_q=2048, attn_chunk_k=2048)
    },
    "ep_stream_chunk2k": {
        "run": dict(STREAM, moe_impl="ep", attn_chunk_q=2048,
                    attn_chunk_k=2048)
    },
    "stream2": {"run": STREAM2},
    "ssd128": {"run": {"ssd_chunk": 128}},
    "ssd64": {"run": {"ssd_chunk": 64}},
    "ssd128_stream": {"run": dict(STREAM, ssd_chunk=128)},
    "ep_stream2": {"run": dict(STREAM2, moe_impl="ep")},
}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "lift_fresh", "detach", "alias",
          "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
          "is_same_size", "_has_compatible_shallow_copy_type"}
# the c10d arguments that hold a collective's operands
_OPERANDS = ("tensors", "input_tensors", "input_tensor", "input")


def _tensors(x):
    """The tensors of a tree of dicts, lists and tuples (a ``TrainState``
    too)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple, dict)):
        for y in (x.values() if isinstance(x, dict) else x):
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    """2 x result x contracting (the operand's last dim), plus one per
    output element for the added term of ``add*mm``."""
    a = args[_DOTS[name]]
    flops = 2.0 * out.numel() * a.shape[-1]
    return flops + (out.numel() if _DOTS[name] else 0)


class Counter(TorchDispatchMode):
    """Counts the operations of a step as ``launch.hlo`` counts HLO: flops
    and bytes of every operation that is not a view or an allocation, the
    operand bytes of every c10d collective by kind and by the mesh axis of
    its group (``axes``: group name -> axis name), and the peak of the
    bytes of the tensors the step allocates that are alive at once."""

    def __init__(self, axes: dict[str, str]):
        super().__init__()
        self.axes = axes
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict = defaultdict(lambda: defaultdict(float))
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _axis(self, args) -> str:
        for a in args:
            if isinstance(a, torch.ScriptObject):
                name = dist.ProcessGroup.unbox(a).group_name
                return self.axes.get(name, f"group:{name}")
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            if name != "barrier":
                names = [a.name for a in func._schema.arguments]
                ops = [a for n, a in zip(names, args) if n in _OPERANDS]
                self.collectives[name][self._axis(args)] += _nbytes(ops)
            return out
        if func.is_view or name in _ALLOC:
            return out
        outs = list(_tensors(out))
        if name in _DOTS:
            self.flops += _dot_flops(name, args, outs[0])
        else:
            self.flops += sum(t.numel() for t in outs)
        self.bytes += _nbytes(list(args) + list(kwargs.values())) + \
            _nbytes(outs)
        # the fresh results (not aliases of an input) are allocations
        for ret, t in zip(func._schema.returns, outs):
            if ret.alias_info is None:
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out

    def summary(self) -> dict:
        coll = {k: dict(v) for k, v in sorted(self.collectives.items())}
        coll["total"] = float(sum(b for v in self.collectives.values()
                                  for b in v.values()))
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll, "peak_live_bytes": self.peak}


def group_axes(mesh) -> dict[str, str]:
    """Group name -> mesh axis name of a ``DeviceMesh``."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def _blocks(tree, specs, mesh, coords, device, fill):
    """Rank ``coords``' blocks of a tree of whole stand-ins: empty on
    ``meta``, else ``fill``ed on ``device``."""
    from ..dist.sharding import shard_slices

    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh, coords, device, fill)
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # TrainState
        return type(tree)(*(_blocks(v, s, mesh, coords, device, fill)
                            for v, s in zip(tree, specs)))
    sl = shard_slices(specs, tree.shape, mesh, coords)
    shape = tuple(s.stop - s.start for s in sl)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=tree.dtype, device="meta")
    return torch.full(shape, fill, dtype=tree.dtype, device=device)


def _whole(tree, device):
    """Whole stand-ins (the batch, which each rank takes its rows of)."""
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    if torch.device(device).type == "meta":
        return tree
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def _layers(tree):
    """A cache tree of ``launch.specs`` (each group's layers stacked) as
    the port's caches: a list of the layers' dicts a group."""
    from ..models.layers import tree_map

    out = {}
    for g, stacked in tree.items():
        n = next(_tensors(stacked)).shape[0]
        out[g] = [tree_map(lambda t, i=i: t[i], stacked) for i in range(n)]
    return out


def measure(cfg, shape, mesh, run_overrides=None, rules=None,
            device="meta") -> dict:
    """Rank-local run of ``shape``'s cell of ``cfg`` on ``mesh`` (a
    ``DeviceMesh`` of an initialised group) under ``Counter``: on
    ``meta`` stand-ins, or on ``device`` with the arguments filled with
    zeros (the gloo ranks of the tests). Returns the counts, the bytes
    of the arguments, outputs and donated arguments, the trace time and
    the cell."""
    from ..dist.sharding import mesh_coords
    from ..shardctx import clear_ctx, set_ctx

    if rules is not None:
        raise NotImplementedError(
            "sequence parallelism (SEQ_RULES: the residual stream's "
            "sequence over 'model') is not ported; ROADMAP item 5 step 11")
    cell = build_cell(cfg, shape, mesh, run_overrides=run_overrides)
    run, coords = cell.run, mesh_coords(mesh)
    # the batch (the last argument) whole, the rest rank 0's blocks
    *state, batch = cell.args
    args = [_blocks(a, s, mesh, coords, device, 0)
            for a, s in zip(state, cell.in_shardings)] + [_whole(batch,
                                                                  device)]
    blocks = [_blocks(a, s, mesh, coords, "meta", 0)
              for a, s in zip(cell.args, cell.in_shardings)]
    arg_bytes = _nbytes(blocks)
    donated = _nbytes([blocks[i] for i in cell.donate])
    counter = Counter(group_axes(mesh))
    t0 = time.monotonic()
    if cell.kind == "train":
        from ..train.optim import DataParallel
        from ..train.step import build_train_step

        state, batch = args
        shapes, logical = _params(cfg, run)
        data = DataParallel.for_training(mesh, cfg, run, logical, shapes)
        step = build_train_step(cfg, run, data=data)
        with counter:
            out = step(state, batch)
    else:
        from ..models.model import decode_step, prefill

        set_ctx(mesh, blocks=True)
        try:
            with counter:
                if cell.kind == "prefill":
                    out = prefill(args[0], args[1], cfg, run)
                else:
                    batch = dict(args[2], pos=shape.seq_len - 1)
                    out = decode_step(args[0], _layers(args[1]), batch,
                                      cfg, run)
        finally:
            clear_ctx()
    trace_s = time.monotonic() - t0
    return {"counts": counter.summary(), "trace_s": trace_s,
            "argument_bytes": arg_bytes, "donated_bytes": donated,
            "output_bytes": _nbytes(out),
            "cell": cell}


def fake_world(size: int) -> None:
    """Join a ``fake`` process group of ``size`` ranks as rank 0 (once a
    process; a group of another size raises)."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"this process's group has "
                               f"{dist.get_world_size()} ranks, not {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())


def run_cell(arch: str, shape_name: str, mesh_name: str,
             variant: str = "baseline") -> dict:
    """One cell's figures (module docstring), in a process whose fake
    group has the mesh's size (``fake_world``; joined here if none)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    fake_world(MESHES[mesh_name])
    mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                device_type="cpu")
    spec = VARIANTS[variant]
    res = measure(cfg, shape, mesh, run_overrides=spec.get("run"),
                  rules=spec.get("rules"))
    run, counts = res["cell"].run, res["counts"]
    flops, bytes_accessed = counts["flops"], counts["bytes"]
    coll = counts["collectives"]
    n_chips = math.prod(mesh.shape)
    mf = model_flops(cfg, shape, run)
    params = param_counts(cfg, run)
    pod_bytes = sum(v.get("pod", 0.0) for k, v in coll.items()
                    if k != "total")
    terms = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": coll["total"] / NVLINK_BW,
    }
    dominant = max(terms, key=terms.get)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "variant": variant,
        "kind": res["cell"].kind,
        "n_chips": n_chips,
        "kv_cache_dtype": run.kv_cache_dtype,
        "remat": run.remat,
        "trace_s": round(res["trace_s"], 2),
        "memory": {
            "argument_size_in_bytes": res["argument_bytes"],
            "output_size_in_bytes": res["output_bytes"],
            "alias_size_in_bytes": res["donated_bytes"],
            "peak_live_bytes_beyond_arguments": counts["peak_live_bytes"],
        },
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_accessed,
        "collectives_per_chip": coll,
        "params_total": params["total"],
        "params_active": params["active"],
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else 0.0,
        "roofline": dict(terms, dominant=dominant,
                         pod_collective_bytes=pod_bytes),
        "step_time_lower_bound_s": max(terms.values()),
        "device_constants": DEVICE,
    }


def _cells(args) -> list[tuple[str, str]]:
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    out = []
    for arch in archs:
        for shape_name in shapes:
            if shape_name == "long_500k" and not ARCHS[arch].sub_quadratic:
                print(f"SKIP {arch} x long_500k (full attention; DESIGN.md)")
                continue
            out.append((arch, shape_name))
    return out


def _world(args, mesh_name: str) -> list[tuple[str, str]]:
    """Every cell of one mesh, in this process; the failures."""
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch, shape_name in _cells(args):
        tag = f"{arch}__{shape_name}__{mesh_name}__{args.variant}"
        out_file = outdir / f"{tag}.json"
        if out_file.exists() and not args.force:
            print(f"cached {tag}")
            continue
        print(f"=== {tag}", flush=True)
        try:
            res = run_cell(arch, shape_name, mesh_name, args.variant)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            failures.append((tag, f"{type(e).__name__}: {e}"))
            continue
        out_file.write_text(json.dumps(res, indent=1))
        r = res["roofline"]
        print(f"  ok: trace {res['trace_s']}s  "
              f"flops/chip {res['flops_per_chip']:.3g}  "
              f"terms c/m/x = {r['compute_s']:.4f}/{r['memory_s']:.4f}/"
              f"{r['collective_s']:.4f}s  dominant={r['dominant']}  "
              f"useful={res['useful_flops_ratio']:.2f}", flush=True)
        if r["pod_collective_bytes"]:
            print(f"  pod axis: {r['pod_collective_bytes']:.4g} bytes a "
                  "chip", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--world", choices=sorted(MESHES),
                    help=argparse.SUPPRESS)  # a child: one mesh's cells
    args = ap.parse_args(argv)

    if args.world:
        failures = _world(args, args.world)
        for tag, err in failures:
            print(f"FAILURE\t{tag}\t{err[:200]}", flush=True)
        raise SystemExit(1 if failures else 0)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    base = [a for a in (argv if argv is not None else sys.argv[1:])]
    failures = []
    for mesh_name in meshes:
        # a fresh process a mesh: its fake group has the mesh's size
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *base,
             "--world", mesh_name], stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        for line in proc.stdout:
            if line.startswith("FAILURE\t"):
                _, tag, err = line.rstrip("\n").split("\t", 2)
                failures.append((tag, err))
            else:
                print(line, end="", flush=True)
        if proc.wait() not in (0, 1) and not failures:
            failures.append((mesh_name, f"exit code {proc.returncode}"))
    if failures:
        print("FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
