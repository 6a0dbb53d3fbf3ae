"""Checkpoints with async save, auto-resume and elastic re-shard. Twin of
``repro.ckpt.checkpoint``, in its layout (one directory per step):

    ckpt_dir/step_000123/
        manifest.msgpack   — leaf names, shapes, dtypes, step, tree
        arrays/<leaf>.npy  — one file per leaf, the full array
        COMMITTED          — written last; partial checkpoints are ignored

Leaves are named as the reference names them (``jax.tree_util`` paths:
a ``TrainState`` field as ``.step``/``.params``/``.m``/``.v``, dict keys
sorted and joined by ``/``; the file name replaces ``/`` by ``__``), so a
checkpoint that the reference writes restores in the port leaf for leaf,
and the other way round. ``save`` snapshots every leaf to host memory
before it returns, so the caller may update the state in place at once;
with ``async_`` a thread writes the files.

Sharded states (``train.optim.DataParallel``): ``save`` with ``shardings``
(a tree of spec tuples like the state's, on ``mesh``) takes each rank's
blocks and gathers each leaf whole on the rank at coordinate 0 of every
mesh axis (``dist.comm.gather_to``: each distinct block once), which
writes it: the layout stays one full array a leaf, so a checkpoint of four
ranks restores in one process, in the reference or on another mesh.
Elastic re-shard: ``restore`` with
``shardings`` on a mesh reads each leaf's file memory-mapped and keeps
only this rank's block (``dist.sharding.shard_slices``), whatever mesh
wrote it.
"""
from __future__ import annotations

import os
import pathlib
import re
import threading
from typing import Any

import msgpack
import numpy as np
import torch

from ..models.layers import tree_flatten


def _is_record(tree) -> bool:
    """A NamedTuple such as ``train.optim.TrainState``."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaf_paths(tree) -> list[tuple[str, Any]]:
    if _is_record(tree):
        return [(f".{field}{'/' + p if p else ''}", leaf)
                for field, part in zip(tree._fields, tree)
                for p, leaf in tree_flatten(part)]
    return tree_flatten(tree)


def _treedef(tree) -> str:
    if _is_record(tree):
        return f"{type(tree).__name__}({', '.join(_treedef(p) for p in tree)})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    return "*"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def save(ckpt_dir: str | os.PathLike, step: int, tree, async_: bool = False,
         *, shardings=None, mesh=None):
    """Serialize a tree of tensors (a ``TrainState`` or nested dicts).
    Returns a join() callable. With ``shardings`` on ``mesh`` every rank of
    the mesh calls it with its blocks; one rank writes the whole leaves
    (module docstring) and the others get a join() that returns at
    once."""
    leaves = _leaf_paths(tree)
    if shardings is not None:
        import torch.distributed as dist

        from ..dist.comm import gather_to

        if mesh is None:
            raise ValueError("save: shardings need the mesh they are on")
        specs = dict(_leaf_paths(shardings))
        writer = int(mesh.mesh.flatten()[0])  # coordinate 0 on every axis
        host = []
        for n, x in leaves:  # gathered one leaf at a time
            full = gather_to(mesh, x, specs[n], writer)
            if full is not None:
                host.append((n, full.numpy()))
        if dist.get_rank() != writer:
            return lambda: None
    else:
        # snapshot to host memory synchronously: the caller may update the
        # device tensors in place right after save() returns
        host = [(n, _host(x)) for n, x in leaves]
    base = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    arrays = base / "arrays"
    arrays.mkdir(parents=True, exist_ok=True)
    manifest = {
        "step": step,
        "leaves": [{"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
                   for n, a in host],
        "treedef": _treedef(tree),
    }

    def _write():
        for name, arr in host:
            np.save(arrays / (name.replace("/", "__") + ".npy"), arr)
        with open(base / "manifest.msgpack", "wb") as f:
            f.write(msgpack.packb(manifest))
        (base / "COMMITTED").touch()

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t.join
    _write()
    return lambda: None


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = []
    for d in base.iterdir():
        m = re.fullmatch(r"step_(\d+)", d.name)
        if m and (d / "COMMITTED").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, step: int, like, shardings=None,
            *, mesh=None):
    """The tree of ``like`` (a ``TrainState`` or nested dicts of tensors,
    ``meta`` tensors allowed, each leaf's whole shape) read from step
    ``step``, each leaf in its ``like`` leaf's dtype on its device (the CPU
    for a ``meta`` leaf). ``shardings``, a tree of spec tuples on ``mesh``
    (the reference's tree of ``NamedSharding``), re-shards: each leaf comes
    back as this rank's block of it, read from the memory-mapped file."""
    base = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    if not (base / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {base}")
    specs = coords = None
    if shardings is not None:
        from ..dist.sharding import mesh_coords, shard_slices

        if mesh is None:
            raise ValueError("restore: shardings need the mesh they are on")
        specs = dict(_leaf_paths(shardings))
        coords = mesh_coords(mesh)
    arrays = base / "arrays"
    loaded = {}
    for name, ref in _leaf_paths(like):
        arr = np.load(arrays / (name.replace("/", "__") + ".npy"),
                      mmap_mode=None if specs is None else "r")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {arr.shape} in the checkpoint, "
                             f"{tuple(ref.shape)} expected")
        if specs is not None:
            arr = np.array(arr[shard_slices(specs[name], arr.shape, mesh,
                                            coords)])
        dev = ref.device if ref.device.type != "meta" else "cpu"
        loaded[name] = torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return loaded[prefix]

    if _is_record(like):
        return type(like)(*(rebuild(part, f".{field}")
                            for field, part in zip(like._fields, like)))
    return rebuild(like, "")
