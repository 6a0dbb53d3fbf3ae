"""Dispatch of the fused wormhole cycle by the device of its tensors.

Twin of ``repro.kernels.noc_cycle.ops``. ``run_cycles`` advances a batch of
instances ``T`` cycles and returns the simulation outputs. The reference
picks a backend by name (``ref``, ``pallas``, ``pallas_interpret``); the
port picks by device: CPU tensors run the plain ``ref.run_cycles_ref``,
CUDA tensors the kernel (``noc_cycle.run_cycles_cuda``), which either
launches or raises — nothing falls back to the plain version.
"""
from __future__ import annotations

from .noc_cycle import run_cycles_cuda
from .ref import CTR, TABLE_FIELDS, CycleState, geometry_tensors, init_planes
from .ref import run_cycles_ref

__all__ = ["CTR", "CycleState", "init_planes", "run_cycles"]


def run_cycles(tr: dict, geom: dict, *, T: int, F: int, V: int, BD: int,
               L: int, NN: int, ND: int, epoch_len: int | None = None,
               variant: str | None = None) -> dict:
    """Run ``T`` cycles over a batch of compiled-traffic tensors ``tr``
    (``{field: (B, ...)}`` int32 tensors on one device, ``dslot`` included).

    Returns ``{"dtime": (B, ND + 1), "ctr": (B, len(CTR)), "crel": (B, C),
    "lutil": (B, E, L), "rconf": (B, E, NN), "planes": CycleState}``.
    ``dtime`` is the flat delivery-time array indexed by the compiler's
    ``dslot`` table (slot ``ND`` is the discard slot). ``lutil``/``rconf``
    bucket on ``cycle // epoch_len`` with ``E = ceil(T / epoch_len)``
    (``epoch_len=None``: one epoch spanning the run). ``geom`` is the numpy
    router geometry of ``compile.geometry_tables``. ``variant`` forces one
    of the CUDA kernel's routes (``noc_cycle.VARIANTS``); the plain version
    has none.
    """
    P, S = tr["link"].shape[1:]
    C = tr["child_parent"].shape[1]
    device = tr["link"].device
    # int32 headroom for the packed child-release keys (compile.py guards
    # the (enqueue, pid, fid) age keys separately)
    if (T + 2) * max(C, 1) >= 2**31:
        raise ValueError("child release keys exceed int32")
    tb = {f: tr[f] for f in TABLE_FIELDS}
    EPL = max(T if epoch_len is None else int(epoch_len), 1)
    E = max(1, -(-T // EPL))
    gt = geometry_tensors(geom, device)
    kw = dict(T=T, F=F, V=V, BD=BD, L=L, NN=NN, ND=ND, EPL=EPL, E=E)
    if device.type == "cpu":
        if variant is not None:
            raise ValueError("variant= selects a CUDA kernel route")
        planes, dtime = run_cycles_ref(tb, tr["dslot"], gt, **kw)
    elif device.type == "cuda":
        planes, dtime = run_cycles_cuda(tb, tr["dslot"], gt, variant=variant,
                                        node_ports=geom["node_ports"], **kw)
    else:
        raise ValueError(f"no cycle engine for device {device}")
    crel = (planes.crtime >= 0) & (planes.crtime < T)
    return {
        "dtime": dtime, "ctr": planes.ctr, "crel": crel,
        "lutil": planes.lutil, "rconf": planes.rconf, "planes": planes,
    }
