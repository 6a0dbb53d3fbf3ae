"""Loader and wrapper of the CUDA wormhole-cycle kernels (``csrc/noc_cycle.cu``).

Replaces the reference's Pallas chunk runner
(``repro.kernels.noc_cycle.noc_cycle.make_chunk_runner``). The kernels are
built at first use with ``nvcc`` for ``sm_90a`` into ``build/kernels`` at the
root of the checkout, as a shared library with a plain C interface bound
through ``ctypes`` (seconds to build; nothing is built at import time).

``run_cycles_cuda`` runs all ``T`` cycles in one launch, on one of two
routes that it picks from the shape before it launches:

* ``cluster_smem``: one thread-block cluster of ``K`` CTAs per instance,
  each CTA holding a band of routers' state in shared memory
  (``cluster_plan`` builds the per-rank layout, ``cluster_smem_bytes``
  mirrors the kernel's shared-memory layout);
* ``block``: one thread block per instance over planes in global memory,
  for shapes whose bands no cluster can hold.

``variant=`` forces a route. ``KERNEL.launches`` counts launches and
``KERNEL.variants`` counts them per route, so a caller can show which
kernel a run went through; ``KERNEL.cluster`` describes the last cluster
launch (``K``, routers per rank, shared memory per rank).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..build import CudaLibrary, check_tensor as _check
from .ref import CycleState, init_planes

_SRC = Path(__file__).resolve().parent / "csrc" / "noc_cycle.cu"

VARIANTS = ("cluster_smem", "block")
# the most dynamic shared memory an H100 block may opt in to (227 KB)
SMEM_OPTIN = 232_448
# cluster sizes tried in order: 8 CTAs is the portable maximum; 16 needs the
# non-portable opt-in and is taken only where 8 ranks' state does not fit
CLUSTER_SIZES = (8, 16, 7, 6, 5, 4, 3, 2, 1)
CL_THREADS_MAX = 512
CL_MISC = 32  # int32 words of per-CTA counters (csrc: CL_MISC)
R_N = 12  # int32 words of a route record (csrc: R_N)
W_N = 8  # int32 words of a winner record (csrc: W_N)
NO_CLUSTER = -1  # launch code: no cluster of this shape fits the card

_PLANES = CycleState._fields
# kernel-side table order (NocArgs); ``lane`` is only read by the plain
# version's child bookkeeping, which the kernels do per router instead
_TABLES = (
    "enqueue", "num_stages", "flits", "link", "vcls", "lane_seq", "chl",
    "child_pid", "child_parent", "child_rs", "child_enq", "watch_link",
    "dslot",
)
_SIZES = ("B", "P", "S", "Q", "QC", "C", "NN", "L", "V", "D", "F", "BD", "E",
          "EPL", "ND", "T")


class _NocArgs(ctypes.Structure):
    _fields_ = (
        [(f, ctypes.c_void_p) for f in _PLANES]
        + [(f, ctypes.c_void_p) for f in _TABLES]
        + [("node_ports", ctypes.c_void_p), ("cand_port", ctypes.c_void_p),
           ("dtime", ctypes.c_void_p), ("scratch", ctypes.c_void_p)]
        + [(f, ctypes.c_int) for f in _SIZES + ("use_smem",)]
    )


class ClArgs(ctypes.Structure):
    """``ClArgs`` of ``csrc/noc_cycle.cu``: the cluster kernel's arguments."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _PLANES]
        + [(f, ctypes.c_void_p) for f in _TABLES]
        + [(f, ctypes.c_void_p)
           for f in ("slot_link", "link_home", "crow", "coff", "lrec", "cyc",
                     "dtime")]
        + [(f, ctypes.c_int) for f in _SIZES + ("K", "NR", "CC")]
    )


class NocCycleKernel(CudaLibrary):
    """The built library, its build report and the launch counters."""

    def __init__(self):
        super().__init__("noc_cycle", _SRC)
        self.launches = 0
        self.variants = dict.fromkeys(VARIANTS, 0)
        self.cluster: dict | None = None
        self._scratch: dict = {}

    def reset(self) -> None:
        self.launches = 0
        self.variants = dict.fromkeys(VARIANTS, 0)

    def scratch(self, words: int, device: torch.device) -> torch.Tensor:
        """An int32 scratch buffer of at least ``words`` on ``device``, kept
        per stream: launches on one stream run in order, so each reuses the
        buffer that the one before it has finished with."""
        stream = (torch.cuda.current_stream(device).cuda_stream
                  if device.type == "cuda" else None)
        key = (str(device), stream)
        buf = self._scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = self._scratch[key] = torch.empty(
                words, dtype=torch.int32, device=device)
        return buf[:words]

    def bind(self, lib: ctypes.CDLL) -> None:
        lib.noc_cycle_launch.argtypes = [ctypes.POINTER(_NocArgs),
                                         ctypes.c_void_p]
        lib.noc_cycle_launch.restype = ctypes.c_int
        lib.noc_cycle_scratch_words.argtypes = [ctypes.c_int] * 3
        lib.noc_cycle_scratch_words.restype = ctypes.c_size_t
        lib.noc_cycle_smem_optin.restype = ctypes.c_int
        lib.noc_cycle_cluster_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.noc_cycle_cluster_smem_bytes.restype = ctypes.c_size_t
        lib.noc_cycle_cluster_launch.argtypes = [
            ctypes.POINTER(ClArgs), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p,
        ]
        lib.noc_cycle_cluster_launch.restype = ctypes.c_int


KERNEL = NocCycleKernel()


# ---------------------------------------------------------------------------
# The cluster kernel's per-rank layout
# ---------------------------------------------------------------------------
def cluster_smem_bytes(NR: int, D: int, W: int, CC: int) -> int:
    """Dynamic shared memory of one cluster CTA: the mirror of
    ``cl_smem_carve`` in ``csrc/noc_cycle.cu`` (each array padded to 16 B).
    ``NR`` routers per rank, ``D`` ports, ``W`` VCs per link, ``CC``
    children per rank."""
    NO = NR * D
    NF, NL = NO * W, 2 * NR
    NC = NF + NL
    arrays = (
        [(2, 8), (2 * NO, 4), (NO, 4)]
        + [(NO, 8), (NR, 8), (NR, 8)]
        + [(NO * W_N, 4), (NR * R_N, 4), (NL * R_N, 4), (CC * R_N, 4)]
        + [(NF, 4)] * 7 + [(NC, 4)] * 3 + [(NO, 4)] * 3 + [(NR, 4), (NL, 4)]
        + [(CC, 4)] * 5 + [(CL_MISC, 4)]
        + [(NF, 2), (NF, 2), (NC, 2), (NC, 2), (CC, 2), (CC, 2)]
        + [(NF, 1)] * 6 + [(NL, 1)] * 2 + [(NC, 1)] * 4 + [(CC, 1)]
    )
    return sum((n * size + 15) & ~15 for n, size in arrays)


class BandLayout(NamedTuple):
    """Routers in ``K`` bands of ``NR`` consecutive ids, one per cluster
    rank. In-slot ``vl * D + d`` of rank ``r`` holds the FIFOs of the link
    that enters router ``r * NR + vl`` on port ``d``; a port with no link
    holds the FIFOs of a link of that band that does not exist (a mesh edge),
    so that every FIFO of the planes has one home."""

    K: int
    NR: int
    slot_link: np.ndarray  # (K, NR * D) int32 link in each in-slot, -1 pad
    link_home: np.ndarray  # (L,) int32 rank << 16 | in-slot


@functools.lru_cache(maxsize=64)
def _band_layout(NN: int, L: int, W: int, K: int,
                 ports: bytes) -> BandLayout | None:
    node_ports = np.frombuffer(ports, np.int32).reshape(NN, -1)
    D, LW = L // NN, L * W
    NR = -(-NN // K)
    if -(-NN // NR) != K:  # a rank would hold no router
        return None
    slot_link = np.full((K, NR * D), -1, np.int32)
    placed = np.zeros(L, bool)
    for v in range(NN):
        r, vl = divmod(v, NR)
        for d in range(D):
            c = int(node_ports[v, d * W])
            if c < LW:
                slot_link[r, vl * D + d] = c // W
                placed[c // W] = True
    src_rank = np.arange(L) // D // NR
    for r in range(K):
        lo, hi = r * NR * D, min(NN, (r + 1) * NR) * D
        free = np.flatnonzero(slot_link[r, : hi - lo] < 0)
        ghosts = np.flatnonzero(~placed & (src_rank == r))
        if len(free) != len(ghosts):
            return None
        slot_link[r, free] = ghosts
    link_home = np.empty(L, np.int32)
    for r in range(K):
        for slot, l in enumerate(slot_link[r]):
            if l >= 0:
                link_home[l] = (r << 16) | slot
    return BandLayout(K, NR, slot_link, link_home)


def band_layout(node_ports: np.ndarray, NN: int, L: int, V: int,
                K: int) -> BandLayout | None:
    """The band layout of ``compile.geometry_tables``' ``node_ports`` over
    ``K`` ranks, or None where ``K`` bands cannot hold it."""
    ports = np.ascontiguousarray(node_ports, np.int32).tobytes()
    return _band_layout(NN, L, 2 * V, K, ports)


def link_ranks(layout: BandLayout, D: int) -> tuple[np.ndarray, np.ndarray]:
    """(source rank, home rank) of every link: the rank that arbitrates it
    and the rank that holds its FIFOs."""
    L = layout.link_home.shape[0]
    return np.arange(L) // D // layout.NR, layout.link_home >> 16


def bands_adjacent(layout: BandLayout, D: int) -> bool:
    """Every link joins a band to itself or to a neighbouring band (ranks 0
    and K - 1 are neighbours: a torus's wrap links join them)."""
    src, home = link_ranks(layout, D)
    gap = (home - src) % layout.K
    return bool(np.all((gap <= 1) | (gap == layout.K - 1)))


class ChildLayout(NamedTuple):
    crow: torch.Tensor  # (B, K, CC) int32 child row of each local child
    coff: torch.Tensor  # (B, C) int32 each child row's slot in its rank
    owner: np.ndarray  # (B, C) rank owning each child row, -1 for none
    CC: int
    local_watch: bool  # every child with a slot watches its own rank's link


def child_layout(chl: torch.Tensor, watch_link: torch.Tensor,
                 child_rs: torch.Tensor, layout: BandLayout) -> ChildLayout:
    """Spread each instance's DPM children over the ranks: a child queued
    on a router's child lane (a row of ``chl``) belongs to that router's
    rank; any other child belongs to the rank holding the FIFOs of the link
    it watches. Children that no arrival can release (a release stage
    outside the int16 stage range, as the padding rows' ``NEVER``) and that
    no lane queues get no slot: they never change. Slots follow row order.
    ``CC`` is the most children one rank holds. One scatter on the tensors'
    device finds each queued row's router; the rest is numpy over ``(B,
    C)`` arrays from one copy, and ``crow`` and ``coff`` go back in one."""
    dev = chl.device
    B, NN, QC = chl.shape
    C = watch_link.shape[1]
    K, NR = layout.K, layout.NR
    L = layout.link_home.shape[0]
    node = torch.full((B, C + 1), -1, dtype=torch.int32, device=dev)
    node.scatter_(  # column C absorbs the empty entries
        1, torch.where(chl >= 0, chl, C).reshape(B, -1).long(),
        torch.arange(NN, dtype=torch.int32, device=dev)
        .repeat_interleave(QC).expand(B, -1))
    host = torch.cat([node[:, :C].reshape(-1), watch_link.reshape(-1),
                      child_rs.reshape(-1)]).cpu().numpy().reshape(3, B, C)
    queued, wl, rs = host[0] >= 0, host[1], host[2]
    home = (layout.link_home >> 16)[np.clip(wl, 0, L - 1)]
    owner = np.where(queued, host[0] // NR, home)
    active = queued | ((rs >= 0) & (rs < 32768))
    far = bool((active & (home != owner)).any())
    group = np.where(active, owner, K)  # K: no slot
    counts = np.stack([np.bincount(g, minlength=K + 1) for g in group])
    CC = max(1, int(counts[:, :K].max()))
    order = np.argsort(group * C + np.arange(C), axis=1, kind="stable")
    starts = np.cumsum(counts, axis=1) - counts
    pos = np.arange(C) - np.take_along_axis(
        starts, np.take_along_axis(group, order, 1), 1)
    offset = np.empty_like(pos)
    np.put_along_axis(offset, order, pos, 1)
    crow = np.full((B, K, CC), -1, np.int32)
    ba, ca = np.nonzero(active)
    crow[ba, owner[ba, ca], offset[ba, ca]] = ca
    coff = np.where(active, offset, -1).astype(np.int32)
    both = torch.from_numpy(np.concatenate([crow.ravel(), coff.ravel()]))
    both = both.to(dev)
    return ChildLayout(both[: crow.size].view(crow.shape),
                       both[crow.size:].view(B, C),
                       np.where(active, owner, -1), CC, not far)


class ClusterPlan(NamedTuple):
    layout: BandLayout
    children: ChildLayout
    smem: int  # dynamic shared memory per CTA (bytes)
    threads: int  # the most threads per CTA the launch may take


def cluster_plan(node_ports: np.ndarray, children: Callable[[BandLayout],
                 ChildLayout], *, NN: int, L: int, V: int,
                 optin: int = SMEM_OPTIN) -> ClusterPlan | None:
    """Pick the cluster size: the first of ``CLUSTER_SIZES`` whose bands
    join only neighbouring ranks, whose children watch links of their own
    rank and whose per-rank state fits ``optin`` bytes of shared memory;
    None when none does (the ``block`` route). ``children(layout)`` spreads
    the batch's DPM children over the ranks. A link's status goes to its
    source rank as one byte per VC in 8 bytes, so ``W`` is at most 8."""
    D, W = L // NN, 2 * V
    if W > 8:
        return None
    for K in CLUSTER_SIZES:
        if K > NN:
            continue
        layout = band_layout(node_ports, NN, L, V, K)
        if layout is None or not bands_adjacent(layout, D):
            continue
        ch = children(layout)
        smem = cluster_smem_bytes(layout.NR, D, W, ch.CC)
        if smem <= optin and ch.CC < 32768 and ch.local_watch:
            NC = layout.NR * D * W + 2 * layout.NR
            threads = min(CL_THREADS_MAX, -(-NC // 32) * 32)
            return ClusterPlan(layout, ch, smem, threads)
    return None


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------
_DEVICE_LAYOUTS: dict = {}


def _device_layout(lay: BandLayout, dev: torch.device) -> list:
    """``slot_link`` and ``link_home`` on ``dev``, copied once per layout."""
    key = (id(lay), str(dev))
    if key not in _DEVICE_LAYOUTS:
        _DEVICE_LAYOUTS[key] = (lay, [
            torch.as_tensor(lay.slot_link, device=dev).contiguous(),
            torch.as_tensor(lay.link_home, device=dev).contiguous(),
        ])
    return _DEVICE_LAYOUTS[key][1]


def cluster_args(plan: ClusterPlan, planes: CycleState, tables: dict,
                 dtime: torch.Tensor, sizes: dict) -> tuple[ClArgs, list]:
    """The cluster kernel's argument struct over ``planes``, ``tables``
    (the traffic tables and ``dslot``) and ``dtime``, and the layout and
    scratch tensors it points into (keep them alive until the kernel
    ends)."""
    dev = dtime.device
    B, NN, Q, T = sizes["B"], sizes["NN"], sizes["Q"], sizes["T"]
    records, counts = B * NN * Q * R_N, B * plan.layout.K * T * 2
    scratch = KERNEL.scratch(records + counts, dev)
    keep = [*_device_layout(plan.layout, dev), plan.children.crow,
            plan.children.coff, scratch[:records], scratch[records:]]
    args = ClArgs(
        *[p.data_ptr() for p in planes],
        *[tables[f].data_ptr() for f in _TABLES],
        *[t.data_ptr() for t in keep], dtime.data_ptr(),
        *[sizes[f] for f in _SIZES], plan.layout.K, plan.layout.NR,
        plan.children.CC,
    )
    return args, keep


def run_cycles_cuda(tb: dict, dslot: torch.Tensor, geom: dict, *, T: int,
                    F: int, V: int, BD: int, L: int, NN: int, ND: int,
                    EPL: int, E: int, variant: str | None = None,
                    node_ports: np.ndarray | None = None,
                    ) -> tuple[CycleState, torch.Tensor]:
    """``T`` cycles from fresh planes through a CUDA kernel: the same
    contract as ``ref.run_cycles_ref``. Every tensor must lie on one CUDA
    device; the kernel runs on PyTorch's current stream. ``variant`` forces
    a route (``"cluster_smem"`` or ``"block"``); by default the cluster
    kernel runs wherever a cluster holds the shape. ``node_ports``, the
    host copy of ``geom["node_ports"]``, spares copying it back. A cluster
    launch that fails, or finds no cluster of its shape resident on the
    card, raises."""
    device = dslot.device
    if device.type != "cuda":
        raise ValueError(f"run_cycles_cuda needs CUDA tensors, got {device}")
    if variant not in (None, *VARIANTS):
        raise ValueError(f"unknown noc_cycle variant {variant!r}")
    B, P, S = tb["link"].shape
    Q = tb["lane_seq"].shape[2]
    QC = tb["chl"].shape[2]
    C = tb["child_parent"].shape[1]
    W = 2 * V
    D = L // NN
    CANDP = L * W + 2 * NN + 1
    shapes = {
        "enqueue": (B, P), "num_stages": (B, P), "flits": (B, P),
        "link": (B, P, S), "vcls": (B, P, S), "dslot": (B, P, S),
        "lane_seq": (B, 2 * NN, Q), "chl": (B, NN, QC),
        "child_pid": (B, C), "child_parent": (B, C), "child_rs": (B, C),
        "child_enq": (B, C), "watch_link": (B, C),
    }
    tables = dict(tb, dslot=dslot)
    for f in _TABLES:
        _check(f, tables[f], torch.int32, shapes[f], device)
    _check("node_ports", geom["node_ports"], torch.int32,
           (NN, D * W + 2), device)
    _check("cand_port", geom["cand_port"], torch.int32, (CANDP,), device)
    if B == 0 or T == 0:
        raise ValueError("run_cycles_cuda needs B > 0 instances and T > 0 cycles")
    if S >= 32767 or F > 127 or W > 127:
        raise ValueError("stages, worm lengths or VCs exceed the int16/int8 "
                         "planes")
    sizes = dict(B=B, P=P, S=S, Q=Q, QC=QC, C=C, NN=NN, L=L, V=V, D=D, F=F,
                 BD=BD, E=E, EPL=EPL, ND=ND, T=T)

    lib = KERNEL.build()
    with torch.cuda.device(device):
        plan = None
        if variant != "block":
            if node_ports is None:
                node_ports = geom["node_ports"].cpu().numpy()
            plan = cluster_plan(
                node_ports,
                lambda lay: child_layout(tb["chl"], tb["watch_link"],
                                         tb["child_rs"], lay),
                NN=NN, L=L, V=V,
                optin=min(SMEM_OPTIN, lib.noc_cycle_smem_optin()),
            )
            if plan is None and variant == "cluster_smem":
                raise RuntimeError(
                    "no cluster holds this shape in shared memory")
        planes = init_planes(B, L, W, NN, C, E, device=device)
        dtime = torch.full((B, ND + 1), -1, dtype=torch.int32, device=device)
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        if plan is not None:
            args, keep = cluster_args(plan, planes, tables, dtime, sizes)
            threads, resident = ctypes.c_int(0), ctypes.c_int(0)
            err = lib.noc_cycle_cluster_launch(
                ctypes.byref(args), plan.threads, ctypes.byref(threads),
                ctypes.byref(resident), stream)
            if err == NO_CLUSTER:
                raise RuntimeError(
                    f"no cluster of {plan.layout.K} CTAs with {plan.smem} B "
                    "of shared memory each fits the card")
            if err != 0:
                raise RuntimeError(
                    f"noc_cycle cluster kernel launch failed: cudaError {err}")
            KERNEL.cluster = dict(
                NN=NN, D=D, W=W, K=plan.layout.K, NR=plan.layout.NR,
                CC=plan.children.CC, smem=plan.smem, threads=threads.value,
                resident_clusters=resident.value,
            )
            route = "cluster_smem"
            keep.clear()  # the launch is queued; the stream orders the frees
        else:
            words = lib.noc_cycle_scratch_words(L, W, NN)
            # static shared memory (the per-cycle counters) needs a little room
            use_smem = words * 4 + 1024 <= lib.noc_cycle_smem_optin()
            scratch = torch.empty(
                0 if use_smem else B * words, dtype=torch.int32, device=device
            )
            args = _NocArgs(
                *[p.data_ptr() for p in planes],
                *[tables[f].data_ptr() for f in _TABLES],
                geom["node_ports"].data_ptr(), geom["cand_port"].data_ptr(),
                dtime.data_ptr(), scratch.data_ptr(),
                *[sizes[f] for f in _SIZES], int(use_smem),
            )
            err = lib.noc_cycle_launch(ctypes.byref(args), stream)
            if err != 0:
                raise RuntimeError(
                    f"noc_cycle kernel launch failed: cudaError {err}")
            route = "block"
        KERNEL.launches += 1
        KERNEL.variants[route] += 1
    return planes, dtime
