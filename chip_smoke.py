#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing what it found on its own line; any failure exits
non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the CUDA cycle kernels (``kernels/noc_cycle/csrc``), the two
   cost-table kernels (``kernels/dpm_cost/csrc``), the flash-attention
   kernels (``kernels/flash_attention/csrc``), the SSD intra-chunk kernels
   (``kernels/ssd/csrc``) and the segmented-min kernel
   (``kernels/noc_step/csrc``), one ``nvcc`` per source, all five in
   parallel; one ``[build] ptxas:`` line per compiled kernel instance
   (registers, stack, spill stores and loads, static shared memory) and the
   attention and SSD instances' dynamic shared memory, held equal to the
   Python mirror that the CPU tests bound by 227 KB;
3. kernel vs plain: on an 8x8 mesh and torus with the paper's Table I
   (``NoCConfig()`` defaults), MU and DPM at two injection rates, both
   routes of the cycle kernel (``cluster_smem``: a thread-block cluster per
   instance; ``block``: one block per instance) must equal the plain
   PyTorch cycle on every output and final plane, each run launching its
   own route once; the same on an 8x8 mesh with 2-flit buffers under worms
   of 1 to 6 flits (the credit-limited branch that Table I's 4-flit
   buffers never take), and on a 32x32 mesh (MU and DPM at rates 0.01 and
   0.03) and torus (rate 0.02), the mesh's two routes timed in turns;
   ``[noc_cycle_layout]`` gives each cluster launch's layout and shared
   memory, held equal to the Python mirror;
4. main path: ``latency_vs_rate_batched`` on a 16x16 mesh, MU/MP/NMP/DPM x 4
   rates in one batched launch through ``xsimulate(device="cuda")``, DPM
   planned in batches on the card (``bulk_plan``); the lowest rate must
   drain, the launch counts (set to 0 just before) must show the cluster
   kernel alone, both routes must equal the plain cycle on the same
   inputs, and the latencies and energies must equal the ones the port
   gave before batched planning; the two routes timed in turns, and alone
   in a child process;
5. cost tables: both routes (``warp``: one warp per packet over its
   destinations, the default; ``block``: one block per packet over all its
   nodes) of ``dpm_cost_table`` and ``dpm_cost_table_weighted`` (hops,
   weighted; energy within rtol 1e-6), and ``dpm_plan``, against their
   plain versions on every request of the 16x16 sweep, an 8x8 torus and an
   8x4 mesh, source leg on and off; then on edge cases: the sweep with an
   empty packet, a packet that lists its own source and a fully dense one
   (16,873 packets: a partial block of the warp route), the same rows 4
   bytes off 16-byte alignment, a 5x3 mesh (rows of 15 nodes), and a dense
   16x16 batch (90% of nodes); then the planning path ``dpm_plan`` /
   ``dpm_plan_weighted`` on the sweep's requests, with the launch counts
   set to 0 before it and read after (the warp route only); the two routes
   timed in turns on the sweep and the dense batch, and alone in a child
   process;
6. batched planning: the sweep's DPM requests through ``bulk_plan`` on the
   card, every plan equal to host ``plan()``, plans/s against host
   ``plan()``; then a few thousand requests through a ``PlanServer``;
7. serving: ``hymba-1.5b`` at full width and depth (random weights from
   seed 0, f32 parameters, bf16 activations) answers 8 requests of
   1,100-2,000 prompt tokens and 16 new tokens each through
   ``BatchServer(device="cuda")`` in 2 batches of 4; each prefill must
   launch the flash-attention and SSD kernels once per layer (32 each), and
   by variant the bf16 tensor-core kernels (``wgmma_bf16``, ``mma_bf16``)
   32 times each and the f32 kernels never, the launch counts set to 0 just
   before and read just after. Then one batch's prefill runs with f32
   activations (the f32 kernels, 32 each) and bf16 activations (the
   tensor-core kernels) on the kernel path and on the plain path (each
   kernel's plain version in its place); the f32 logits must agree within
   1e-3 x max |logit|; greedy tokens of the two paths are printed, not
   asserted (random weights give near-ties). Both kernels are held against
   their plain versions, in bf16 and f32, on q/k/v and SSD inputs captured
   from a full-width prefill (B = 4, S = 2,000: a global and a window
   layer, each also cut to batch 1's 1,377 and as a 64-query q_offset
   chunk; the SSD at hymba's N = 16 and 50 heads in one group, its last
   chunk 208 steps) and on seeded random edge cases (a window whose rows
   start on a fully masked key tile, Sk below one tile, D = 16, 32, 128;
   mamba2's N = 128, two groups at N = 16, the smoke widths' P = 32 at
   N = 32 and at N = 16 with a 100-step chunk);
   then timed, both dtypes, beside SDPA (attention, ``vs_sdpa``) and their
   bounds (``times_bound``), the kernel alone from a child process; and
   one bf16 prefill at batch 0's shape split by kernel family
   (``[prefill_split]``: attention, SSD, matrix products, the rest, and the
   device-busy share of the wall time);
8. segmented min: ``segmin`` and ``arbitrate`` on the card over ten cases
   (tests/test_kernels.py's shapes; xsim's fused link + ejection id space
   at the 8x8, 16x16 and 32x32 grids with B = 4, 16 and 132 instances; the
   16x16 case with padded entries; a 32x32 hot spot of 64 segments) and
   three arbitration rounds (777 x 61, and xsim's 16x16 and 32x32 id spaces
   with unique keys), the launch counts by route (``[segmin_routes]``:
   ``grid``, ``atomic``) set to 0 just before and read just after: the
   one-launch ``grid`` route must launch, the first kernel pair (``atomic``)
   never. Then both routes on each case must equal the plain version
   (``scatter_reduce_`` amin) on the card and on the CPU, and each round,
   fused (``grid``) and unfused (the torch winner test around the
   ``atomic`` pair, the first port's path), the plain path and the
   one-admissible-minimum rule; each route timed alone and through its
   wrapper beside its bound, the rounds fused and unfused;
9. host NoC: ``WormholeSim`` on the paper's configuration (8x8, Table I,
   rate 0.02, 300 cycles), MU and DPM, fed by ``add_requests(device=
   "cuda")`` (DPM planned in batches on the card) and by ``simulate()``:
   identical ``SimStats`` and ``Telemetry``; against ``xsimulate`` on the
   card the same delivery sets, conserved counts and per-link flits, and
   average latency within 10%;
10. the ``kernels`` JSON line (six kernels), then the result line.

Phases 4, 5, 7 and 8 read their kernels' profiler times from a child
process of this script (``python3 chip_smoke.py --noc-cycle-alone``,
``--dpm-cost-alone``, ``--serve-kernel-alone`` and
``--segmin-kernel-alone``), and phase 7 the split of one prefill's time by
kernel family (``--prefill-profile``).

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks at the full 700 W power limit: HBM bandwidth from NVIDIA's
# data sheet; int32 issue rate from the Hopper architecture (64 INT32 lanes
# per SM x 132 SMs x 1.98 GHz boost, one operation per lane and clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# dense bf16 tensor-core peak and the f32 peak outside the tensor cores
# (NVIDIA's H100 SXM data sheet)
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

MAIN_RATES = (0.01, 0.02, 0.03, 0.05)
MAIN_ALGOS = ("MU", "MP", "NMP", "DPM")
MAIN_CYCLES = 600
# the port's results before batched planning, as PERF.md records them:
# batched plans are bit-identical to plan(), so these must not
# move. (phase, topology, rate, algorithm) -> (avg latency, dyn energy pJ)
EARLIER_RESULTS = {
    ("paper8x8", "mesh", 0.02, "DPM"): ("10.2065", "59720.9"),
    ("paper8x8", "mesh", 0.02, "MU"): ("14.2330", "71041.0"),
    ("paper8x8", "mesh", 0.08, "DPM"): ("40.5138", None),
    ("paper8x8", "mesh", 0.08, "MU"): ("78.3345", None),
    ("main", "mesh", 0.01, "DPM"): ("16.4741", "500300.1"),
    ("main", "mesh", 0.01, "MU"): ("19.8097", "604647.4"),
    ("main", "mesh", 0.05, "DPM"): ("145.9750", None),
    ("main", "mesh", 0.05, "MU"): ("212.6223", None),
    ("main", "mesh", 0.03, "MP"): ("137.4744", None),
}
ENERGY_RTOL = 1e-6
PLANSERVE_REQUESTS = 4096
# the serving phase: hymba-1.5b at full width and depth
SERVE_REQUESTS = 8
SERVE_PROMPT = (1100, 2000)  # prompt lengths, over the 1024-token window
SERVE_MAX_TOKENS = 16
SERVE_MAX_BATCH = 4
ATTN_CHECK_B, ATTN_CHECK_S = 4, 2000  # the prefill the kernels' inputs
#                                       are captured from
ATTN_ATOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}
SSD_ATOL = {"torch.bfloat16": 1e-1, "torch.float32": 5e-4}
# edge cases of the kernels' tiles on seeded random inputs:
# attention (label, B, S, H, KH, D, window),
# SSD (label, B, S, H, G, N, P, chunk)
ATTN_EDGE_CASES = (
    ("window_dead_first_tile", 2, 300, 4, 2, 64, 70),
    ("sk_below_one_tile", 2, 40, 4, 2, 64, None),
    ("d16", 2, 333, 4, 2, 16, None),
    ("d32", 2, 333, 4, 1, 32, 100),
    ("d128", 2, 333, 4, 2, 128, 100),
)
SSD_EDGE_CASES = (
    ("groups2_n16", 2, 777, 8, 2, 16, 64, 256),
    ("mamba2_smoke_n32_p32", 2, 100, 8, 1, 32, 32, 32),
    ("short_chunk_n16_p32", 2, 100, 4, 1, 16, 32, 100),
)
# the segmented-min phase: tests/test_kernels.py's shapes (candidates,
# segments), then xsim's fused link + ejection id space at the repo's grids
# (name, mesh side, instances B)
SEGMIN_SHAPES = ((64, 7), (1000, 256), (4096, 64), (37, 300), (512, 320))
SEGMIN_GRIDS = (("paper8x8", 8, 4), ("scale16x16", 16, 16),
                ("mesh32x32", 32, 132))
# arbitrate rounds with unique keys at xsim's id spaces (name, side, B)
SEGMIN_ARBITRATE_GRIDS = (("scale16x16", 16, 16), ("mesh32x32", 32, 132))
SEGMIN_ALONE_REPS = 5  # calls per profiled window of the kernel-alone times
# the host-simulator phase: the paper's configuration
HOST_SIM_RATE, HOST_SIM_CYCLES = 0.02, 300


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def compare(kern: dict, plain: dict) -> tuple[list[str], float]:
    """Names of the arrays that differ and the largest absolute difference
    over every compared array (outputs and final planes)."""
    import torch

    bad, err = [], 0.0
    pairs = [(k, kern[k], plain[k]) for k in ("dtime", "ctr", "crel", "lutil",
                                               "rconf")]
    pairs += [(f"planes.{f}", a, b) for f, a, b in zip(
        kern["planes"]._fields, kern["planes"], plain["planes"])]
    for name, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{name}(shape/dtype)")
            err = float("inf")
            continue
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        m = float(d.max()) if d.numel() else 0.0
        err = max(err, m)
        if m != 0:
            first = tuple(int(i) for i in (d != 0).nonzero()[0])
            bad.append(f"{name}@{first}")
    return bad, err


def engine_inputs(res, cfg, device):
    """The inputs ``xsimulate`` handed the engine, rebuilt from its results."""
    from repro_torch.noc.xsim.compile import geometry_tables, traffic_from_numpy

    tr = traffic_from_numpy(res.traffic, device)
    st = res.traffic
    geom = geometry_tables(cfg.topology, cfg.n, cfg.rows, (), cfg.vcs_per_class)
    kw = dict(
        T=res.cycles, F=max(cfg.flits_per_packet, int(st["flits"].max())),
        V=cfg.vcs_per_class, BD=cfg.buffer_depth, L=cfg.num_nodes * 4,
        NN=cfg.num_nodes, ND=int(st["dslot"].max()) + 1,
        epoch_len=res.epoch_len,
    )
    return tr, geom, kw


def timed(fn):
    """``fn()`` and its time on the card in ms (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def run_both(tr, geom, kw, variant=None):
    """The kernel (through ``run_cycles``, on route ``variant``) and the
    plain version by name, on the same CUDA tensors; returns both outputs
    and their times (ms)."""
    from repro_torch.kernels.noc_cycle import (
        TABLE_FIELDS, geometry_tensors, run_cycles, run_cycles_ref,
    )

    kern, k_ms = timed(lambda: run_cycles(tr, geom, variant=variant, **kw))
    T = kw["T"]
    EPL = max(kw["epoch_len"] or T, 1)
    E = max(1, -(-T // EPL))
    rkw = {k: v for k, v in kw.items() if k != "epoch_len"}

    def plain_fn():
        planes, dtime = run_cycles_ref(
            {f: tr[f] for f in TABLE_FIELDS}, tr["dslot"],
            geometry_tensors(geom, tr["link"].device), EPL=EPL, E=E, **rkw,
        )
        crel = (planes.crtime >= 0) & (planes.crtime < T)
        return {"dtime": dtime, "ctr": planes.ctr, "crel": crel,
                "lutil": planes.lutil, "rconf": planes.rconf,
                "planes": planes}

    plain, p_ms = timed(plain_fn)
    return kern, plain, k_ms, p_ms


def first_divergence(tr, geom, kw, variant) -> None:
    """Bisect the first cycle count after which kernel and plain differ and
    print what differs there (a diagnostic for a failed comparison)."""
    lo, hi = 0, kw["T"]  # equal after lo cycles, different after hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        kern, plain, _, _ = run_both(tr, geom, dict(kw, T=mid), variant)
        if compare(kern, plain)[0]:
            hi = mid
        else:
            lo = mid
    kern, plain, _, _ = run_both(tr, geom, dict(kw, T=hi), variant)
    say("divergence", variant=variant, first_bad_cycle=hi - 1,
        differs=",".join(compare(kern, plain)[0]))


def check_routes(grid: str, tr, geom, kw, **extra) -> tuple[dict, dict, float]:
    """Both routes of the cycle kernel (``cluster_smem``, ``block``) against
    one run of the plain cycle on the same inputs: every output and final
    plane equal, and each run launching its own route once (the counts set
    to 0 just before and read just after). Prints one ``[kernel_vs_plain]``
    line per route and the cluster's ``[noc_cycle_layout]``; returns the
    kernels' outputs, the plain output and its time (ms)."""
    from repro_torch.kernels.noc_cycle import KERNEL, VARIANTS, run_cycles

    kerns, plain, p_ms = {}, None, 0.0
    for variant in VARIANTS:
        KERNEL.reset()
        if plain is None:
            kern, plain, k_ms, p_ms = run_both(tr, geom, kw, variant)
        else:
            kern, k_ms = timed(
                lambda: run_cycles(tr, geom, variant=variant, **kw))
        counts = dict(KERNEL.variants)
        if counts != {v: int(v == variant) for v in VARIANTS}:
            fail(f"{grid}: route {variant} launched {counts}")
        bad, err = compare(kern, plain)
        say("kernel_vs_plain", grid=grid, variant=variant,
            instances=tr["link"].shape[0], cycles=kw["T"], equal=not bad,
            max_abs_err=err, kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}",
            **extra)
        if variant == "cluster_smem":
            layout_line(grid)
        if bad:
            first_divergence(tr, geom, kw, variant)
            fail(f"{variant} kernel != plain on {grid}: {', '.join(bad)}")
        kerns[variant] = kern
    return kerns, plain, p_ms


def layout_line(grid: str) -> None:
    """The last cluster launch's layout, its per-rank dynamic shared memory
    as the library computes it, and a failure if the Python mirror that the
    CPU tests bound says otherwise."""
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.kernels.noc_cycle.noc_cycle import cluster_smem_bytes

    c = KERNEL.cluster
    got = KERNEL.build().noc_cycle_cluster_smem_bytes(c["NR"], c["D"],
                                                      c["W"], c["CC"])
    say("noc_cycle_layout", grid=grid, cluster_k=c["K"],
        routers_per_rank=c["NR"], children_per_rank=c["CC"],
        dynamic_smem=got, threads=c["threads"],
        resident_clusters=c["resident_clusters"])
    if got != c["smem"] or got != cluster_smem_bytes(c["NR"], c["D"],
                                                     c["W"], c["CC"]):
        fail(f"cluster smem mirror: library {got}, wrapper {c['smem']}")


def time_routes(tr, geom, kw) -> dict:
    """Each route's time on the same inputs, in turns (block, cluster,
    cluster, block, block, cluster): ``{variant: (median ms, runs)}``."""
    from repro_torch.kernels.noc_cycle import VARIANTS, run_cycles

    runs = {v: [] for v in VARIANTS}
    for v in ("block", "cluster_smem", "cluster_smem", "block", "block",
              "cluster_smem"):
        runs[v].append(timed(lambda: run_cycles(tr, geom, variant=v, **kw))[1])
    return {v: (sorted(r)[len(r) // 2], r) for v, r in runs.items()}


def roofline(nbytes: int, ops: int, ops_per_s: float) -> tuple[float, str, int, int]:
    """The larger of ``nbytes`` over HBM bandwidth and ``ops`` over
    ``ops_per_s``, in ms, with which of the two it was."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def bound_ms(tr, kern, kw) -> tuple[float, str, int, int]:
    """Least time the card could take for one ``run_cycles`` call, the larger
    of two times. Bytes: what this run's data needs the engine to read once
    (the table entries of real packets, stages, lane slots and children,
    not the padding, plus the router geometry) and write once (every output
    and final plane), over HBM bandwidth. Operations: an integer-operation
    count over the int32 issue rate, per cycle and instance ~30 per
    flattened candidate (admissibility, key, VC pick), 3 per (output link,
    input port) pair of the arbitration, ~15 per FIFO/lane move, ~6 per
    chl entry and ~8 per child, times all T cycles (the engine runs every
    cycle whatever the load)."""
    B = tr["link"].shape[0]
    C = tr["child_parent"].shape[1]
    QC = tr["chl"].shape[2]
    L, NN, V, T = kw["L"], kw["NN"], kw["V"], kw["T"]
    W = 2 * V
    D = L // NN
    candp = L * W + 2 * NN + 1
    valid = tr["valid"]
    words = (
        3 * int(valid.sum())  # enqueue, num_stages, flits
        + 3 * int(tr["num_stages"][valid].sum())  # link, vcls, dslot
        + int((tr["lane_seq"] >= 0).sum()) + int((tr["chl"] >= 0).sum())
        + 5 * int((tr["parent"] >= 0).sum())  # the five child tables
        + NN * (D * W + 2) + candp  # node_ports, cand_port
    )
    outs = [kern["dtime"], kern["crel"], kern["lutil"], kern["rconf"],
            *kern["planes"]]
    nbytes = 4 * words + sum(t.numel() * t.element_size() for t in outs)
    per_cycle = (30 * candp + 3 * L * (D * W + 2) + 15 * (L * W + 2 * NN)
                 + 6 * NN * QC + 8 * C)
    ops = per_cycle * T * B
    return roofline(nbytes, ops, INT32_OPS_PER_S)


def check_earlier(phase: str, topo: str, rate: float, algo: str,
                  latency: str, energy: str | None) -> None:
    """Fail if a result listed in ``EARLIER_RESULTS`` moved."""
    want = EARLIER_RESULTS.get((phase, topo, rate, algo))
    if want is None:
        return
    if latency != want[0] or (want[1] is not None and energy != want[1]):
        fail(f"{phase} {topo} {rate} {algo}: latency {latency}, energy "
             f"{energy}; before batched planning {want[0]}, {want[1]}")


def build_kernels() -> None:
    """Build every kernel library at once, one ``nvcc`` per source."""
    from repro_torch.kernels.dpm_cost import KERNEL as DPM_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.kernels.noc_step import KERNEL as SEGMIN_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL

    kernels = [("noc_cycle", KERNEL), ("dpm_cost", DPM_KERNEL),
               ("flash_attention", FLASH_KERNEL), ("ssd", SSD_KERNEL),
               ("noc_step", SEGMIN_KERNEL)]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(k.build) for _, k in kernels]:
            f.result()
    wall = time.monotonic() - t0
    for name, k in kernels:
        say("build", library=name, seconds=f"{wall:.2f}",
            nvcc_seconds=f"{k.build_seconds:.2f}")
        for kernel, report in ptxas_report(k.build_log):
            print(f"[build] ptxas: library={name} kernel={kernel} {report}",
                  flush=True)
    check_smem_mirrors(FLASH_KERNEL.build(), SSD_KERNEL.build())


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a kernel from its mangled name: the identifier
    (the last one of a nested name, never a parameter type) and the
    template arguments (``f32`` for float, integers and booleans as they
    are)."""
    nested = mangled.startswith("_ZN")
    s, p, name = mangled, 3 if nested else 2, mangled
    while p < len(s) and s[p].isdigit():
        q = p
        while s[q].isdigit():
            q += 1
        n = int(s[p:q])
        name, p = s[q:q + n], q + n
        if not nested:
            break
    if p >= len(s) or s[p] != "I":
        return name
    block = s[p:s.find("EEv", p) + 1]
    args = (["f32"] if block.startswith("If") else []) + re.findall(
        r"L[ib](\d+)E", block)
    return f"{name}<{','.join(args)}>"


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, report) per kernel from ``nvcc -Xptxas -v``: registers,
    stack, spill stores and loads (bytes) and static shared memory; the
    dynamic shared memory of the attention and SSD kernels is checked and
    printed by ``check_smem_mirrors``."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = f"stack={m[1]} spill_stores={m[2]} spill_loads={m[3]}"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m[2])
            out.append((name, f"registers={m[1]} {frame} "
                              f"static_smem={smem[1] if smem else 0}"))
            name = None
    return out


def check_smem_mirrors(flash_lib, ssd_lib) -> None:
    """Print each attention and SSD kernel instance's dynamic shared memory
    as its library computes it, and fail if the Python mirror that the CPU
    tests hold to the 227 KB limit says otherwise."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        HEAD_DIMS, smem_bytes as flash_smem,
    )
    from repro_torch.kernels.ssd.ssd import (
        TC_MAX_CHUNK, TC_SHAPES, smem_bytes as ssd_smem,
    )

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = int(dtype == torch.bfloat16)
        name = "flash_fwd_tc_kernel" if bf16 else "flash_fwd_kernel<f32>"
        for D in HEAD_DIMS:
            got = flash_lib.flash_attention_smem_bytes(bf16, D)
            say("build", smem=f"{name}<{D}>", dynamic_smem=got)
            if got != flash_smem(dtype, D):
                fail(f"flash smem mirror: {got} != {flash_smem(dtype, D)}")
        name = "ssd_intra_tc_kernel" if bf16 else "ssd_intra_kernel<f32>"
        for N, P in TC_SHAPES:
            args = (TC_MAX_CHUNK, N, P)
            got = ssd_lib.ssd_intra_chunk_smem_bytes(bf16, *args)
            say("build", smem=f"{name}<{N},{P}>", chunk=TC_MAX_CHUNK,
                dynamic_smem=got)
            if got != ssd_smem(dtype, *args):
                fail(f"SSD smem mirror: {got} != {ssd_smem(dtype, *args)}")


def profiled_ms(fn, match: str = "") -> tuple[float | None, int]:
    """Device time (ms) and launch count of the CUDA kernels whose names
    contain ``match`` in one call of ``fn``, from ``torch.profiler``; None
    when the trace holds no device time for them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0 and match in e.key and e.device_type == DeviceType.CUDA:
            total += t
            count += e.count
    return (total / 1e3 if count else None), count


def median_ms(fn, reps: int = 3):
    """``fn()``'s last output and its median time on the card in ms."""
    runs = [timed(fn) for _ in range(reps)]
    return runs[-1][0], sorted(t for _, t in runs)[reps // 2]


def tensor_diff(a, b) -> tuple[bool, float]:
    """(exactly equal, max absolute difference) of two tensors."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if a.numel() == 0:
        return True, 0.0
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return bool(torch.equal(a, b)), float(d.max())


def dpm_inputs(g, reqs, device):
    """(dest_mask (P, NN) int32, src_xy (P, 2) int32) on ``device``: one row
    per request, nodes row-major."""
    import numpy as np
    import torch

    mask = np.zeros((len(reqs), g.num_nodes), np.int32)
    sxy = np.zeros((len(reqs), 2), np.int32)
    for i, (src, dests) in enumerate(reqs):
        sxy[i] = src
        for d in dests:
            mask[i, g.idx(d)] = 1
    return (torch.from_numpy(mask).to(device),
            torch.from_numpy(sxy).to(device))


def dpm_bound_ms(mask, wrap: bool, weighted: bool) -> tuple[float, str, int, int]:
    """Least time the card could take for one cost table, the larger of two
    times. Bytes: the mask and sources read once (and the two (NN, NN)
    route tensors for the weighted table), costs and reps written once, over
    HBM bandwidth. Operations: int32 operations over the int32 issue rate,
    counted from this run's data: per (packet, node) the coordinates, the
    displacement from the source, the wedge, the mask test, the key and its
    minimum (13 on a mesh, 19 on a torus, where each displacement takes a
    floor-mod); per (destination, candidate holding it), 6 per destination,
    the distance from the representative and its sum (6 on a mesh, 12 on a
    torus; 3 for a weighted row read, sum and count); per (packet,
    candidate) the representative from its wedges and the leg (12)."""
    P, NN = mask.shape
    nbytes = 4 * (P * NN + 2 * P + 2 * 24 * P)
    if weighted:
        nbytes += 2 * 4 * NN * NN
    dests = int(mask.sum())
    per_node = 19 if wrap else 13
    per_pair = 3 if weighted else (12 if wrap else 6)
    ops = P * NN * per_node + dests * 6 * per_pair + P * 24 * 12
    return roofline(nbytes, ops, INT32_OPS_PER_S)


def sweep_requests(cfg) -> list:
    """Every request of the 16x16 sweep, all rates, as (src, dests)."""
    from repro_torch.noc import synthetic_workload

    wls = [synthetic_workload(cfg, r, MAIN_CYCLES, seed=0) for r in MAIN_RATES]
    return [(r.src, r.dests) for wl in wls for r in wl.requests]


DPM_COST_CASES = ROOT / "build" / "dpm_cost_cases.pt"
DPM_TABLES = ("dpm_cost_table", "dpm_cost_table_weighted")
# each cost-table kernel's name in the profiler, by (table, route)
DPM_KERNEL_NAMES = {
    ("dpm_cost_table", "warp"): "cost_table_warp_kernel",
    ("dpm_cost_table", "block"): "cost_table_kernel",
    ("dpm_cost_table_weighted", "warp"): "cost_table_weighted_warp_kernel",
    ("dpm_cost_table_weighted", "block"): "cost_table_weighted_kernel",
}


def dpm_cost_calls(mask, sxy, dist, w, oh) -> dict:
    """``{(table, route): call}`` on one 16x16 mesh batch, source leg on,
    the weighted table under ``(dist, w, oh)``."""
    import functools

    from repro_torch.kernels.dpm_cost import (
        VARIANTS, dpm_cost_table, dpm_cost_table_weighted,
    )

    calls = {}
    for v in VARIANTS:
        calls["dpm_cost_table", v] = functools.partial(
            dpm_cost_table, mask, sxy, n=16, variant=v)
        calls["dpm_cost_table_weighted", v] = functools.partial(
            dpm_cost_table_weighted, mask, sxy, dist, w, n=16, overhead=oh,
            variant=v)
    return calls


def dpm_cost_alone() -> None:
    """``--dpm-cost-alone``: print one JSON line with the profiler's device
    time of one launch of each route of each cost table on each batch that
    the parent saved to ``build/dpm_cost_cases.pt`` (the sweep's requests
    and the dense batch), taken in a fresh process."""
    import torch

    cases = torch.load(DPM_COST_CASES, weights_only=False)
    out = {}
    for name, args in cases.items():
        out[name] = {f"{t}/{v}": profiled_ms(fn, DPM_KERNEL_NAMES[t, v])[0]
                     for (t, v), fn in dpm_cost_calls(*args).items()}
    print(json.dumps(out), flush=True)


def time_dpm_routes(calls: dict) -> dict:
    """Each table's routes through the wrapper on the same inputs, in turns
    (block, warp, warp, block, block, warp): ``{(table, route): (median ms,
    runs)}``."""
    runs = {k: [] for k in calls}
    for v in ("block", "warp", "warp", "block", "block", "warp"):
        for t in DPM_TABLES:
            runs[t, v].append(timed(calls[t, v])[1])
    return {k: (sorted(r)[len(r) // 2], r) for k, r in runs.items()}


def dpm_edge_batches(mask, sxy, device) -> list:
    """(label, topology, wrap, mask, src_xy) of the edge cases: the sweep's
    requests with packet 0 emptied, packet 1 listing its own source and
    packet 2 listing every node; the same rows 4 bytes past 16-byte
    alignment; a 5x3 mesh (rows of 15 nodes) and a 16x16 batch whose
    packets list 90% of the nodes, both seeded."""
    import numpy as np
    import torch

    from repro_torch.core import make_topology

    P, NN = mask.shape
    edge = mask.clone()
    edge[0] = 0
    edge[1, int(sxy[1, 1]) * 16 + int(sxy[1, 0])] = 1
    edge[2] = 1
    buf = torch.zeros(P * NN + 4, dtype=torch.int32, device=device)
    unaligned = buf[1:1 + P * NN].view(P, NN)
    unaligned.copy_(edge)
    if unaligned.data_ptr() % 16 == 0:
        fail("the unaligned rows are 16-byte aligned")
    rng = np.random.default_rng(17)

    def seeded(n, m, P, density):
        mk = (rng.random((P, n * m)) < density).astype(np.int32)
        xy = np.stack([rng.integers(0, n, P), rng.integers(0, m, P)], 1)
        mk[0] = 0
        mk[1, xy[1, 1] * n + xy[1, 0]] = 1
        mk[2] = 1
        return (torch.from_numpy(mk).to(device),
                torch.from_numpy(xy.astype(np.int32)).to(device))

    g16 = make_topology("mesh", 16, 16)
    return [
        ("sweep16x16_edges", g16, False, edge, sxy),
        ("sweep16x16_unaligned", g16, False, unaligned, sxy),
        ("mesh5x3", make_topology("mesh", 5, 3), False, *seeded(5, 3, 4099, 0.3)),
        ("dense16x16", g16, False, *seeded(16, 16, P, 0.9)),
    ]


def phase_cost_tables(cfg16) -> list:
    """Both routes of both cost-table kernels, and ``dpm_plan``, against
    their plain versions on three fabrics and the edge cases; the planning
    path with the counts zeroed; the routes' times. Returns the
    kernels-line entries of the two kernels."""
    import torch

    from repro_torch.core import (
        get_cost_model, make_topology, route_cost_matrices,
    )
    from repro_torch.kernels.dpm_cost import (
        KERNEL as DPM_KERNEL, VARIANTS, dpm_cost_table, dpm_cost_table_ref,
        dpm_cost_table_weighted, dpm_cost_table_weighted_ref, dpm_plan,
        dpm_plan_weighted,
    )
    from repro_torch.kernels.dpm_cost.ops import _greedy_merge
    from repro_torch.noc import NoCConfig, synthetic_workload

    def small_requests(cfg):
        wls = [synthetic_workload(cfg, r, MAIN_CYCLES, seed=0)
               for r in (0.02, 0.08)]
        return [(r.src, r.dests) for wl in wls for r in wl.requests]

    def route_tensors(g, model):
        dist, w, oh = route_cost_matrices(g, get_cost_model(model))
        return (torch.from_numpy(dist.astype("float32")).cuda(),
                torch.from_numpy(w).cuda(), oh)

    def plan_equal(plan_k, pc, pr) -> tuple[bool, float]:
        diffs = [tensor_diff(a, b)
                 for a, b in zip(plan_k, (_greedy_merge(pc, pr), pc, pr))]
        return all(e for e, _ in diffs), max(d for _, d in diffs)

    g16 = make_topology("mesh", 16, 16)
    mask16, sxy16 = dpm_inputs(g16, sweep_requests(cfg16), "cuda")
    batches = [("sweep16x16", g16, False, mask16, sxy16)]
    for label, kind, n, m, cfg in (
            ("torus8x8", "torus", 8, 8,
             NoCConfig(topology="torus", dest_range=(4, 8))),
            ("mesh8x4", "mesh", 8, 4, NoCConfig(n=8, m=4, dest_range=(4, 8)))):
        g = make_topology(kind, n, m)
        batches.append((label, g, kind == "torus",
                        *dpm_inputs(g, small_requests(cfg), "cuda")))
    batches += dpm_edge_batches(mask16, sxy16, "cuda")
    errs = dict.fromkeys(DPM_TABLES, 0.0)
    for label, g, wrap, mask, sxy in batches:
        n, m = g.n, g.rows
        P, NN = mask.shape
        routes = {model: route_tensors(g, model)
                  for model in ("hops", "weighted", "energy")}
        for leg in (True, False):
            kw = dict(n=n, m=m, wrap=wrap, include_source_leg=leg)
            pc, pr = dpm_cost_table_ref(mask, sxy, **kw)
            for v in VARIANTS:
                kc, kr = dpm_cost_table(mask, sxy, **kw, variant=v)
                (eq_c, err_c), (eq_r, err_r) = tensor_diff(kc, pc), tensor_diff(kr, pr)
                err = max(err_c, err_r)
                errs["dpm_cost_table"] = max(errs["dpm_cost_table"], err)
                say("kernel_vs_plain", kernel="dpm_cost_table", route=v,
                    grid=label, leg=leg, P=P, NN=NN, equal=eq_c and eq_r,
                    max_abs_err=err)
                if not (eq_c and eq_r):
                    fail(f"dpm_cost_table ({v}) != plain on {label} leg={leg}")
            eq, err = plan_equal(dpm_plan(mask, sxy, **kw, device="cuda"),
                                 pc, pr)
            say("kernel_vs_plain", kernel="dpm_plan", grid=label, leg=leg,
                P=P, outputs="chosen/costs/reps", equal=eq, max_abs_err=err)
            if not eq:
                fail(f"dpm_plan != plain on {label} leg={leg}")
            for model, (dist, w, oh) in routes.items():
                wkw = dict(kw, overhead=oh)
                pc, pr = dpm_cost_table_weighted_ref(mask, sxy, dist, w, **wkw)
                exact = model != "energy"
                for v in VARIANTS:
                    kc, kr = dpm_cost_table_weighted(mask, sxy, dist, w, **wkw,
                                                     variant=v)
                    (eq_c, err_c), (eq_r, err_r) = (tensor_diff(kc, pc),
                                                    tensor_diff(kr, pr))
                    err = max(err_c, err_r)
                    errs["dpm_cost_table_weighted"] = max(
                        errs["dpm_cost_table_weighted"], err)
                    rel = float(((kc - pc).abs()
                                 / pc.abs().clamp(min=1e-30)).max())
                    ok = eq_r and (eq_c if exact else rel <= ENERGY_RTOL)
                    say("kernel_vs_plain", kernel="dpm_cost_table_weighted",
                        route=v, grid=label, model=model, leg=leg, P=P,
                        NN=NN, equal=eq_c and eq_r, max_abs_err=err,
                        max_rel_err=f"{rel:.3g}",
                        tolerance="exact" if exact else f"rtol={ENERGY_RTOL}")
                    if not ok:
                        fail(f"dpm_cost_table_weighted ({v}) != plain on "
                             f"{label} {model} leg={leg}")
                if exact:
                    eq, _ = plan_equal(dpm_plan_weighted(
                        mask, sxy, dist, w, **wkw, device="cuda"), pc, pr)
                    if not eq:
                        fail(f"dpm_plan_weighted != plain on {label} "
                             f"{model} leg={leg}")

    # the planning path: dpm_plan and dpm_plan_weighted (hops, weighted) on
    # every request of the sweep, the launch counts set to 0 just before
    # and read just after
    tensors = {model: route_tensors(g16, model) for model in ("hops", "weighted")}
    DPM_KERNEL.reset()
    chosen, _, _ = dpm_plan(mask16, sxy16, n=16, device="cuda")
    for model, (dist, w, oh) in tensors.items():
        dpm_plan_weighted(mask16, sxy16, dist, w, n=16, overhead=oh,
                          device="cuda")
    torch.cuda.synchronize()
    launches = dict(DPM_KERNEL.launches)
    by_route = dict(DPM_KERNEL.variant_launches)
    for name in DPM_TABLES:
        if by_route[f"{name}/warp"] <= 0 or by_route[f"{name}/block"] != 0:
            fail(f"the planning path launched {name} off the warp route: "
                 f"{by_route}")
    say("dpm_path", requests=mask16.shape[0],
        launches=",".join(f"{k}:{v}" for k, v in by_route.items()),
        merged_partitions=int(chosen[:, 8:].sum()),
        partitions_per_request=f"{float(chosen.sum()) / mask16.shape[0]:.4f}")

    # times: the routes in turns through the wrappers, the plain versions,
    # and each kernel alone from a child process, on the sweep and the
    # dense batch (mesh, source leg on, hops prices)
    dist, w, oh = tensors["hops"]
    dense = next(b for b in batches if b[0] == "dense16x16")
    timed_batches = {"sweep16x16": (mask16, sxy16),
                     "dense16x16": (dense[3], dense[4])}
    DPM_COST_CASES.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: (mk, xy, dist, w, oh)
                for k, (mk, xy) in timed_batches.items()}, DPM_COST_CASES)
    alone = child_json("--dpm-cost-alone")
    DPM_COST_CASES.unlink()
    plain_ms = {
        "dpm_cost_table": median_ms(
            lambda: dpm_cost_table_ref(mask16, sxy16, n=16))[1],
        "dpm_cost_table_weighted": median_ms(
            lambda: dpm_cost_table_weighted_ref(mask16, sxy16, dist, w, n=16,
                                                overhead=oh))[1],
    }
    sweep_ms = {}
    for batch, (mk, xy) in timed_batches.items():
        routes = time_dpm_routes(dpm_cost_calls(mk, xy, dist, w, oh))
        for name in DPM_TABLES:
            b_ms, b_by, nbytes, ops = dpm_bound_ms(
                mk, False, name == "dpm_cost_table_weighted")
            (warp_ms, warp_runs), (blk_ms, blk_runs) = (
                routes[name, "warp"], routes[name, "block"])
            say("dpm_routes", kernel=name, batch=batch, P=mk.shape[0],
                destinations=int(mk.sum()), warp_ms=f"{warp_ms:.4f}",
                block_ms=f"{blk_ms:.4f}",
                warp_ms_runs=",".join(f"{t:.4f}" for t in warp_runs),
                block_ms_runs=",".join(f"{t:.4f}" for t in blk_runs),
                block_over_warp=f"{blk_ms / warp_ms:.2f}")
            for v, ms in (("warp", warp_ms), ("block", blk_ms)):
                t_alone = alone[batch][f"{name}/{v}"]
                if t_alone is None:
                    fail(f"no device time for {name} ({v}) on {batch}")
                say("dpm_bound", kernel=name, batch=batch, route=v,
                    bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes,
                    ops=ops, kernel_alone_ms=f"{t_alone:.4f}",
                    alone_times_bound=f"{t_alone / b_ms:.2f}",
                    wrapper_ms=f"{ms:.4f}",
                    wrapper_times_bound=f"{ms / b_ms:.2f}",
                    **({"plain_ms": f"{plain_ms[name]:.4f}"}
                       if batch == "sweep16x16" else {}))
            if batch == "sweep16x16":
                sweep_ms[name] = (warp_ms, b_ms, b_by)
    return [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/dpm_cost/csrc/dpm_cost.cu",
        "replaces": ("src/repro/kernels/dpm_cost/dpm_cost.py:169"
                     if name == "dpm_cost_table"
                     else "src/repro/kernels/dpm_cost/dpm_cost.py:213"),
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": sweep_ms[name][0],
        "plain_ms": plain_ms[name],
        "bound_ms": sweep_ms[name][1],
        "bound_by": sweep_ms[name][2],
        "library_ms": None,
    } for name in DPM_TABLES]


def phase_bulk_plan(cfg16) -> None:
    """The sweep's requests through ``bulk_plan`` on the card against host
    ``plan()`` on the same requests; then a ``PlanServer``."""
    import torch

    import repro_torch.core.batch_planner as bpm
    from repro_torch.core import (
        arena_clear, bulk_plan, canonical_dests, make_topology, plan,
        plan_cache_clear, planner_for,
    )
    from repro_torch.serve import PlanServer

    g = make_topology("mesh", 16, 16)
    reqs = sweep_requests(cfg16)
    arena_clear()
    bp = planner_for(g, "DPM", device="cuda")
    t0 = time.monotonic()
    bp._tables()
    torch.cuda.synchronize()
    tables_s = time.monotonic() - t0
    t0 = time.monotonic()
    plans = bulk_plan(g, reqs, "DPM", device="cuda")
    bulk_s = time.monotonic() - t0
    info = bp.info()
    plan_cache_clear()
    t0 = time.monotonic()
    host = [plan("DPM", g, src, dests) for src, dests in reqs]
    host_s = time.monotonic() - t0
    bad = [i for i, (a, b) in enumerate(zip(plans, host)) if a != b]
    if bad:
        fail(f"bulk_plan != plan() on {len(bad)} of {len(reqs)} requests, "
             f"first {reqs[bad[0]]}")

    # the device pass alone (CUDA events, from the first launch to the
    # last result) and the host decode alone, on the same unique keys
    keys = list(dict.fromkeys(
        (tuple(src), canonical_dests(dests)) for src, dests in reqs))
    chunks = [keys[i:i + bpm.DISPATCH_CHUNK]
              for i in range(0, len(keys), bpm.DISPATCH_CHUNK)]
    outs, exact_ms = timed(lambda: [bp._dispatch(ck) for ck in chunks])
    kernels_ms, n_kernels = profiled_ms(
        lambda: [bp._dispatch(ck) for ck in chunks])
    t0 = time.monotonic()
    lists = [[x.tolist() for x in out[:4]] for out in outs]
    copy_s = time.monotonic() - t0
    t0 = time.monotonic()
    decoded = [
        bp._decode(src, dests, ch[b], od[b], rp[b], md[b])
        for ck, (ch, od, rp, md) in zip(chunks, lists)
        for b, (src, dests) in enumerate(ck)
    ]
    decode_s = time.monotonic() - t0
    if decoded != [bp.plan_one(src, list(dests)) for src, dests in keys]:
        fail("a second decode differs from the arena's plans")
    say("bulk_plan", requests=len(reqs), unique=len(keys),
        batched_plans=info.batched_plans, host_plans=info.host_plans,
        dispatches=info.dispatches, hits=info.hits, equal_to_plan=True,
        tables_s=f"{tables_s:.3f}", bulk_plan_s=f"{bulk_s:.3f}",
        exact_device_span_ms=f"{exact_ms:.3f}",
        exact_kernels_ms="not measured" if kernels_ms is None
        else f"{kernels_ms:.3f}", exact_kernel_launches=n_kernels,
        copy_s=f"{copy_s:.3f}",
        decode_s=f"{decode_s:.3f}", host_plan_s=f"{host_s:.3f}",
        plans_per_s=f"{len(reqs) / bulk_s:.0f}",
        host_plans_per_s=f"{len(reqs) / host_s:.0f}",
        speedup=f"{host_s / bulk_s:.2f}")

    arena_clear()
    sub = keys[:PLANSERVE_REQUESTS]
    with PlanServer(g, "DPM", device="cuda") as ps:
        ps.planner._tables()
        t0 = time.monotonic()
        futs = [ps.submit(src, list(dests)) for src, dests in sub]
        served = [f.result(timeout=600) for f in futs]
        serve_s = time.monotonic() - t0
    bad = [i for i, (src, dests) in enumerate(sub)
           if served[i] != plan("DPM", g, src, list(dests))]
    if bad:
        fail(f"PlanServer != plan() on {len(bad)} of {len(sub)} requests")
    say("planserve", requests=ps.stats["requests"],
        batches=ps.stats["batches"], batched_plans=ps.info().batched_plans,
        equal_to_plan=True, serve_s=f"{serve_s:.3f}",
        plans_per_s=f"{len(sub) / serve_s:.0f}")


# ---------------------------------------------------------------------------
# the ML serving path: hymba-1.5b through BatchServer, flash attention and
# the SSD intra-chunk kernel
# ---------------------------------------------------------------------------
def patched(*triples) -> contextlib.ExitStack:
    """Set ``(module, name, value)`` attributes until the returned stack
    closes (use it in a ``with``)."""
    stack = contextlib.ExitStack()
    for module, name, value in triples:
        stack.enter_context(mock.patch.object(module, name, value))
    return stack


def plain_path():
    """The serving path with each kernel's plain version in its place on the
    card: the attention of ``flash_attention_ref`` and the SSD scan of
    ``models.ssm.ssd_scan`` (a comparison harness; the port itself has no
    switch that turns a kernel off)."""
    import repro_torch.models.attention as attention
    import repro_torch.models.ssm as ssm
    from repro_torch.kernels.flash_attention import flash_attention_ref

    def attn(q, k, v, *, causal, window, device):
        return flash_attention_ref(q, k, v, causal=causal, window=window)

    def scan(*args, device):
        return ssm.ssd_scan(*args, return_state=True)

    return patched((attention, "flash_attention", attn),
                   (ssm, "ssd_scan_kernel", scan))


def capture_inputs(params, cfg, run, tokens) -> tuple[list, list]:
    """One prefill of ``tokens``, recording the inputs of every attention
    and SSD-scan call of the first two layers (hymba_g, then hymba_w)."""
    import repro_torch.models.attention as attention
    import repro_torch.models.ssm as ssm
    from repro_torch.models import prefill

    attn_calls, scan_calls = [], []
    attn_fn, scan_fn = attention.flash_attention, ssm.ssd_scan_kernel

    def attn(q, k, v, **kw):
        if len(attn_calls) < 2:
            attn_calls.append((q, k, v, kw["window"]))
        return attn_fn(q, k, v, **kw)

    def scan(*args, **kw):
        if len(scan_calls) < 2:
            scan_calls.append(args)
        return scan_fn(*args, **kw)

    with patched((attention, "flash_attention", attn),
                 (ssm, "ssd_scan_kernel", scan)):
        prefill(params, {"tokens": tokens}, cfg, run)
    return attn_calls, scan_calls


def attention_bound_ms(q, k, v, window, q_offset=0) -> tuple[float, str, int, int]:
    """Least time the card could take for one attention call: the larger of
    q, k, v read once and the output written once over HBM bandwidth, and
    4 D operations per visible (query, key) pair (QK^T and PV, multiply and
    add; the causal and window masks counted exactly) over the bf16
    tensor-core rate."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    pairs = int(attention_mask(Sq, Sk, causal=True, window=window,
                               q_offset=q_offset, device=q.device).sum())
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    ops = 4 * D * pairs * B * H
    return roofline(nbytes, ops, BF16_FLOPS_PER_S)


def ssd_bound_ms(x, Bm, L) -> tuple[float, str, int, int]:
    """Least time the card could take for one intra-chunk pass: the larger
    of x, dt, B, C read once (B and C once per group) and y, sc, dec, cum
    written once (f32) over HBM bandwidth, and the operations of each real
    chunk (length l <= L: 2 N and 2 P per causal pair for C.B and M.X, 2 N P
    per step for the state) over the bf16 tensor-core rate."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // L)
    es = x.element_size()
    nbytes = (B_ * S * H * P * es + B_ * S * H * 4 + 2 * B_ * S * G * N * es
              + 4 * (B_ * nc * L * H * P + B_ * nc * H * N * P
                     + B_ * nc * H + B_ * nc * L * H))
    ops = 0
    for c in range(nc):
        ln = min(L, S - c * L)
        ops += ln * (ln + 1) // 2 * 2 * (N + P) + 2 * N * P * ln
    ops *= B_ * H
    return roofline(nbytes, ops, BF16_FLOPS_PER_S)


def dead_first_tile_rows(Sq: int, Sk: int, window, q_offset: int) -> int:
    """Query rows whose first walked key tile sees none of their keys, under
    the bf16 kernel's tile walk (128-row query tiles, 64-key tiles from the
    window's first live tile up): the rows whose -1e30 terms the online
    softmax must cancel."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        TC_BK, TC_BQ,
    )

    n = 0
    for q0 in range(0, Sq, TC_BQ):
        kt0 = max(0, (q_offset + q0 - window + 1) // TC_BK) if window else 0
        first, last = kt0 * TC_BK, kt0 * TC_BK + TC_BK - 1
        for r in range(q0, min(q0 + TC_BQ, Sq)):
            qp = q_offset + r
            lo = qp - window if window else -1
            n += last <= lo or first > min(qp, Sk - 1)
    return n


def check_attention(label, q, k, v, window, q_offset, dtype) -> dict:
    """The flash kernel against its plain version on the card."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import VARIANTS

    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got, k_ms = median_ms(lambda: flash_attention_cuda(q, k, v, **kw))
    want, p_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw))
    err = float((got.float() - want.float()).abs().max())
    atol = ATTN_ATOL[str(dtype)]
    dead = dead_first_tile_rows(q.shape[1], k.shape[1], window, q_offset)
    say("kernel_vs_plain", kernel="flash_attention", case=label,
        dtype=str(dtype).removeprefix("torch."), variant=VARIANTS[dtype],
        shape=tuple(q.shape), kv=tuple(k.shape), window=window,
        q_offset=q_offset, dead_first_tile_rows=dead,
        max_abs_err=err, atol=atol, finite=bool(got.isfinite().all()),
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
    if not err <= atol or not bool(got.isfinite().all()):
        fail(f"flash_attention != plain on {label} {dtype}: {err} > {atol}")
    return dict(err=err, ms=k_ms, plain_ms=p_ms)


def check_ssd(label, args, dtype) -> dict:
    """The SSD intra-chunk kernel against its plain version on the card,
    all four outputs."""
    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda, ssd_intra_chunk_ref
    from repro_torch.kernels.ssd.ssd import VARIANTS

    x, dt, A, Bm, Cm, L = args
    x, Bm, Cm = (t.to(dtype) for t in (x, Bm, Cm))
    dt, A = dt.float(), A.float().contiguous()
    got, k_ms = median_ms(lambda: ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, L))
    want, p_ms = median_ms(lambda: ssd_intra_chunk_ref(x, dt, A, Bm, Cm, L))
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    err = max(errs)
    atol = SSD_ATOL[str(dtype)]
    finite = all(bool(t.isfinite().all()) for t in got)
    S = x.shape[1]
    say("kernel_vs_plain", kernel="ssd_intra_chunk", case=label,
        dtype=str(dtype).removeprefix("torch."), variant=VARIANTS[dtype],
        x=tuple(x.shape), B=tuple(Bm.shape), chunk=L,
        last_chunk_steps=S - (-(-S // L) - 1) * L,
        max_abs_err_y_sc_dec_cum=",".join(f"{e:.3g}" for e in errs),
        max_abs_err=err, atol=atol, finite=finite,
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
    if not err <= atol or not finite:
        fail(f"ssd_intra_chunk != plain on {label} {dtype}: {err} > {atol}")
    return dict(err=err, ms=k_ms, plain_ms=p_ms)


def serve_kernel_alone() -> None:
    """``--serve-kernel-alone``: print one JSON line with the profiler's
    device time of one launch of each serving kernel on seeded random
    inputs at the serving shapes (the times depend on shapes and masks, not
    on values): hymba's global and window attention layers, its SSD layer
    and mamba2's. Run in a fresh process by ``phase_serve``: in a long run
    of this script the profiler stopped reporting device time for these
    launches after the earlier phases had profiled, though a fresh process
    reports it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    hy, mb = ARCHS["hymba-1.5b"], ARCHS["mamba2-1.3b"]
    B, S = ATTN_CHECK_B, ATTN_CHECK_S
    out = {}
    # each dtype's own kernel: flash_fwd_tc_kernel / flash_fwd_kernel,
    # ssd_intra_tc_kernel / ssd_intra_kernel
    for dtype, tc in ((torch.bfloat16, "_tc"), (torch.float32, "")):
        dt_name = str(dtype).removeprefix("torch.")
        q = randn(B, S, hy.n_heads, hy.head_dim).to(dtype)
        k, v = (randn(B, S, hy.n_kv_heads, hy.head_dim).to(dtype)
                for _ in range(2))
        for case, w in (("global", None), ("window", hy.window)):
            out[f"flash_attention/{case}/{dt_name}"] = profiled_ms(
                lambda: flash_attention_cuda(q, k, v, window=w),
                f"flash_fwd{tc}_kernel")[0]
        for case, cfg in (("hymba", hy), ("mamba2", mb)):
            H = cfg.ssm.n_heads(cfg.d_model)
            N, P = cfg.ssm.d_state, cfg.ssm.head_dim
            x = randn(B, S, H, P).to(dtype)
            dt = F.softplus(randn(B, S, H) - 2.0)
            A = -torch.exp(randn(H))
            Bm, Cm = (randn(B, S, 1, N).to(dtype) for _ in range(2))
            out[f"ssd_intra_chunk/{case}/{dt_name}"] = profiled_ms(
                lambda: ssd_intra_chunk_cuda(x, dt, A, Bm, Cm,
                                             cfg.ssm.chunk),
                f"ssd_intra{tc}_kernel")[0]
    print(json.dumps(out), flush=True)


def prefill_profile() -> None:
    """``--prefill-profile``: print one JSON line with where one bf16
    prefill of hymba-1.5b at batch 0's shape (B = 4, S = 1,866, random
    weights) spends its time, from ``torch.profiler`` in a fresh process:
    the wall time, the device-busy time (the sum of the kernels' device
    time), each kernel family's time and launches (the port's attention and
    SSD kernels, matrix products, the rest) and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.models import RunConfig, model_init, prefill

    cfg, run = ARCHS["hymba-1.5b"], RunConfig()
    params = model_init(0, cfg, run, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (SERVE_MAX_BATCH, 1866),
                         generator=gen, device="cuda", dtype=torch.int32)
    prefill(params, {"tokens": toks}, cfg, run)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        prefill(params, {"tokens": toks}, cfg, run)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    families = {"flash_attention": ("flash_fwd",),
                "ssd_intra_chunk": ("ssd_intra",),
                "matmul": ("gemm", "nvjet", "xmma", "cutlass", "splitK")}
    split = {f: [0.0, 0] for f in (*families, "other")}
    for key, ms, n in rows:
        fam = next((f for f, subs in families.items()
                    if any(x in key for x in subs)), "other")
        split[fam][0] += ms
        split[fam][1] += n
    top = sorted(rows, key=lambda r: -r[1])[:8]
    print(json.dumps({
        "wall_ms": wall, "device_busy_ms": sum(r[1] for r in rows),
        "split": {f: {"ms": v[0], "launches": v[1]} for f, v in split.items()},
        "top": [{"kernel": k[:90], "ms": ms, "launches": n}
                for k, ms, n in top]}), flush=True)


def child_json(flag: str) -> dict:
    """The JSON line a child process of this script prints when run with
    ``flag`` (``--noc-cycle-alone``, ``--dpm-cost-alone``,
    ``--serve-kernel-alone``, ``--segmin-kernel-alone``,
    ``--prefill-profile``): profiler times taken in a fresh process."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), flag],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        fail(f"the child {flag} failed:\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def variant_counts() -> dict:
    """Launches of each kernel of the attention and SSD wrappers, by
    ``kernel/variant`` (the bf16 tensor-core kernels and the f32 ones)."""
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL

    return {f"{name}/{v}": n
            for name, k in (("flash_attention", FLASH_KERNEL),
                            ("ssd_intra_chunk", SSD_KERNEL))
            for v, n in k.variant_launches.items()}


def variant_delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in variant_counts().items()}


def expect_variants(where: str, delta: dict, dtype: str, layers: int) -> None:
    """Fail unless a prefill in ``dtype`` launched each kernel of that
    dtype once per layer and the other dtype's kernels never."""
    tc = dtype == "bfloat16"
    want = {"flash_attention/wgmma_bf16": layers if tc else 0,
            "flash_attention/cuda_core_f32": 0 if tc else layers,
            "ssd_intra_chunk/mma_bf16": layers if tc else 0,
            "ssd_intra_chunk/cuda_core_f32": 0 if tc else layers}
    if delta != want:
        fail(f"{where}: kernel variants launched {delta}, expected {want}")


def phase_serve() -> list:
    """hymba-1.5b at full width and depth served through ``BatchServer`` on
    the card, the kernels' launches counted per prefill; then both kernels
    against their plain versions on inputs captured from a full-width
    prefill (and mamba2-1.3b's N = 128 for the SSD kernel), the f32 logits
    of the kernel path against the plain path, and the kernels' times.
    Returns the kernels-line entries of the two kernels."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.flash_attention import (
        attention_mask, flash_attention_cuda,
    )
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.models import RunConfig, count_params, model_init, prefill
    from repro_torch.serve import BatchServer, Request, generate

    cfg, run = ARCHS["hymba-1.5b"], RunConfig()
    t0 = time.monotonic()
    params = model_init(0, cfg, run, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = count_params(params)
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    SERVE_MAX_TOKENS) for i, n in enumerate(lens)]
    # warm-up: one short generate (cuBLAS handles, first launches)
    generate(params, cfg, run, reqs[0].prompt[None, :128], 2, device="cuda")

    # ---- the serving path, the launch counts set to 0 just before ---------
    server = BatchServer(params, cfg, run, max_batch=SERVE_MAX_BATCH,
                         max_wait_s=0.01, device="cuda")
    for r in reqs:
        server.submit(r)
    FLASH_KERNEL.launches = SSD_KERNEL.launches = 0
    for k in (FLASH_KERNEL, SSD_KERNEL):
        k.variant_launches = dict.fromkeys(k.variant_launches, 0)
    t0 = time.monotonic()
    responses, per_batch = [], []
    while len(responses) < len(reqs):
        f0, s0 = FLASH_KERNEL.launches, SSD_KERNEL.launches
        v0 = variant_counts()
        out = server.serve_once()
        torch.cuda.synchronize()
        res = server.last_result
        per_batch.append((len(out), res, FLASH_KERNEL.launches - f0,
                          SSD_KERNEL.launches - s0,
                          max(len(reqs[o.rid].prompt) for o in out),
                          variant_delta(v0)))
        responses += out
    serve_s = time.monotonic() - t0
    launches = {"flash_attention": FLASH_KERNEL.launches,
                "ssd_intra_chunk": SSD_KERNEL.launches}
    for i, (n, res, fl, sl, S, var) in enumerate(per_batch):
        B = res.tokens.shape[0]
        say("serve", batch=i, requests=n, prompt_len=S,
            prefill_ms=f"{res.prefill_ms:.2f}",
            prefill_tokens_per_s=f"{B * S / res.prefill_ms * 1e3:.0f}",
            decode_ms_per_token=f"{res.decode_ms_per_token:.3f}",
            decode_tokens_per_s=f"{B / res.decode_ms_per_token * 1e3:.1f}",
            flash_launches=fl, ssd_launches=sl,
            variants=",".join(f"{k}:{v}" for k, v in var.items()))
        if fl != cfg.n_layers or sl != cfg.n_layers:
            fail(f"batch {i}: {fl} flash and {sl} SSD launches per prefill, "
                 f"expected {cfg.n_layers} each")
        expect_variants(f"batch {i}", var, run.activations_dtype,
                        cfg.n_layers)
    bad = [o.rid for o in responses
           if o.tokens.shape != (SERVE_MAX_TOKENS,)
           or not ((0 <= o.tokens) & (o.tokens < cfg.vocab)).all()]
    if bad or len(per_batch) != 2 or sorted(o.rid for o in responses) != list(
            range(len(reqs))):
        fail(f"serving: {len(per_batch)} batches, bad responses {bad}")
    gen_tokens = sum(len(o.tokens) for o in responses)
    say("serve", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        params=n_params, params_dtype="float32",
        activations=run.activations_dtype, init_s=f"{init_s:.2f}",
        requests=len(responses), batches=len(per_batch),
        prompt_lens=",".join(str(int(n)) for n in lens),
        max_tokens=SERVE_MAX_TOKENS, serve_s=f"{serve_s:.3f}",
        tokens_per_s=f"{gen_tokens / serve_s:.1f}",
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the serving path never launched {name}")

    # ---- kernel path against plain path, whole model ----------------------
    first = [r for r in reqs[:SERVE_MAX_BATCH]]
    S = max(len(r.prompt) for r in first)
    prompts = np.zeros((len(first), S), np.int32)
    for i, r in enumerate(first):
        prompts[i, S - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(prompts).cuda()
    for act in ("float32", "bfloat16"):
        r = RunConfig(activations_dtype=act)
        v0 = variant_counts()
        lk, _ = prefill(params, {"tokens": toks}, cfg, r)
        var = variant_delta(v0)
        expect_variants(f"{act} prefill", var, act, cfg.n_layers)
        with plain_path():
            f0 = FLASH_KERNEL.launches + SSD_KERNEL.launches
            lp, _ = prefill(params, {"tokens": toks}, cfg, r)
            if FLASH_KERNEL.launches + SSD_KERNEL.launches != f0:
                fail("the plain path launched a kernel")
        lk, lp = lk[..., :cfg.vocab], lp[..., :cfg.vocab]
        diff = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        finite = bool(lk.isfinite().all())
        say("serve_vs_plain", activations=act, batch=len(first), prompt_len=S,
            max_abs_logit_diff=diff, max_abs_logit=scale,
            ratio=f"{diff / scale:.3g}",
            bound="1e-3" if act == "float32" else "not asserted",
            finite=finite,
            variants=",".join(f"{k}:{v}" for k, v in var.items() if v))
        if not finite or (act == "float32" and not diff <= 1e-3 * scale):
            fail(f"{act} logits: kernel path vs plain path {diff} > "
                 f"1e-3 x {scale}")
    gk = generate(params, cfg, run, prompts, SERVE_MAX_TOKENS, device="cuda")
    with plain_path():
        gp = generate(params, cfg, run, prompts, SERVE_MAX_TOKENS,
                      device="cuda")
    agree = gk.tokens == gp.tokens
    say("serve_vs_plain", greedy_tokens_equal=f"{agree.mean():.4f}",
        first_token_equal=f"{agree[:, 0].mean():.4f}",
        plain_prefill_ms=f"{gp.prefill_ms:.2f}",
        kernel_prefill_ms=f"{gk.prefill_ms:.2f}")

    # ---- each kernel against its plain version, and its times -------------
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ATTN_CHECK_B, ATTN_CHECK_S)).astype(np.int32)).cuda()
    attn_calls, scan_calls = capture_inputs(params, cfg, run, tokens)
    del params
    torch.cuda.empty_cache()
    (qg, kg, vg, wg), (qw, kw_, vw, ww) = attn_calls
    if wg is not None or ww != cfg.window:
        fail(f"captured windows {wg}, {ww}: expected None, {cfg.window}")
    attn = {}
    for dtype in (torch.bfloat16, torch.float32):
        attn["global", dtype] = check_attention("hymba_g", qg, kg, vg, None,
                                                0, dtype)
        attn["window", dtype] = check_attention("hymba_w", qw, kw_, vw, ww,
                                                0, dtype)
        off = ATTN_CHECK_S - 64
        ragged = int(lens[SERVE_MAX_BATCH:].max())  # batch 1's length
        for lab, (q, k, v, w) in (("hymba_g", attn_calls[0]),
                                  ("hymba_w", attn_calls[1])):
            check_attention(f"{lab}_q_offset", q[:, off:], k, v, w, off,
                            dtype)
            check_attention(f"{lab}_S{ragged}", q[:, :ragged], k[:, :ragged],
                            v[:, :ragged], w, 0, dtype)
    edge = torch.Generator(device="cuda").manual_seed(1)
    for lab, B_, S_, H_, KH_, D_, w in ATTN_EDGE_CASES:
        q, k, v = (torch.randn((B_, S_, h, D_), generator=edge, device="cuda")
                   for h in (H_, KH_, KH_))
        if lab == "window_dead_first_tile" and not dead_first_tile_rows(
                S_, S_, w, 0):
            fail(f"{lab}: no row has a fully masked first key tile")
        for dtype in (torch.bfloat16, torch.float32):
            check_attention(lab, q, k, v, w, 0, dtype)
    ssd = {}
    for dtype in (torch.bfloat16, torch.float32):
        ssd["hymba", dtype] = check_ssd("hymba", scan_calls[0], dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    mb = ARCHS["mamba2-1.3b"]
    H = mb.ssm.n_heads(mb.d_model)
    N, P, L = mb.ssm.d_state, mb.ssm.head_dim, mb.ssm.chunk
    B_, S_ = ATTN_CHECK_B, ATTN_CHECK_S
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    mamba_args = (randn(B_, S_, H, P), F.softplus(randn(B_, S_, H) - 2.0),
                  -torch.exp(randn(H)), randn(B_, S_, 1, N),
                  randn(B_, S_, 1, N), L)
    for dtype in (torch.bfloat16, torch.float32):
        ssd["mamba2", dtype] = check_ssd("mamba2", mamba_args, dtype)
    for lab, B_, S_, H_, G_, N_, P_, L_ in SSD_EDGE_CASES:
        args = (randn(B_, S_, H_, P_), F.softplus(randn(B_, S_, H_) - 2.0),
                -torch.exp(randn(H_)), randn(B_, S_, G_, N_),
                randn(B_, S_, G_, N_), L_)
        for dtype in (torch.bfloat16, torch.float32):
            check_ssd(lab, args, dtype)

    # times: kernel alone (profiler), library yardstick, bound
    def sdpa(q, k, v, mask=None):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    wmask = attention_mask(ATTN_CHECK_S, ATTN_CHECK_S, causal=True,
                           window=ww, q_offset=0, device="cuda")
    alone_ms = child_json("--serve-kernel-alone")
    split = child_json("--prefill-profile")
    say("prefill_split", arch=cfg.name, batch=SERVE_MAX_BATCH, prompt_len=1866,
        activations=run.activations_dtype,
        wall_ms=f"{split['wall_ms']:.2f}",
        device_busy_ms=f"{split['device_busy_ms']:.2f}",
        device_busy_share=f"{split['device_busy_ms'] / split['wall_ms']:.3f}",
        **{f"{f}_ms": f"{v['ms']:.3f}" for f, v in split["split"].items()},
        **{f"{f}_launches": v["launches"]
           for f, v in split["split"].items()})
    for row in split["top"]:
        say("prefill_split", top_kernel=repr(row["kernel"]),
            ms=f"{row['ms']:.3f}", launches=row["launches"])
    entries = []

    def alone_fields(alone, b_ms, b32_ms):
        """The kernel-alone time and its multiple of the bound(s)."""
        if alone is None:
            return dict(kernel_alone_ms="not measured")
        out = dict(kernel_alone_ms=f"{alone:.4f}",
                   alone_times_bound=f"{alone / b_ms:.2f}")
        if b32_ms is not None:
            out["alone_times_f32_core_bound"] = f"{alone / b32_ms:.2f}"
        return out

    for case, (q, k, v, w), mask in (("global", attn_calls[0], None),
                                     ("window", attn_calls[1], wmask)):
        for dtype in (torch.bfloat16, torch.float32):
            dt_name = str(dtype).removeprefix("torch.")
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            lib_out, lib_ms = median_ms(lambda: sdpa(qd, kd, vd, mask))
            alone = alone_ms[f"flash_attention/{case}/{dt_name}"]
            b_ms, b_by, nbytes, ops = attention_bound_ms(qd, kd, vd, w)
            # the f32 kernel computes on the CUDA cores: its operations
            # over their f32 peak, beside the bf16 tensor-core bound
            b32_ms = (max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
                      * 1e3 if dtype == torch.float32 else None)
            t = attn[case, dtype]
            lib_err = float((lib_out.transpose(1, 2).float()
                             - flash_attention_cuda(qd, kd, vd, window=w)
                             .float()).abs().max())
            say("kernel_time", kernel="flash_attention", case=case,
                dtype=dt_name, ms=f"{t['ms']:.4f}",
                **alone_fields(alone, b_ms, b32_ms),
                plain_ms=f"{t['plain_ms']:.4f}", sdpa_ms=f"{lib_ms:.4f}",
                vs_sdpa=f"{t['ms'] / lib_ms:.3f}",
                alone_vs_sdpa="not measured" if alone is None
                else f"{alone / lib_ms:.3f}",
                sdpa_vs_kernel_max_abs=f"{lib_err:.3g}",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes, ops=ops,
                times_bound=f"{t['ms'] / b_ms:.1f}",
                **({} if b32_ms is None
                   else {"f32_core_bound_ms": f"{b32_ms:.5f}"}))
            if case == "global" and dtype == torch.bfloat16:
                entries.append({
                    "name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention/"
                                "flash_attention.py:95",
                    "launches": launches["flash_attention"],
                    "max_abs_err": max(v["err"] for v in attn.values()),
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                })
    for case, args in (("hymba", scan_calls[0]), ("mamba2", mamba_args)):
        x, _, _, Bm, _, L = args
        for dtype in (torch.bfloat16, torch.float32):
            dt_name = str(dtype).removeprefix("torch.")
            t = ssd[case, dtype]
            alone = alone_ms[f"ssd_intra_chunk/{case}/{dt_name}"]
            b_ms, b_by, nbytes, ops = ssd_bound_ms(x.to(dtype), Bm.to(dtype),
                                                   L)
            b32_ms = (max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
                      * 1e3 if dtype == torch.float32 else None)
            say("kernel_time", kernel="ssd_intra_chunk", case=case,
                dtype=dt_name, ms=f"{t['ms']:.4f}",
                **alone_fields(alone, b_ms, b32_ms),
                plain_ms=f"{t['plain_ms']:.4f}", library_ms="none",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes, ops=ops,
                times_bound=f"{t['ms'] / b_ms:.1f}",
                **({} if b32_ms is None
                   else {"f32_core_bound_ms": f"{b32_ms:.5f}"}))
            if case == "hymba" and dtype == torch.bfloat16:
                entries.append({
                    "name": "ssd_intra_chunk", "route": "cuda",
                    "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
                    "replaces": "src/repro/kernels/ssd/ssd.py:68",
                    "launches": launches["ssd_intra_chunk"],
                    "max_abs_err": max(ssd["hymba", d]["err"]
                                       for d in (torch.bfloat16,
                                                 torch.float32)),
                    "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                })
    return entries


# ---------------------------------------------------------------------------
# the segmented-min arbitration kernel through segmin / arbitrate
# ---------------------------------------------------------------------------
def xsim_id_space(n: int, B: int, rng) -> tuple:
    """Keys and segments of one arbitration round of xsim's fused link +
    ejection id space on B instances of an n x n mesh. Per instance the
    candidates are the 2V VC FIFO heads of every directed link, each asking
    for an output link of the link's head router or its ejection port, and
    the 2 NI lanes of every node, each asking for an output link of its
    router; the segments are the directed links and one ejection port per
    node. Keys: ~30% NOC_INF, the rest below 2^22 (as tests/test_kernels.py
    makes them). Returns (keys, segs, L) as int32 numpy arrays."""
    import numpy as np

    from repro_torch.kernels.noc_step import NOC_INF
    from repro_torch.noc import NoCConfig

    NN = n * n
    node = np.arange(NN)
    x, y = node % n, node // n
    src, dst = [], []
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (x + dx >= 0) & (x + dx < n) & (y + dy >= 0) & (y + dy < n)
        src.append(node[ok])
        dst.append((y[ok] + dy) * n + x[ok] + dx)
    src, dst = np.concatenate(src), np.concatenate(dst)
    R = len(src)  # directed links
    order = np.argsort(src, kind="stable")  # links grouped by router
    deg = np.bincount(src, minlength=NN)
    start = np.cumsum(deg) - deg
    W = 2 * NoCConfig().vcs_per_class
    head = np.repeat(dst, W)  # router of each VC FIFO head
    k = (rng.random((B, R * W)) * (deg[head] + 1)).astype(np.int64)
    vc_seg = np.where(k < deg[head],
                      order[np.minimum(start[head] + k, R - 1)], R + head)
    lane = np.repeat(node, 2)
    k = (rng.random((B, 2 * NN)) * deg[lane]).astype(np.int64)
    lane_seg = order[start[lane] + k]
    per = R + NN
    segs = (np.concatenate([vc_seg, lane_seg], axis=1)
            + per * np.arange(B)[:, None]).reshape(-1).astype(np.int32)
    N = segs.size
    keys = rng.integers(0, 2**22, N).astype(np.int32)
    keys[rng.random(N) < 0.3] = NOC_INF
    return keys, segs, B * per


def segmin_cases() -> list:
    """The ten ``[segmin]`` cases as (name, keys, segs, L), int32 numpy,
    each from its own seed: tests/test_kernels.py's shapes, xsim's id space
    at the 8x8 (B = 4), 16x16 (B = 16) and 32x32 (B = 132) grids, the 16x16
    case with 10% of entries padded (segment -1 or L, key NOC_INF), and the
    32x32 case with every live key in 64 segments (a hot spot)."""
    import numpy as np

    from repro_torch.kernels.noc_step import NOC_INF

    cases = []
    for N, L in SEGMIN_SHAPES:
        rng = np.random.default_rng(N * L)
        keys = rng.integers(0, 2**22, N).astype(np.int32)
        keys[rng.random(N) < 0.3] = NOC_INF
        segs = rng.integers(0, L, N).astype(np.int32)
        cases.append((f"{N}x{L}", keys, segs, L))
    grids = {}
    for seed, (name, n, B) in enumerate(SEGMIN_GRIDS):
        keys, segs, L = xsim_id_space(n, B, np.random.default_rng(seed))
        grids[name] = (keys, segs, L)
        cases.append((f"xsim_{name}_B{B}", keys, segs, L))
    rng = np.random.default_rng(100)
    keys, segs, L = grids["scale16x16"]
    keys, segs = keys.copy(), segs.copy()
    pad = rng.random(keys.size) < 0.1
    segs[pad] = np.where(rng.random(int(pad.sum())) < 0.5, -1, L)
    keys[pad] = NOC_INF
    cases.append(("xsim_scale16x16_padded", keys, segs, L))
    keys, segs, L = grids["mesh32x32"]
    keys, segs = keys.copy(), segs.copy()
    live = keys < NOC_INF
    hot = rng.choice(L, 64, replace=False).astype(np.int32)
    segs[live] = hot[rng.integers(0, 64, int(live.sum()))]
    cases.append(("xsim_mesh32x32_hotspot64", keys, segs, L))
    return cases


def segmin_bound_ms(N: int, L: int) -> tuple[float, str, int, int]:
    """Least time the card could take for one segmented minimum: the larger
    of keys and segments read once and the output written once (8 N + 4 L
    bytes) over HBM bandwidth, and 5 int32 operations per candidate (the
    key test, two range tests, the comparison, the minimum) plus one per
    output over the int32 issue rate."""
    nbytes = 8 * N + 4 * L
    ops = 5 * N + L
    return roofline(nbytes, ops, INT32_OPS_PER_S)


def arbitrate_bound_ms(N: int) -> tuple[float, str, int, int]:
    """Least time the card could take for one arbitration round: keys,
    segments and the mask read once and the winner mask written once (10 N
    bytes; the minima are not an output) over HBM bandwidth, and 9 int32
    operations per candidate (the masked key, the segmented minimum's five,
    the clip, the comparison, the winner's and) over the int32 issue
    rate."""
    return roofline(10 * N, 9 * N, INT32_OPS_PER_S)


def arbitrate_rounds() -> list:
    """The ``[segmin]`` arbitration rounds as (name, adm, keys, segs, L),
    numpy: a 777 x 61 round (unique keys, 40% admissible) and xsim's
    id space at 16x16 (B = 16) and 32x32 (B = 132) with unique keys (a
    permutation) and 70% of candidates admissible."""
    import numpy as np

    rng = np.random.default_rng(9)
    AN, AL = 777, 61
    keys = rng.permutation(AN).astype(np.int32)
    segs = rng.integers(0, AL, AN).astype(np.int32)
    adm = rng.random(AN) < 0.4
    rounds = [(f"arbitrate_{AN}x{AL}", adm, keys, segs, AL)]
    for seed, (name, n, B) in enumerate(SEGMIN_ARBITRATE_GRIDS, start=200):
        rng = np.random.default_rng(seed)
        _, segs, L = xsim_id_space(n, B, rng)
        keys = rng.permutation(segs.size).astype(np.int32)
        adm = rng.random(segs.size) < 0.7
        rounds.append((f"arbitrate_xsim_{name}_B{B}", adm, keys, segs, L))
    return rounds


def winner_test(adm, keys, segs, L, seg_min_fn):
    """One arbitration round in torch around ``seg_min_fn(keys, segs, L)``:
    the masked keys' segmented minimum, then the winner test."""
    import torch

    from repro_torch.kernels.noc_step import NOC_INF

    mkeys = torch.where(adm, keys, NOC_INF).to(torch.int32)
    seg_min = seg_min_fn(mkeys, segs, L)
    won = mkeys == seg_min[segs.to(torch.int64).clamp(0, L - 1)]
    return adm & won & (mkeys < NOC_INF)


def arbitrate_plain(adm, keys, segs, L):
    """The plain arbitration round on the tensors' device: the winner test
    around ``segmented_min_ref``."""
    from repro_torch.kernels.noc_step import segmented_min_ref

    return winner_test(adm, keys, segs, L, segmented_min_ref)


def arbitrate_unfused(adm, keys, segs, L):
    """The unfused arbitration round on the card: the winner test in torch
    around the ``atomic`` kernel pair."""
    from repro_torch.kernels.noc_step import segmented_min

    return winner_test(adm, keys, segs, L, lambda k, sg, n: segmented_min(
        k, sg, n, variant="atomic"))


def arbitrate_rules(win, adm, keys, segs, L) -> tuple[bool, bool]:
    """(one winner per contested resource and none elsewhere, every winner
    admissible and its resource's least admissible key) of a winner mask;
    CPU tensors, segments in range."""
    import torch

    from repro_torch.kernels.noc_step import NOC_INF

    s64 = segs.to(torch.int64)
    mkeys = torch.where(adm, keys, NOC_INF).to(torch.int32)
    seg_min = torch.full((L,), NOC_INF, dtype=torch.int32).scatter_reduce_(
        0, s64, mkeys, "amin")
    winners = torch.bincount(s64[win], minlength=L)
    contested = torch.bincount(s64[adm], minlength=L) > 0
    one_each = bool((winners == contested.to(winners.dtype)).all())
    least = bool((mkeys[win] == seg_min[s64[win]]).all())
    return one_each, least and not bool((win & ~adm).any())


def time_turns(fns: dict, reps: int = 3) -> dict:
    """Each function of ``fns`` timed ``2 reps`` times with CUDA events, in
    turns (forward, then backward order): ``{name: (median ms, runs)}``."""
    runs = {k: [] for k in fns}
    order = list(fns)
    for r in range(2 * reps):
        for k in (order if r % 2 == 0 else order[::-1]):
            runs[k].append(timed(fns[k])[1])
    return {k: (sorted(v)[len(v) // 2], v) for k, v in runs.items()}


def segmin_kernel_alone() -> None:
    """``--segmin-kernel-alone``: print one JSON line with the profiler's
    device time per call (mean of ``SEGMIN_ALONE_REPS`` calls in one
    window) of both routes on each ``[segmin]`` case (the kernels whose
    names hold "segmin") and of every arbitration round, fused
    (``arbitrate_kernel``) and unfused (``arbitrate_unfused``; every kernel
    of the call, its torch launches too). Run in a fresh process by
    ``phase_segmin``, as ``serve_kernel_alone`` is."""
    import torch

    from repro_torch.kernels.noc_step import (
        VARIANTS, arbitrate_kernel, segmented_min,
    )

    def alone(fn, match):
        ms, _ = profiled_ms(lambda: [fn() for _ in range(SEGMIN_ALONE_REPS)],
                            match)
        return None if ms is None else ms / SEGMIN_ALONE_REPS

    out = {"cases": {}, "rounds": {}}
    for name, keys, segs, L in segmin_cases():
        k, sg = torch.from_numpy(keys).cuda(), torch.from_numpy(segs).cuda()
        out["cases"][name] = {v: alone(
            lambda: segmented_min(k, sg, L, variant=v), "segmin")
            for v in VARIANTS}
    for name, adm, keys, segs, L in arbitrate_rounds():
        a, k, sg = (torch.from_numpy(t).cuda() for t in (adm, keys, segs))
        out["rounds"][name] = {
            "grid": alone(lambda: arbitrate_kernel(a, k, sg, L), ""),
            "atomic": alone(lambda: arbitrate_unfused(a, k, sg, L), "")}
    print(json.dumps(out), flush=True)


NOC_CYCLE_CASES = ROOT / "build" / "noc_cycle_cases.pt"


def noc_cycle_alone() -> None:
    """``--noc-cycle-alone``: print one JSON line with the profiler's device
    time of one launch of each cycle-kernel route on each case that the
    parent saved to ``build/noc_cycle_cases.pt`` (the paper's 8x8 mesh, the
    32x32 mesh and the 16x16 main path's inputs), taken in a fresh
    process."""
    import torch

    from repro_torch.kernels.noc_cycle import VARIANTS, run_cycles

    cases = torch.load(NOC_CYCLE_CASES, weights_only=False)
    out = {}
    for name, (tr, geom, kw) in cases.items():
        out[name] = {v: profiled_ms(
            lambda: run_cycles(tr, geom, variant=v, **kw), "noc_cycle")[0]
            for v in VARIANTS}
    print(json.dumps(out), flush=True)


def phase_segmin() -> list:
    """``segmin`` and ``arbitrate`` on the card through the entry points
    (the launch counts, by route, set to 0 just before and read just
    after), then both routes on each case held against the plain version
    on the same CUDA tensors and on the CPU with exact equality, the
    arbitration rounds, fused and unfused, against the plain path and the
    one-admissible-minimum rule, then the times: each route alone and
    through its wrapper beside its bound and ``scatter_reduce_``, the rounds
    fused and unfused. Returns the kernels-line entry of
    ``segmented_min``."""
    import torch

    from repro_torch.kernels.noc_step import (
        KERNEL as SEGMIN_KERNEL, NOC_INF, VARIANTS, arbitrate,
        arbitrate_kernel, segmented_min, segmented_min_ref, segmin,
    )

    SEGMIN_KERNEL.build()
    cases = segmin_cases()
    on_card = [(name, torch.from_numpy(k).cuda(), torch.from_numpy(sg).cuda(),
                L) for name, k, sg, L in cases]
    rounds = arbitrate_rounds()
    r_card = [(name, *(torch.from_numpy(t).cuda() for t in (a, k, sg)), L)
              for name, a, k, sg, L in rounds]
    torch.cuda.synchronize()

    # ---- the path: every case and round through the entry points ----------
    SEGMIN_KERNEL.launches = 0
    SEGMIN_KERNEL.launches_by_route = dict.fromkeys(VARIANTS, 0)
    outs = [segmin(k, sg, L, device="cuda") for _, k, sg, L in on_card]
    wins = [arbitrate(a, k, sg, L, device="cuda") for _, a, k, sg, L in r_card]
    torch.cuda.synchronize()
    launches = SEGMIN_KERNEL.launches
    by_route = dict(SEGMIN_KERNEL.launches_by_route)
    say("segmin_path", cases=len(on_card), arbitrate_cases=len(r_card),
        launches=launches)
    say("segmin_routes", **by_route)
    if launches != len(on_card) + len(r_card):
        fail(f"segmin/arbitrate launched {launches} times, expected "
             f"{len(on_card) + len(r_card)}")
    if by_route != {"grid": launches, "atomic": 0}:
        fail(f"the entry points' routes: {by_route}")

    # ---- each route against the plain version --------------------------------
    worst = 0.0  # the largest error measured over every case below
    for (name, k, sg, L), got, (_, kn, sn, _) in zip(on_card, outs, cases):
        plain = segmented_min_ref(k, sg, L)
        host = segmin(torch.from_numpy(kn), torch.from_numpy(sn), L,
                      device="cpu")
        for route in VARIANTS:
            r_out = got if route == "grid" else segmented_min(
                k, sg, L, variant=route)
            eq_p, err_p = tensor_diff(r_out, plain)
            eq_h, err_h = tensor_diff(r_out.cpu(), host)
            err = max(err_p, err_h)
            worst = max(worst, err)
            say("kernel_vs_plain", kernel="segmented_min", case=name,
                route=route, default=route == "grid", N=k.numel(), L=L,
                live=int((kn < NOC_INF).sum()), equal=eq_p and eq_h,
                max_abs_err=f"{err:.0f}")
            if not (eq_p and eq_h):
                fail(f"segmented_min/{route} != plain on {name}: "
                     f"max abs {err}")
    for (name, a, k, sg, L), win, (_, an, kn, sn, _) in zip(r_card, wins,
                                                           rounds):
        plain = arbitrate_plain(a, k, sg, L)
        host = arbitrate(*(torch.from_numpy(t) for t in (an, kn, sn)), L,
                         device="cpu")
        for route in VARIANTS:
            w = win if route == "grid" else arbitrate_unfused(a, k, sg, L)
            eq_p, err_p = tensor_diff(w.to(torch.int32), plain.to(torch.int32))
            wc = w.cpu()
            eq_h, err_h = tensor_diff(wc.to(torch.int32), host.to(torch.int32))
            err = max(err_p, err_h)
            worst = max(worst, err)
            one_each, least = arbitrate_rules(
                wc, *(torch.from_numpy(t) for t in (an, kn, sn)), L)
            say("kernel_vs_plain", kernel="segmented_min", case=name,
                route=route, fused=route == "grid", default=route == "grid",
                N=k.numel(), L=L, admissible=int(an.sum()),
                winners=int(wc.sum()), equal=eq_p and eq_h,
                max_abs_err=f"{err:.0f}", one_winner_per_resource=one_each,
                winner_is_admissible_min=least)
            if not (eq_p and eq_h and one_each and least):
                fail(f"arbitrate/{route} on {name}: winners differ from the "
                     "plain path or break the one-admissible-minimum rule")

    # ---- times ---------------------------------------------------------------
    alone = child_json("--segmin-kernel-alone")
    entry = None
    for name, k, sg, L in on_card:
        fns = {v: (lambda v=v: segmented_min(k, sg, L, variant=v))
               for v in VARIANTS}
        fns["entry"] = lambda: segmin(k, sg, L, device="cuda")
        fns["plain"] = lambda: segmented_min_ref(k, sg, L)
        t = time_turns(fns)
        b_ms, b_by, nbytes, ops = segmin_bound_ms(k.numel(), L)
        p_ms = t["plain"][0]
        for route in VARIANTS:
            ms, a_ms = t[route][0], alone["cases"][name][route]
            if a_ms is None:
                fail(f"no device time for segmented_min/{route} on {name}")
            say("kernel_time", kernel="segmented_min", case=name, route=route,
                default=route == "grid", ms=f"{ms:.4f}",
                kernel_alone_ms=f"{a_ms:.4f}", plain_ms=f"{p_ms:.4f}",
                library_ms=f"{p_ms:.4f}", library="scatter_reduce_ amin "
                "(= the plain version, one measurement)",
                bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes, ops=ops,
                times_bound=f"{ms / b_ms:.1f}",
                alone_times_bound=f"{a_ms / b_ms:.2f}",
                **({"entry_ms": f"{t['entry'][0]:.4f}"}
                   if route == "grid" else {}))
        if name == "xsim_mesh32x32_B132":
            entry = {
                "name": "segmented_min", "route": "cuda",
                "source": "src/repro_torch/kernels/noc_step/csrc/noc_step.cu",
                "replaces": "src/repro/kernels/noc_step/noc_step.py:50",
                "launches": launches, "max_abs_err": worst,
                "ms": t["grid"][0], "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": p_ms,
                "default_routes": ["grid"], "launches_by_route": by_route,
            }
    for name, a, k, sg, L in r_card:
        t = time_turns({
            "grid": lambda: arbitrate_kernel(a, k, sg, L),
            "atomic": lambda: arbitrate_unfused(a, k, sg, L),
            "entry": lambda: arbitrate(a, k, sg, L, device="cuda"),
            "plain": lambda: arbitrate_plain(a, k, sg, L)})
        b_ms, b_by, nbytes, ops = arbitrate_bound_ms(k.numel())
        unfused = t["atomic"][0]
        for route in VARIANTS:
            ms, d_ms = t[route][0], alone["rounds"][name][route]
            if d_ms is None:
                fail(f"no device time for arbitrate/{route} on {name}")
            say("arbitrate_time", case=name, route=route,
                fused=route == "grid", default=route == "grid",
                ms=f"{ms:.4f}", device_ms=f"{d_ms:.4f}",
                unfused_over_this=f"{unfused / ms:.2f}",
                plain_ms=f"{t['plain'][0]:.4f}", bound_ms=f"{b_ms:.5f}",
                bound_by=b_by, times_bound=f"{ms / b_ms:.1f}",
                device_times_bound=f"{d_ms / b_ms:.2f}",
                **({"entry_ms": f"{t['entry'][0]:.4f}"}
                   if route == "grid" else {}))
    return [entry]


# ---------------------------------------------------------------------------
# the host NoC: WormholeSim at the paper's size, cross-checked with xsim
# ---------------------------------------------------------------------------
def host_delivered_sets(sim) -> dict:
    """{pid: delivered node ids} of a finished ``WormholeSim``."""
    return {p.pid: {sim.g.idx(c) for c in p.delivery_times}
            for p in sim.packets}


def same_stats(a, b) -> list[str]:
    """Names of the ``SimStats`` fields and ``Telemetry`` arrays in which two
    host runs differ."""
    import dataclasses

    import numpy as np

    bad = [f.name for f in dataclasses.fields(a) if f.name != "telemetry"
           and getattr(a, f.name) != getattr(b, f.name)]
    ta, tb = a.telemetry, b.telemetry
    for name in ("link_flits", "vc_class_flits", "occupancy_hwm",
                 "link_conflicts", "credit_stalls"):
        if not np.array_equal(getattr(ta, name), getattr(tb, name)):
            bad.append(f"telemetry.{name}")
    if not np.array_equal(ta.epoch_link_flits(), tb.epoch_link_flits()):
        bad.append("telemetry.epoch_link_flits")
    if not np.array_equal(ta.latency_hist.counts, tb.latency_hist.counts):
        bad.append("telemetry.latency_hist")
    if ta.to_dict() != tb.to_dict():
        bad.append("telemetry.to_dict")
    return bad


def phase_host_sim() -> None:
    """The paper's configuration (``NoCConfig()``: 8x8 mesh, Table I) at rate
    0.02 for 300 injection cycles, MU and DPM: ``WormholeSim`` fed by
    ``add_requests(device="cuda")`` (DPM planned in batches on the card by
    ``bulk_plan``'s ``dpm_plan_exact``), ``simulate()`` (host planning) and
    ``xsimulate(device="cuda")`` on the same workload. The two host runs
    must give identical ``SimStats`` and ``Telemetry``; host and xsim the
    same delivery sets, conserved counts and per-link flits, and average
    latencies within 10%."""
    import numpy as np
    import torch

    from repro_torch.core import arena_clear, plan_cache_clear, planner_for
    from repro_torch.noc import (
        NoCConfig, WormholeSim, simulate, synthetic_workload, xsimulate,
    )

    cfg = NoCConfig()
    wl = synthetic_workload(cfg, HOST_SIM_RATE, HOST_SIM_CYCLES, seed=0)
    algos = ("MU", "DPM")
    t0 = time.monotonic()
    res = xsimulate(cfg, [wl], algos, device="cuda")
    xsim_s = time.monotonic() - t0
    for a, algo in enumerate(algos):
        arena_clear()
        plan_cache_clear()
        t0 = time.monotonic()
        sim = WormholeSim(cfg, measure_window=(cfg.warmup, wl.horizon))
        sim.add_requests(algo, wl.requests, device="cuda")
        torch.cuda.synchronize()
        admit_s = time.monotonic() - t0
        info = planner_for(sim.g, algo, device="cuda").info()
        if algo == "DPM" and info.batched_plans <= 0:
            fail("WormholeSim.add_requests planned no DPM request on the card")
        t0 = time.monotonic()
        bulk = sim.run(wl.horizon + cfg.drain_grace, drain=True)
        run_s = time.monotonic() - t0
        plan_cache_clear()
        t0 = time.monotonic()
        host = simulate(cfg, wl, algo)
        host_s = time.monotonic() - t0
        bad = same_stats(bulk, host)
        if bad:
            fail(f"{algo}: add_requests and simulate differ in {bad}")
        xst = res.stats(0, a)
        checks = {
            "delivered_sets": res.delivered_sets(0, a)
            == host_delivered_sets(sim),
            "flit_link_traversals": xst.flit_link_traversals
            == host.flit_link_traversals,
            "packets_created": xst.packets_created == host.packets_created,
            "packets_finished": xst.packets_finished
            == host.packets_finished,
            "link_flits": bool(np.array_equal(res.link_utilization(0, a),
                                              host.telemetry.link_flits)),
            "latency_rel_0.10": abs(xst.avg_latency - host.avg_latency)
            <= 0.10 * host.avg_latency,
            "drained": host.packets_finished == host.packets_created
            and res.all_drained(0, a),
        }
        say("host_sim", algo=algo, requests=len(wl.requests),
            packets=host.packets_created, cycles=host.cycles,
            avg_latency=f"{host.avg_latency:.4f}",
            dyn_energy_pj=f"{host.dyn_energy_pj(cfg.energy):.1f}",
            host_s=f"{host_s:.3f}", add_requests_s=f"{admit_s:.3f}",
            run_s=f"{run_s:.3f}", batched_plans=info.batched_plans,
            host_plans=info.host_plans, dispatches=info.dispatches,
            add_requests_equal=True,
            xsim_latency=f"{xst.avg_latency:.4f}", xsim_s=f"{xsim_s:.3f}",
            p99_bucket=host.telemetry.latency_hist.quantile(0.99),
            **{f"xsim_{k}": v for k, v in checks.items()})
        failed = [k for k, v in checks.items() if not v]
        if failed:
            fail(f"{algo}: host and xsim differ in {failed}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if sys.argv[1:] == ["--serve-kernel-alone"]:
        serve_kernel_alone()
        return
    if sys.argv[1:] == ["--prefill-profile"]:
        prefill_profile()
        return
    if sys.argv[1:] == ["--segmin-kernel-alone"]:
        segmin_kernel_alone()
        return
    if sys.argv[1:] == ["--noc-cycle-alone"]:
        noc_cycle_alone()
        return
    if sys.argv[1:] == ["--dpm-cost-alone"]:
        dpm_cost_alone()
        return

    # ---- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    print(card, flush=True)

    import repro_torch.noc as noc
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc import NoCConfig, synthetic_workload, xsimulate

    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the reference package")

    # ---- 2. build ---------------------------------------------------------
    build_kernels()

    # ---- 3. kernel vs plain on the paper's 8x8 ----------------------------
    cycle_cases = {}  # inputs whose kernel-alone times a child process takes
    for topo in ("mesh", "torus"):
        cfg = NoCConfig(topology=topo, warmup=100, drain_grace=700)
        wls = [synthetic_workload(cfg, r, 300, seed=11) for r in (0.02, 0.08)]
        res = xsimulate(cfg, wls, ("MU", "DPM"), device="cuda")
        tr, geom, kw = engine_inputs(res, cfg, "cuda")
        kerns, _, _ = check_routes(f"{topo}8x8", tr, geom, kw)
        if topo == "mesh":
            cycle_cases["mesh8x8"] = (tr, geom, kw, kerns["cluster_smem"])
        for variant, kern in kerns.items():
            if not ((kern["ctr"].cpu().numpy() == res.ctr).all()
                    and (kern["crel"].cpu().numpy() == res.crel).all()):
                fail(f"the {variant} kernel differs from xsimulate's run "
                     f"on {topo}")
        for w, rate in enumerate((0.02, 0.08)):
            for a, algo in enumerate(res.algos):
                st = res.stats(w, a)
                lat = f"{st.avg_latency:.4f}"
                pj = f"{st.dyn_energy_pj(cfg.energy):.1f}"
                say("paper8x8", topo=topo, rate=rate, algo=algo,
                    avg_latency=lat, dyn_energy_pj=pj,
                    drained=res.all_drained(w, a))
                check_earlier("paper8x8", topo, rate, algo, lat, pj)

    # credit-limited: 2-flit buffers, worms of 1..6 flits (BD < F)
    import dataclasses

    cfg = NoCConfig(buffer_depth=2, warmup=100, drain_grace=700)
    wls = [synthetic_workload(cfg, r, 300, seed=12) for r in (0.02, 0.06)]
    for wl in wls:
        wl.requests = [dataclasses.replace(r, flits=1 + i % 6)
                       for i, r in enumerate(wl.requests)]
    res = xsimulate(cfg, wls, ("MU", "DPM"), device="cuda")
    tr, geom, kw = engine_inputs(res, cfg, "cuda")
    if not kw["BD"] < kw["F"]:
        fail(f"credit-limited case has BD={kw['BD']} >= F={kw['F']}")
    check_routes("mesh8x8-bd2-flits1to6", tr, geom, kw, BD=kw["BD"],
                 F=kw["F"],
                 flit_hops=int(res.ctr[:, 0].astype("int64").sum()))

    # 32x32: the largest grid, 128 routers a rank (the block kernel's
    # scratch no longer fits shared memory); the torus's wrap links join
    # ranks 0 and K - 1
    for grid, topo, rates in (("mesh32x32", "mesh", (0.01, 0.03)),
                              ("torus32x32", "torus", (0.02,))):
        cfg = NoCConfig(n=32, topology=topo, warmup=100, drain_grace=400)
        wls = [synthetic_workload(cfg, r, 300, seed=13) for r in rates]
        res = xsimulate(cfg, wls, ("MU", "DPM"), device="cuda")
        tr, geom, kw = engine_inputs(res, cfg, "cuda")
        kerns, _, p_ms = check_routes(
            grid, tr, geom, kw,
            flit_hops=int(res.ctr[:, 0].astype("int64").sum()))
        if grid == "mesh32x32":
            cycle_cases[grid] = (tr, geom, kw, kerns["cluster_smem"])
            routes = time_routes(tr, geom, kw)
            b_ms, b_by, _, _ = bound_ms(tr, kerns["cluster_smem"], kw)
            blk, cl = routes["block"][0], routes["cluster_smem"][0]
            say("noc_cycle_routes", grid=grid, block_ms=f"{blk:.3f}",
                cluster_ms=f"{cl:.3f}",
                block_ms_runs=",".join(f"{t:.3f}" for t in routes["block"][1]),
                cluster_ms_runs=",".join(
                    f"{t:.3f}" for t in routes["cluster_smem"][1]),
                block_over_cluster=f"{blk / cl:.2f}", plain_ms=f"{p_ms:.1f}",
                bound_ms=f"{b_ms:.4f}", bound_by=b_by)

    # ---- 4. main path: the 16x16 four-algorithm sweep ---------------------
    from repro_torch.core import arena_clear, plan_cache_clear

    cfg = NoCConfig(n=16, dest_range=(4, 8), warmup=100, drain_grace=400)
    arena_clear()
    plan_cache_clear()
    KERNEL.reset()
    t0 = time.monotonic()
    curves, res = noc.latency_vs_rate_batched(
        cfg, list(MAIN_RATES), MAIN_ALGOS, cycles=MAIN_CYCLES, seed=0,
        device="cuda",
    )
    wall = time.monotonic() - t0
    launches, routes = KERNEL.launches, dict(KERNEL.variants)
    if launches <= 0:
        fail("the main path never launched the noc_cycle kernel")
    if routes != {"cluster_smem": launches, "block": 0}:
        fail(f"the main path took another route than cluster_smem: {routes}")
    cluster = dict(KERNEL.cluster)
    B = len(MAIN_RATES) * len(MAIN_ALGOS)
    for algo, pts in curves.items():
        for rate, lat in pts:
            say("main", algo=algo, rate=rate, avg_latency=f"{lat:.4f}")
    flit = res.ctr[:, 0].astype("int64").sum()
    for w, rate in enumerate(MAIN_RATES):
        for a, algo in enumerate(res.algos):
            st = res.stats(w, a)
            lats = st.latencies
            if not lats or min(lats) <= 0:
                fail(f"no positive latencies for {algo} at rate {rate}")
            pj = f"{st.dyn_energy_pj(cfg.energy):.1f}"
            if algo in ("MU", "DPM"):
                say("energy", algo=algo, rate=rate, dyn_energy_pj=pj)
            check_earlier("main", "mesh", rate, algo,
                          f"{res.avg_latency(w, a):.4f}", pj)
    for a, algo in enumerate(res.algos):
        if not res.all_drained(0, a):
            fail(f"{algo} did not drain at the lowest rate {MAIN_RATES[0]}")
    say("main_timing", host_compile_s=f"{res.compile_s:.3f}",
        device_s=f"{res.device_s:.6f}", wall_s=f"{wall:.3f}",
        instances=B, cycles=res.cycles, launches=launches,
        flit_hops=int(flit),
        hops_per_device_s=f"{flit / res.device_s:.0f}",
        hops_per_wall_s=f"{flit / wall:.0f}",
        device_us_per_cycle_instance=f"{res.device_s / (res.cycles * B) * 1e6:.4f}",
        variant="cluster_smem", cluster_k=cluster["K"],
        threads=cluster["threads"],
        resident_clusters=cluster["resident_clusters"],
        idle_sms=max(0, torch.cuda.get_device_properties(0).multi_processor_count
                     - B * cluster["K"]))

    # host breakdown: the planning share of compile_s, replayed cold as
    # compile_workload plans (bulk_plan per workload and algorithm): MU, MP
    # and NMP plan on the host through the arena, DPM in batches on the
    # card, its dense tables (route prices, label chains, membership) built
    # anew as in the main path's first DPM call
    import repro_torch.core.batch_planner as bpm
    import repro_torch.core.routefn as routefn
    from repro_torch.core import bulk_plan, make_topology, planner_for

    g = make_topology(cfg.topology, cfg.n, cfg.m)
    wls = [synthetic_workload(cfg, r, MAIN_CYCLES, seed=0) for r in MAIN_RATES]
    plan_cache_clear()
    arena_clear()
    routefn._route_cost_matrices_cached.cache_clear()
    bpm._label_chain_matrices_cached.cache_clear()
    bpm.membership_table.cache_clear()
    per_algo = {}
    tables_s = 0.0
    for algo in MAIN_ALGOS:
        t0 = time.monotonic()
        if algo == "DPM":
            planner_for(g, algo, device="cuda")._tables()
            tables_s = time.monotonic() - t0
        for wl in wls:
            bulk_plan(g, [(r.src, r.dests) for r in wl.requests], algo,
                      device="cuda")
        torch.cuda.synchronize()
        per_algo[algo] = time.monotonic() - t0
    plan_s = sum(per_algo.values())
    dpm_info = planner_for(g, "DPM", device="cuda").info()
    say("main_breakdown", plan_s=f"{plan_s:.3f}",
        plan_host_mu_mp_nmp_s=f"{plan_s - per_algo['DPM']:.3f}",
        plan_dpm_arena_s=f"{per_algo['DPM']:.3f}",
        dpm_tables_s=f"{tables_s:.3f}",
        dpm_batched_plans=dpm_info.batched_plans,
        dpm_dispatches=dpm_info.dispatches,
        per_algo_s=",".join(f"{a}:{t:.3f}" for a, t in per_algo.items()),
        lower_stack_copy_s=f"{res.compile_s - plan_s:.3f}",
        device_s=f"{res.device_s:.6f}",
        rest_s=f"{wall - res.compile_s - res.device_s:.3f}",
        device_busy_share_of_wall=f"{res.device_s / wall:.6f}",
        requests=sum(len(wl.requests) for wl in wls))

    # both routes against the plain version on the main path's own inputs,
    # then timed in turns
    tr, geom, kw = engine_inputs(res, cfg, "cuda")
    kerns, plain, p_ms = check_routes("mesh16x16", tr, geom, kw)
    err = max(compare(k, plain)[1] for k in kerns.values())
    kern = kerns["cluster_smem"]
    for variant, k in kerns.items():
        if not (k["ctr"].cpu().numpy() == res.ctr).all():
            fail(f"a {variant} run differs from the main path's counters")
    routes = time_routes(tr, geom, kw)
    ms, times = routes["cluster_smem"]
    b_ms, b_by, nbytes, ops = bound_ms(tr, kern, kw)
    # the state-streaming bound: every cycle reads all CycleState planes
    # once from HBM (one epoch row of the telemetry planes), over T cycles
    pl = kern["planes"]
    state = sum(t.numel() * t.element_size() for f, t in zip(pl._fields, pl)
                if f not in ("lutil", "rconf"))
    state += (pl.lutil[:, 0].numel() + pl.rconf[:, 0].numel()) * 4
    stream_ms = kw["T"] * state / HBM_BYTES_PER_S * 1e3
    blk = routes["block"][0]
    cycle_cases["mesh16x16"] = (tr, geom, kw, kern)
    NOC_CYCLE_CASES.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v[:3] for k, v in cycle_cases.items()}, NOC_CYCLE_CASES)
    alone = child_json("--noc-cycle-alone")
    NOC_CYCLE_CASES.unlink()
    for grid, (c_tr, _, c_kw, c_kern) in cycle_cases.items():
        c_bound = bound_ms(c_tr, c_kern, c_kw)[0]
        for variant, a_ms in alone[grid].items():
            if a_ms is None:
                fail(f"no device time for the {variant} kernel on {grid}")
            say("kernel_time", kernel="noc_cycle", grid=grid,
                variant=variant, kernel_alone_ms=f"{a_ms:.4f}",
                bound_ms=f"{c_bound:.4f}",
                alone_times_bound=f"{a_ms / c_bound:.1f}")
    say("noc_cycle_routes", grid="mesh16x16", instances=B, cycles=kw["T"],
        block_ms=f"{blk:.3f}", cluster_ms=f"{ms:.3f}",
        block_ms_runs=",".join(f"{t:.3f}" for t in routes["block"][1]),
        cluster_ms_runs=",".join(f"{t:.3f}" for t in times),
        block_over_cluster=f"{blk / ms:.2f}", max_abs_err=err,
        plain_ms=f"{p_ms:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bytes=nbytes, ops=ops, state_bytes_per_cycle=state,
        state_stream_bound_ms=f"{stream_ms:.4f}")

    # ---- 5. cost-table kernels and the planning path ---------------------
    dpm_entries = phase_cost_tables(cfg)

    # ---- 6. batched planning and the plan server -------------------------
    phase_bulk_plan(cfg)

    # ---- 7. the ML serving path: hymba-1.5b, flash attention, SSD --------
    serve_entries = phase_serve()

    # ---- 8. the segmented-min kernel through segmin / arbitrate ----------
    segmin_entries = phase_segmin()

    # ---- 9. the host NoC: WormholeSim, simulate, against xsim -------------
    phase_host_sim()

    # ---- 10. kernels line and result --------------------------------------
    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the reference package")
    print(json.dumps({"kernels": [{
        "name": "noc_cycle",
        "route": "cuda",
        "source": "src/repro_torch/kernels/noc_cycle/csrc/noc_cycle.cu",
        "replaces": "src/repro/kernels/noc_cycle/noc_cycle.py:36",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }] + dpm_entries + serve_entries + segmin_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
