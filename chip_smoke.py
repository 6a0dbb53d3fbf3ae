#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing what it found on its own line; any failure exits
non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the CUDA cycle kernel (``kernels/noc_cycle/csrc``) and the two
   cost-table kernels (``kernels/dpm_cost/csrc``), one ``nvcc`` each, in
   parallel, with ptxas' register and spill report;
3. kernel vs plain: on an 8x8 mesh and torus with the paper's Table I
   (``NoCConfig()`` defaults), MU and DPM at two injection rates, the kernel
   must equal the plain PyTorch cycle on every output and final plane; the
   same on an 8x8 mesh with 2-flit buffers under worms of 1 to 6 flits
   (the credit-limited branch that Table I's 4-flit buffers never take);
4. main path: ``latency_vs_rate_batched`` on a 16x16 mesh, MU/MP/NMP/DPM x 4
   rates in one batched launch through ``xsimulate(device="cuda")``, DPM
   planned in batches on the card (``bulk_plan``); the lowest rate must
   drain, the kernel's launch counter must move, the kernel must equal the
   plain cycle on the same inputs, and the latencies and energies must
   equal the ones the port gave before batched planning;
5. cost tables: ``dpm_cost_table`` and ``dpm_cost_table_weighted`` (hops,
   weighted; energy within rtol 1e-6) and ``dpm_plan`` against their plain
   versions on every request of the 16x16 sweep, an 8x8 torus and an 8x4
   mesh, source leg on and off; then the planning path ``dpm_plan`` /
   ``dpm_plan_weighted`` on the sweep's requests, with the launch counts
   set to 0 before it and read after;
6. batched planning: the sweep's DPM requests through ``bulk_plan`` on the
   card, every plan equal to host ``plan()``, plans/s against host
   ``plan()``; then a few thousand requests through a ``PlanServer``;
7. the ``kernels`` JSON line, then the result line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks at the full 700 W power limit: HBM bandwidth from NVIDIA's
# data sheet; int32 issue rate from the Hopper architecture (64 INT32 lanes
# per SM x 132 SMs x 1.98 GHz boost, one operation per lane and clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

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


def run_both(tr, geom, kw):
    """The kernel (through ``run_cycles``) and the plain version by name,
    on the same CUDA tensors; returns both outputs and their times (ms)."""
    from repro_torch.kernels.noc_cycle import (
        TABLE_FIELDS, geometry_tensors, run_cycles, run_cycles_ref,
    )

    kern, k_ms = timed(lambda: run_cycles(tr, geom, **kw))
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


def first_divergence(tr, geom, kw) -> None:
    """Bisect the first cycle count after which kernel and plain differ and
    print what differs there (a diagnostic for a failed comparison)."""
    lo, hi = 0, kw["T"]  # equal after lo cycles, different after hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        kern, plain, _, _ = run_both(tr, geom, dict(kw, T=mid))
        if compare(kern, plain)[0]:
            hi = mid
        else:
            lo = mid
    kern, plain, _, _ = run_both(tr, geom, dict(kw, T=hi))
    say("divergence", first_bad_cycle=hi - 1,
        differs=",".join(compare(kern, plain)[0]))


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


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
    from repro_torch.kernels.noc_cycle import KERNEL

    kernels = [("noc_cycle", KERNEL), ("dpm_cost", DPM_KERNEL)]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for f in [pool.submit(k.build) for _, k in kernels]:
            f.result()
    wall = time.monotonic() - t0
    for name, k in kernels:
        say("build", library=name, seconds=f"{wall:.2f}",
            nvcc_seconds=f"{k.build_seconds:.2f}")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] ptxas: {line.strip()}", flush=True)


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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def sweep_requests(cfg) -> list:
    """Every request of the 16x16 sweep, all rates, as (src, dests)."""
    from repro_torch.noc import synthetic_workload

    wls = [synthetic_workload(cfg, r, MAIN_CYCLES, seed=0) for r in MAIN_RATES]
    return [(r.src, r.dests) for wl in wls for r in wl.requests]


def phase_cost_tables(cfg16) -> list:
    """Both cost-table kernels and ``dpm_plan`` against their plain versions
    on three fabrics, then the planning path with the counts zeroed.
    Returns the kernels-line entries of the two kernels."""
    import torch

    from repro_torch.core import (
        get_cost_model, make_topology, route_cost_matrices,
    )
    from repro_torch.kernels.dpm_cost import (
        KERNEL as DPM_KERNEL, dpm_cost_table, dpm_cost_table_ref,
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

    cases = [
        ("sweep16x16", make_topology("mesh", 16, 16), False,
         sweep_requests(cfg16)),
        ("torus8x8", make_topology("torus", 8, 8), True,
         small_requests(NoCConfig(topology="torus", dest_range=(4, 8)))),
        ("mesh8x4", make_topology("mesh", 8, 4), False,
         small_requests(NoCConfig(n=8, m=4, dest_range=(4, 8)))),
    ]
    timing: dict = {}
    for grid_name, g, wrap, reqs in cases:
        n, m = g.n, g.rows
        mask, sxy = dpm_inputs(g, reqs, "cuda")
        P, NN = mask.shape
        routes = {model: route_tensors(g, model)
                  for model in ("hops", "weighted", "energy")}
        for leg in (True, False):
            kw = dict(n=n, m=m, wrap=wrap, include_source_leg=leg)
            (kc, kr), k_ms = median_ms(lambda: dpm_cost_table(mask, sxy, **kw))
            (pc, pr), p_ms = median_ms(
                lambda: dpm_cost_table_ref(mask, sxy, **kw))
            eq_c, err_c = tensor_diff(kc, pc)
            eq_r, err_r = tensor_diff(kr, pr)
            err = max(err_c, err_r)
            say("kernel_vs_plain", kernel="dpm_cost_table", grid=grid_name,
                leg=leg, P=P, NN=NN, equal=eq_c and eq_r, max_abs_err=err,
                kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
            if not (eq_c and eq_r):
                fail(f"dpm_cost_table != plain on {grid_name} leg={leg}")
            if grid_name == "sweep16x16" and leg:
                timing["dpm_cost_table"] = (k_ms, p_ms, err,
                                            dpm_bound_ms(mask, wrap, False))
            plan_k = dpm_plan(mask, sxy, **kw, device="cuda")
            plan_p = (_greedy_merge(pc, pr), pc, pr)
            diffs = [tensor_diff(a, b) for a, b in zip(plan_k, plan_p)]
            say("kernel_vs_plain", kernel="dpm_plan", grid=grid_name,
                leg=leg, P=P, outputs="chosen/costs/reps",
                equal=all(e for e, _ in diffs),
                max_abs_err=max(d for _, d in diffs))
            if not all(e for e, _ in diffs):
                fail(f"dpm_plan != plain on {grid_name} leg={leg}")
            for model, (dist, w, oh) in routes.items():
                wkw = dict(kw, overhead=oh)
                (kc, kr), k_ms = median_ms(lambda: dpm_cost_table_weighted(
                    mask, sxy, dist, w, **wkw))
                (pc, pr), p_ms = median_ms(
                    lambda: dpm_cost_table_weighted_ref(
                        mask, sxy, dist, w, **wkw))
                eq_c, err_c = tensor_diff(kc, pc)
                eq_r, err_r = tensor_diff(kr, pr)
                err = max(err_c, err_r)
                rel = float(((kc - pc).abs()
                             / pc.abs().clamp(min=1e-30)).max())
                exact = model != "energy"
                ok = eq_r and (eq_c if exact else rel <= ENERGY_RTOL)
                say("kernel_vs_plain", kernel="dpm_cost_table_weighted",
                    grid=grid_name, model=model, leg=leg, P=P, NN=NN,
                    equal=eq_c and eq_r, max_abs_err=err,
                    max_rel_err=f"{rel:.3g}",
                    tolerance="exact" if exact else f"rtol={ENERGY_RTOL}",
                    kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
                if not ok:
                    fail(f"dpm_cost_table_weighted != plain on {grid_name} "
                         f"{model} leg={leg}")
                if grid_name == "sweep16x16" and leg and model == "hops":
                    timing["dpm_cost_table_weighted"] = (
                        k_ms, p_ms, err, dpm_bound_ms(mask, wrap, True))
                if exact:
                    plan_k = dpm_plan_weighted(mask, sxy, dist, w, **wkw,
                                               device="cuda")
                    plan_p = (_greedy_merge(pc, pr), pc, pr)
                    if not all(tensor_diff(a, b)[0]
                               for a, b in zip(plan_k, plan_p)):
                        fail(f"dpm_plan_weighted != plain on {grid_name} "
                             f"{model} leg={leg}")

    # the planning path: dpm_plan and dpm_plan_weighted (hops, weighted) on
    # every request of the sweep, the launch counts set to 0 just before
    # and read just after
    g, reqs = cases[0][1], cases[0][3]
    mask, sxy = dpm_inputs(g, reqs, "cuda")
    tensors = {model: route_tensors(g, model) for model in ("hops", "weighted")}
    DPM_KERNEL.reset()
    chosen, _, _ = dpm_plan(mask, sxy, n=16, device="cuda")
    for model, (dist, w, oh) in tensors.items():
        dpm_plan_weighted(mask, sxy, dist, w, n=16, overhead=oh,
                          device="cuda")
    torch.cuda.synchronize()
    launches = dict(DPM_KERNEL.launches)
    for name, count in launches.items():
        if count <= 0:
            fail(f"the planning path never launched {name}")
    say("dpm_path", requests=len(reqs),
        launches=",".join(f"{k}:{v}" for k, v in launches.items()),
        merged_partitions=int(chosen[:, 8:].sum()),
        partitions_per_request=f"{float(chosen.sum()) / len(reqs):.4f}")
    # the kernels alone, without the wrappers' checks and allocations
    dist, w, oh = tensors["hops"]
    alone = {
        "dpm_cost_table": profiled_ms(
            lambda: dpm_cost_table(mask, sxy, n=16), "cost_table_kernel"),
        "dpm_cost_table_weighted": profiled_ms(
            lambda: dpm_cost_table_weighted(mask, sxy, dist, w, n=16,
                                            overhead=oh),
            "cost_table_weighted_kernel"),
    }
    entries = []
    for name, (k_ms, p_ms, err, (b_ms, b_by, nbytes, ops)) in timing.items():
        t_alone = alone[name][0]
        say("dpm_bound", kernel=name, bound_ms=f"{b_ms:.5f}", bound_by=b_by,
            bytes=nbytes, ops=ops, kernel_ms=f"{k_ms:.4f}",
            times_bound=f"{k_ms / b_ms:.1f}",
            kernel_alone_ms="not measured" if t_alone is None
            else f"{t_alone:.4f}")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/dpm_cost/csrc/dpm_cost.cu",
            "replaces": ("src/repro/kernels/dpm_cost/dpm_cost.py:169"
                         if name == "dpm_cost_table"
                         else "src/repro/kernels/dpm_cost/dpm_cost.py:213"),
            "launches": launches[name],
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    return entries


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


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")

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
    for topo in ("mesh", "torus"):
        cfg = NoCConfig(topology=topo, warmup=100, drain_grace=700)
        wls = [synthetic_workload(cfg, r, 300, seed=11) for r in (0.02, 0.08)]
        res = xsimulate(cfg, wls, ("MU", "DPM"), device="cuda")
        tr, geom, kw = engine_inputs(res, cfg, "cuda")
        kern, plain, k_ms, p_ms = run_both(tr, geom, kw)
        bad, err = compare(kern, plain)
        B = tr["link"].shape[0]
        same_main = bool(
            (kern["ctr"].cpu().numpy() == res.ctr).all()
            and (kern["crel"].cpu().numpy() == res.crel).all()
        )
        say("kernel_vs_plain", grid=f"{topo}8x8", instances=B,
            cycles=kw["T"], equal=not bad, max_abs_err=err,
            kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}",
            repeat_matches_xsimulate=same_main)
        if bad:
            first_divergence(tr, geom, kw)
            fail(f"kernel != plain on {topo} 8x8: {', '.join(bad)}")
        if not same_main:
            fail(f"a second kernel run differs from xsimulate's on {topo}")
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
    kern, plain, k_ms, p_ms = run_both(tr, geom, kw)
    bad, err = compare(kern, plain)
    say("kernel_vs_plain", grid="mesh8x8-bd2-flits1to6",
        instances=tr["link"].shape[0], cycles=kw["T"], BD=kw["BD"],
        F=kw["F"], equal=not bad, max_abs_err=err,
        kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}",
        flit_hops=int(res.ctr[:, 0].astype("int64").sum()))
    if bad:
        first_divergence(tr, geom, kw)
        fail(f"kernel != plain with BD < F: {', '.join(bad)}")

    # ---- 4. main path: the 16x16 four-algorithm sweep ---------------------
    from repro_torch.core import arena_clear, plan_cache_clear

    cfg = NoCConfig(n=16, dest_range=(4, 8), warmup=100, drain_grace=400)
    arena_clear()
    plan_cache_clear()
    KERNEL.launches = 0
    t0 = time.monotonic()
    curves, res = noc.latency_vs_rate_batched(
        cfg, list(MAIN_RATES), MAIN_ALGOS, cycles=MAIN_CYCLES, seed=0,
        device="cuda",
    )
    wall = time.monotonic() - t0
    launches = KERNEL.launches
    if launches <= 0:
        fail("the main path never launched the noc_cycle kernel")
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
        scratch_in_smem=KERNEL.scratch_in_smem,
        idle_sms=max(0, torch.cuda.get_device_properties(0).multi_processor_count - B))

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

    # the kernel against the plain version on the main path's own inputs
    tr, geom, kw = engine_inputs(res, cfg, "cuda")
    kern, plain, k_ms, p_ms = run_both(tr, geom, kw)
    bad, err = compare(kern, plain)
    if bad:
        fail(f"kernel != plain on the 16x16 main path: {', '.join(bad)}")
    if not (kern["ctr"].cpu().numpy() == res.ctr).all():
        fail("a second kernel run differs from the main path's counters")
    from repro_torch.kernels.noc_cycle import run_cycles

    times = [timed(lambda: run_cycles(tr, geom, **kw))[1] for _ in range(3)]
    ms = sorted(times)[1]
    b_ms, b_by, nbytes, ops = bound_ms(tr, kern, kw)
    # the state-streaming bound: every cycle reads all CycleState planes
    # once from HBM (one epoch row of the telemetry planes), over T cycles
    pl = kern["planes"]
    state = sum(t.numel() * t.element_size() for f, t in zip(pl._fields, pl)
                if f not in ("lutil", "rconf"))
    state += (pl.lutil[:, 0].numel() + pl.rconf[:, 0].numel()) * 4
    stream_ms = kw["T"] * state / HBM_BYTES_PER_S * 1e3
    say("kernel_vs_plain", grid="mesh16x16", instances=B, cycles=kw["T"],
        equal=True, max_abs_err=err, kernel_ms=f"{ms:.3f}",
        kernel_ms_runs=",".join(f"{t:.3f}" for t in times),
        plain_ms=f"{p_ms:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bytes=nbytes, ops=ops, state_bytes_per_cycle=state,
        state_stream_bound_ms=f"{stream_ms:.4f}")

    # ---- 5. cost-table kernels and the planning path ---------------------
    dpm_entries = phase_cost_tables(cfg)

    # ---- 6. batched planning and the plan server -------------------------
    phase_bulk_plan(cfg)

    # ---- 7. kernels line and result ---------------------------------------
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
    }] + dpm_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
