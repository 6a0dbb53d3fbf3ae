#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing what it found on its own line; any failure exits
non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the CUDA cycle kernel from ``src/repro_torch/kernels/noc_cycle/csrc``;
3. kernel vs plain: on an 8x8 mesh and torus with the paper's Table I
   (``NoCConfig()`` defaults), MU and DPM at two injection rates, the kernel
   must equal the plain PyTorch cycle on every output and final plane; the
   same on an 8x8 mesh with 2-flit buffers under worms of 1 to 6 flits
   (the credit-limited branch that Table I's 4-flit buffers never take);
4. main path: ``latency_vs_rate_batched`` on a 16x16 mesh, MU/MP/NMP/DPM x 4
   rates in one batched launch through ``xsimulate(device="cuda")``; the
   lowest rate must drain, the kernel's launch counter must move, and the
   kernel must equal the plain cycle on the same inputs;
5. the ``kernels`` JSON line, then the result line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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
    t0 = time.monotonic()
    KERNEL.build()
    say("build", seconds=f"{time.monotonic() - t0:.2f}",
        nvcc_seconds=f"{KERNEL.build_seconds:.2f}")
    for line in KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)

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
                say("paper8x8", topo=topo, rate=rate, algo=algo,
                    avg_latency=f"{st.avg_latency:.4f}",
                    dyn_energy_pj=f"{st.dyn_energy_pj(cfg.energy):.1f}",
                    drained=res.all_drained(w, a))

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
    cfg = NoCConfig(n=16, dest_range=(4, 8), warmup=100, drain_grace=400)
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
            if algo in ("MU", "DPM"):
                say("energy", algo=algo, rate=rate,
                    dyn_energy_pj=f"{st.dyn_energy_pj(cfg.energy):.1f}")
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

    # host breakdown: the planning share of compile_s, replayed cold
    from repro_torch.core import make_topology, plan, plan_cache_clear

    plan_cache_clear()
    g = make_topology(cfg.topology, cfg.n, cfg.m)
    wls = [synthetic_workload(cfg, r, MAIN_CYCLES, seed=0) for r in MAIN_RATES]
    t0 = time.monotonic()
    for wl in wls:
        for algo in MAIN_ALGOS:
            for r in wl.requests:
                plan(algo, g, r.src, r.dests)
    plan_s = time.monotonic() - t0
    say("main_breakdown", plan_s=f"{plan_s:.3f}",
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

    # ---- 5. kernels line and result ---------------------------------------
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
