#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace of one flash-backward call lacks
one of the call's three kernels (delta, dK/dV, dQ), traced three ways:

- ``plain``: a profiler started around the call;
- ``pad``: the same, with a spin kernel of about 1 ms
  (``torch.cuda._sleep``) launched before the call and after it;
- ``warmup``: ``chip_smoke.trace_kernels``, the call traced in the step
  after a profiler warm-up step of the same call.

    python3 tools/profiler_drops.py [--traces N]

At stablelm's training shape (B = 2, S = 4,096, 32 heads of 64) and
deepseek's MLA (128 heads, q/k 192, v 128), both backward routes, bf16:
N traces (default 20) of one call each way. Prints the card's name and
power limit, then one ``[profiler_drops]`` line a case and way: the
traces that held all three kernels, those that lacked the first-launched
(delta) and those that lacked another, and the median and least device
ms of the complete traces beside the call's CUDA-event time (median of
3). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))

SHAPES = {"stablelm": (2, 4096, 32, 64, 64), "mla": (2, 4096, 128, 192, 128)}
PAD_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz


def started_around(fn, pad: bool) -> dict:
    """``trace_kernels``'s result for a profiler started around ``fn()``
    (with ``pad``, fenced by spin kernels, which it leaves out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad:
            torch.cuda._sleep(PAD_CYCLES)
        fn()
        if pad:
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if (t > 0 and e.device_type == DeviceType.CUDA
                and "spin_kernel" not in e.key):
            n, ms = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, ms + t / 1e3)
    return out


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=20)
    n = ap.parse_args().traces
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.flash_attention import BWD_ROUTES

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    for case, (B, S, H, D, Dv) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                         .to(torch.bfloat16)
                         for shape in ((B, S, H, D), (B, S, H, D),
                                       (B, S, H, Dv), (B, S, H, Dv)))
        out, lse = flash_attention_cuda(q, k, v, return_lse=True)
        for route in BWD_ROUTES:
            def fn(route=route):
                return flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                route=route)
            fn()
            event_ms = statistics.median(cs.timed(fn)[1] for _ in range(3))
            ways = {"plain": lambda: started_around(fn, False),
                    "pad": lambda: started_around(fn, True),
                    "warmup": lambda: cs.trace_kernels(fn)}
            for way, trace in ways.items():
                complete, no_delta, other, times = 0, 0, 0, []
                for _ in range(n):
                    seen = {name: nm for name, nm in trace().items()
                            if "flash_bwd" in name}
                    if sum(c for c, _ in seen.values()) == 3:
                        complete += 1
                        times.append(sum(ms for _, ms in seen.values()))
                    elif not any("delta" in name for name in seen):
                        no_delta += 1
                    else:
                        other += 1
                cs.say("profiler_drops", case=case, route=route, way=way,
                       traces=n, complete=complete, lacking_delta=no_delta,
                       lacking_another=other,
                       complete_median_ms=(f"{statistics.median(times):.4f}"
                                           if times else "none"),
                       complete_min_ms=(f"{min(times):.4f}" if times
                                        else "none"),
                       event_ms=f"{event_ms:.4f}")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
