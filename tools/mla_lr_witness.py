#!/usr/bin/env python3
"""The learning rate of ``chip_smoke.py``'s ``[train_mla]``, witnessed on
the plain attention path.

    python3 tools/mla_lr_witness.py

deepseek-v2-236b at full width, cut to its dense first layer
(``MLA_TRAIN_LAYOUT``), trains ``STEPS`` steps from one seed at
the training CLI's learning rate (``TRAIN_LR``) and at ``MLA_TRAIN_LR``,
each on the kernel path and on the plain path (``chip_smoke.plain_path``:
``flash_attention_ref`` in the flash kernels' place, forward and backward),
on one sequence of ``TRAIN_SEQ`` tokens: at 128 heads the plain path's
S x S tensors leave no room for the second row of ``TRAIN_BATCH``. If the
losses at ``TRAIN_LR`` fail to fall on the plain path as on the kernel
path, the learning rate, not the kernels, is at fault. Prints the card's
name and power limit, then one ``[lr_witness]`` line a run: the path, the
learning rate, its flash launches (forward, backward) and its losses.
Needs one CUDA card; exits non-zero without one, or when a run is not
finite or launches flash kernels on the wrong path.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(cs.SRC))

STEPS = 8


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.train import LoopConfig, train

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    cfg = cs.cut_depth(ARCHS[cs.MLA_ARCH], cs.MLA_TRAIN_LAYOUT)
    loop = LoopConfig(steps=STEPS, batch=1, seq=cs.TRAIN_SEQ,
                      log_every=0, seed=0)
    for lr in (cs.TRAIN_LR, cs.MLA_TRAIN_LR):
        run = dataclasses.replace(cs.train_run_config(), learning_rate=lr)
        for path in ("kernel", "plain"):
            torch.cuda.reset_peak_memory_stats()
            f0, b0 = FLASH_KERNEL.launches, BWD_KERNEL.launches
            if path == "plain":
                with cs.plain_path():
                    res = train(cfg, run, loop, device="cuda")
            else:
                res = train(cfg, run, loop, device="cuda")
            n = (FLASH_KERNEL.launches - f0, BWD_KERNEL.launches - b0)
            cs.say("lr_witness", arch=cfg.name, path=path, lr=lr, batch=1,
                   seq=cs.TRAIN_SEQ, steps=loop.steps,
                   flash_fwd_bwd_launches=f"{n[0]}+{n[1]}",
                   losses=",".join(repr(x) for x in res.losses),
                   falls=res.losses[-1] < res.losses[0],
                   peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
            want = (loop.steps,) * 2 if path == "kernel" else (0, 0)
            if n != want:
                cs.fail(f"the {path} path launched flash forward/backward {n}")
            if not all(map(math.isfinite, res.losses)):
                cs.fail(f"{path} at lr {lr}: losses not finite {res.losses}")
            del res
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
