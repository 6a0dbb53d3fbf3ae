"""Training CLI. Twin of ``repro.launch.train``, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 8 --batch 2 --seq 4096                # full size, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        --device cpu                                  # plain PyTorch, CPU

The CLI trains in one process, its master weights, moments and gradients
whole. ``train`` called on each rank of a process group under a
``shardctx`` mesh of data axes trains over those ranks with ZeRO-1
(``RunConfig.zero1``: each rank keeps its blocks of the state;
``train.optim.DataParallel``), and resumes from a checkpoint of any mesh
(README: "ZeRO-1 and elastic restore"). Attention runs in the
hand-written forward and backward kernels, MLA's (q/k 192, v 128) too; an
SSD layer (hymba, mamba2) in the SSD forward and backward kernels:

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 8 --batch 2 --seq 4096                # SSD, on the card
"""
from __future__ import annotations

import argparse

from ..configs import get_arch
from ..models import RunConfig
from ..train import LoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, smoke=args.smoke)
    run = RunConfig(
        remat="none",
        attn_chunk_q=min(512, args.seq),
        attn_chunk_k=min(1024, args.seq),
        learning_rate=args.lr,
        vocab_round=64 if args.smoke else 128,
    )
    res = train(
        cfg,
        run,
        LoopConfig(
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            seed=args.seed,
            accum=args.accum,
        ),
        device=args.device,
    )
    print(
        f"done: {res.final_step} steps, loss {res.losses[0]:.3f} -> "
        f"{res.losses[-1]:.3f}, wall {res.wall_s:.1f}s, "
        f"resumed_from={res.resumed_from}, stragglers={len(res.straggler_steps)}"
    )


if __name__ == "__main__":
    main()
