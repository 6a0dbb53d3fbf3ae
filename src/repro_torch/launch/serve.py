"""Serving CLI: batched requests against a smoke-scale model. Twin of
``repro.launch.serve``, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --requests 16 --max-tokens 16            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --device cpu                             # plain PyTorch on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --device cpu  # the MoE model
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-236b --device cpu     # MLA + MoE

Frame-input models (musicgen-medium, qwen2-vl-72b) serve through
``serve.generate`` on frame prompts; ``BatchServer`` batches token prompts,
as the reference's does.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_arch
from ..models import RunConfig, model_init
from ..serve import BatchServer, Request


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch, smoke=True)
    run = RunConfig(remat="none", attn_chunk_q=64, attn_chunk_k=64,
                    vocab_round=64)
    params, _ = model_init(0, cfg, run, device=args.device)
    server = BatchServer(params, cfg, run, max_batch=args.max_batch,
                         device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = rng.integers(4, args.prompt_len + 1)
        server.submit(
            Request(rid, rng.integers(0, cfg.vocab, plen), args.max_tokens)
        )
    done = 0
    while done < args.requests:
        for resp in server.serve_once():
            done += 1
            print(f"req {resp.rid}: {len(resp.tokens)} tokens, "
                  f"{resp.latency_s*1e3:.0f} ms")
    s = server.stats
    print(f"served {s['requests']} requests / {s['batches']} batches / "
          f"{s['tokens']} tokens")


if __name__ == "__main__":
    main()
