#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing what it found on its own line; any failure exits
non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the CUDA cycle kernels (``kernels/noc_cycle/csrc``), the two
   cost-table kernels (``kernels/dpm_cost/csrc``), the flash-attention
   forward and backward kernels (``kernels/flash_attention/csrc``, three
   sources), the SSD intra-chunk kernels, forward and backward
   (``kernels/ssd/csrc``, two sources) and the segmented-min kernel
   (``kernels/noc_step/csrc``), one ``nvcc`` per source, all eight in
   parallel; one ``[build] ptxas:`` line per compiled kernel instance
   (registers, stack, spill stores and loads, static shared memory) and
   the attention (forward and backward) and SSD (forward and backward)
   instances' dynamic shared memory, held equal to the Python mirror that the CPU
   tests bound by 227 KB;
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
   in a child process; then (``[xsim_sharded]``) the same batch through
   ``noc.xsim.run._run_sharded`` (the reference's ``pmap`` over its
   devices) over the card listed four times: four ``cluster_smem``
   launches of 4 instances, the counts set to 0 just before, every output
   and final plane bit-equal to the one launch;
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
   seed 0, bf16-stored, bf16 activations) answers 8 requests of
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
   start on a fully masked key tile, Sk below one tile, D = 16, 32, 128,
   and D = 192 with GQA and a window and below one key tile;
   mamba2's N = 128, two groups at N = 16, the smoke widths' P = 32 at
   N = 32 and at N = 16 with a 100-step chunk);
   then timed, both dtypes, beside SDPA (attention, ``vs_sdpa``) and their
   bounds (``times_bound``), the kernel alone from a child process; and
   one bf16 prefill at batch 0's shape split by kernel family
   (``[prefill_split]``: attention, SSD, matrix products, the rest, and the
   device-busy share of the wall time);
7b. MoE serving (``[serve_moe]``, a child process, ``--serve-moe``):
   ``moonshot-v1-16b-a3b`` at full width and depth (28.9 B random
   parameters from seed 0, drawn layer by layer and stored as
   ``model_init`` stores them for a bf16 run: bf16 weights, f32 router and
   norms; bf16 activations) answers the same 8 requests through
   ``BatchServer(device="cuda")`` in 2 batches of 4; each prefill, the
   counts set to 0 just before it, must launch flash attention 48 times,
   all ``wgmma_bf16``; the peak memory; then, from an untimed prefill of
   each batch's padded prompts, its tokens per expert and dropped pairs.
   The flash kernel against its plain version on q/k/v captured from
   layers 0 and 47 of a full-width prefill (B = 4, S = 2,000, D = 128),
   bf16 and f32, also cut to batch 1's length and as a 64-query
   ``q_offset`` chunk, held both at the absolute tolerance and at a
   per-row relative one (each output row's error norm over its norm); ``[prefill_split]`` of one prefill (attention, the
   router, dispatch and combine, the routed and shared experts' products,
   the rest) from CUDA events on the stream; then the first two layers at
   full width in f32 on the kernel path against the plain path: logits
   within 1e-3 x max |logit| and every routed expert id equal, save where
   the plain path's top-k gap is under 1e-5; ``[kernel_time]`` of the
   D = 128 kernel beside SDPA and its bound;
7c. MLA serving (``[serve_mla]``, a child process, ``--serve-mla``):
   ``deepseek-v2-236b`` at full width, its dense first layer and 7 of its
   59 MoE layers (the cut fits the 80 GB card), bf16-stored weights, the
   same 8 requests through ``BatchServer``; each prefill must launch the
   bf16 flash kernel once a layer, all at the head-dim pair (192, 128)
   (q/k 128 + 64, v 128); the peak memory, routing from untimed prefills; the
   flash kernel against its plain version on the q/k/v of the first and
   last layers, bf16 and f32, with the cuts of 7b; ``[serve_vs_plain]`` of
   its first two layers (dense, MoE) in f32 as in 7b; ``[kernel_time]``
   of the D = 192 kernel against the bound of the function (v and the
   output at MLA's 128 value columns), the bound of the padded work the
   kernel does beside it;
7d. frame models (``[serve_frames]``, ``[serve_int8]``, a child process,
   ``--serve-frames``): ``musicgen-medium`` at full width and depth and
   ``qwen2-vl-72b`` at full width with 32 of its 80 layers (M-RoPE, GQA at
   G = 8) through ``generate`` on seeded numpy frame prompts, 2 batches of
   4; each prefill must launch the bf16 flash kernel once a layer at the
   model's head dim; then qwen2-vl with the int8 KV cache against the
   bf16 one, teacher-forced: every cached prompt element within half an
   int8 quantum of the bf16 cache's, every row a decode step wrote within
   half a quantum of the K/V it quantized, and the logits within
   2 sqrt(layers) / 254 of max |logit|; two planted faults of the int8
   path (zero scales written on decode, the first layer's V scales zeroed
   over the prompt) must be flagged by the element check, and whether the
   logit bound flags them too is printed (``[serve_int8_fault]``); then,
   for each model, the flash kernel against its plain version on the q/k/v
   of the first and last layers of a full-width prefill of seeded frames
   (B = 4, S = 2,000), bf16 and f32, with the cuts of 7b, and
   ``[serve_vs_plain]`` of its first two layers in f32 (for qwen2-vl:
   M-RoPE and GQA at G = 8);
7e. training (``[train]``, a child process, ``--train``): first the flash
   backward at stablelm's training shape (B = 2, S = 4,096, 32 heads of
   64, bf16) on both routes from one run (``wgmma``, the main path's, and
   ``mma_sync``, the comparison), each alone from the profiler and through
   its wrapper (the routes in turns), beside the plain version, SDPA's
   backward, the bound (10 D a visible pair) and the two-pass design's
   floor (14 D) (``[kernel_time] kernel=flash_attention_bwd route=``);
   then ``stablelm-1.6b`` at full width and depth (1.64 B random
   parameters from seed 0, f32 master weights and
   AdamW moments, bf16 compute copy) trains 8 steps of B = 2 sequences of
   4,096 tokens of ``synthetic_batch`` (seed 0, lr 3e-3, remat "none": the
   training CLI's recipe) through ``repro_torch.train.train``: each step's
   loss, grad norm and ms, the median step, tokens/s, the model-flops
   share of the bf16 peak and the peak memory; the losses must be finite
   and the last below the first, and the launch counts, set to 0 just
   before, must show 24 forward (``wgmma_bf16``) and 24 backward
   (``wgmma_bf16``) launches a step and no ``mma_bf16`` or f32 kernel. One
   step split by CUDA events (``[train_split]``: forward, backward, the
   flash kernels inside each, clip, AdamW); the backward kernels against
   their plain version on the q/k/v and output gradients of layers 0 and
   23 of that step and on seeded edge cases (GQA at G = 3 and 8, windows,
   Sk below one tile, D = 16, 32, 128, a 40-query chunk at q_offset 60 of
   100 keys under a window), bf16 on both routes at a per-row bound and
   f32 within 1e-5 x max |.|, two calls bit-equal; the first two layers in
   f32 on the kernel path against the plain path (loss within 1e-5
   relative, every gradient leaf within 1e-3 x its max |.|); ``smollm-135m``
   at full width
   trained 6 steps with a checkpoint at step 3, a run resumed from it
   beside the continuous run, and a saved state restored bit for bit;
7e'. MLA training (``[train_mla]``, ``--train-mla``): deepseek-v2-236b's
   dense first layer, the flash forward and backward at (192, 128);
7e''. SSD training (``[train_ssd]``, a child process, ``--train-ssd``):
   the SSD backward kernel (``kernels/ssd/csrc/ssd_bwd.cu``) timed at
   hymba's and mamba2's training shapes (B = 2, S = 4,096, chunks of 256;
   N = 16, 50 heads and N = 128, 64 heads; P = 64; bf16), alone from the
   profiler, through its wrapper, beside the plain version, the forward
   kernel and the bound (``[kernel_time] kernel=ssd_intra_chunk_bwd``),
   with the card its own (``[trace]`` joined before it), and against the
   plain version on those seeded inputs in bf16 and f32;
   ``hymba-1.5b`` at full width and depth trained ``SSD_TRAIN_STEPS``
   steps of one 4,096-token sequence (two do not fit the card at remat
   "none"): 32 SSD forward
   (``mma_bf16``) and 32 backward (``cuda_core_bf16_in``) launches a
   step, the plain versions never, with the counts set to 0 just before;
   one step split (the SSD kernels' ms apart), the backward kernel
   against its plain version on layer 0's captured inputs and cotangents
   (bf16 and f32) and on ``SSD_EDGE_CASES`` run under grad through
   ``ssd_scan_kernel`` (one launch each), each gradient within
   ``SSD_BWD_RTOL`` x its max, two calls bit-equal; the first two layers
   in f32 against the plain path; ``mamba2-1.3b`` at full width and depth
   ``MAMBA_TRAIN_STEPS`` steps under remat "block" (two forward launches
   a layer a step);
7f. dist (``[dist]``, a child process, ``--dist``): four
   ``torch.distributed`` ranks on the machine's cards (``launch.mesh``:
   NCCL when each rank has a card, gloo when they share one, every payload
   then staged through host memory; the backend and the staging are
   printed). ``part=executors``: ``apply_schedule`` on
   ``dp_broadcast_schedule(4)`` and ``apply_alltoall_schedule`` on
   ``alltoall_schedule(4)`` (DPM, MU) and the ring schedules, on EP's own
   bf16 chunk (moonshot, B = 4, S = 2,000: 16 experts x capacity 240 x
   2,048), bit-equal to the expected permutation, timed beside the
   group's broadcast / ``all_to_all_single``; ``part=compress``:
   ``compressed_psum`` of a stablelm-embedding-sized f32 gradient on each
   rank, identical on the four and within 0.05 of the exact all-reduce
   relative to its max; ``part=ep``: moonshot at full width (3 of its 48
   layers, each rank drawing the layers one at a time and keeping its 16
   of 64 experts), one f32 MoE layer (4 x 2,000 x 2,048, capacity factor
   64 / 6: nothing drops) through ``moe_apply_ep`` against
   ``moe_apply_dense`` (within 2e-5 x max |y|, routed ids equal save near
   ties), then bf16 prefills through ``models.model.prefill`` with
   ``moe_impl="ep"`` under ``shardctx`` against the dense prefill of the
   whole cut model on rank 0, at the config's capacity factor 1.25 and at
   64 / 6 (nothing drops): the logit ratio, a control's ratio (the dense
   prefill with its router on EP's 2,000-token blocks), each path's
   dropped pairs and the tokens routed otherwise in each layer printed;
   layer 0, whose input is the same in both paths, may route otherwise
   only at near ties, and with nothing dropped the EP logits must equal
   the control's bit for bit; 3 flash launches a rank a prefill;
   ``part=pipeline``: stablelm-1.6b's 24 layers in 4 stages of 6
   through ``pipeline_apply`` (4 microbatches of one 4,096-token sequence,
   f32 masters, bf16 compute, a loss on the output), the forward equal to
   the 24 layers applied microbatch by microbatch on rank 0, every stage
   leaf's gradient within 1e-5 of its max of that sequential autograd's,
   96 forward and 96 backward flash launches (``wgmma_bf16``) with the
   counts set to 0 just before; ``part=zero1``: ``repro_torch.train.train``
   on each rank under a (4,) ``data`` mesh in ``shardctx`` (ZeRO-1:
   ``train.optim.DataParallel``), stablelm-1.6b at full width cut to 4 of
   its 24 layers, one 4,096-token sequence a rank, 3 steps of the training
   CLI's recipe, checkpoints at steps 2 and 3 (the blocks gathered, rank 0
   writing whole leaves): per rank the state bytes against the whole and
   against what its ``zero1_shardings`` blocks imply (asserted equal), the
   peak memory and the step ms; against the one-process run of the same
   steps (run alone on the card before the ranks, results on the host,
   ``accum=4``: each microbatch one rank's rows) within the rule of
   ``tests/test_torch_train.py`` (every step's loss and grad norm within
   1e-5, every parameter within 2 lr and at most 1e-3 of them beyond 1e-6,
   after step 1 each rank's blocks against its blocks of the one-process
   parameters, at the end the gathered checkpoint), the global batch in
   one pass (``accum=1``, other bf16 roundings) printed beside it; 48
   forward and 48 backward flash launches (``wgmma_bf16``) with the counts
   set to 0 just before; ``part=elastic``: the step-2 checkpoint restored
   onto a (2, 2) ``("data", "model")`` mesh under ``tree_shardings``, each
   rank's every block equal to its ``np.split`` block of the memory-mapped
   file, then restored in one process by ``train`` and trained to step 3,
   within the rule of the four ranks' step 3 (16 + 16 flash launches);
   ``part=tp``: ``train`` on each rank under the (2, 2) ``("data",
   "model")`` mesh (tensor parallelism: 16 of stablelm's 32 heads a rank,
   ZeRO-1 over ``data`` on each rank's ``model`` blocks), that 4-layer
   stablelm, one 4,096-token sequence a data rank: per rank the state
   bytes and the forward's parameter bytes against what its blocks imply
   (asserted equal), peak memory, step ms, flash launches; 2 bf16 steps
   against the one-process twin (``accum=2``: each microbatch one data
   rank's row) under a rule derived from where the roundings differ (the
   row-parallel partial products rounded to bf16 by each rank's GEMM,
   summed in f32 over ``model`` and rounded once): step 1's loss within
   6 standard deviations (``rounding_sigma``: the roundings' first-order
   effect, measured by gradient hooks in the twin) plus 1e-5, and step
   1's f32 gradient (averaged over the data ranks), on every rank's block
   of every leaf, within 1.7 times the bf16 twin's distance from the f32
   twin's (both twins start from the same masters: the tensor-parallel
   step moves some of the roundings that the bf16 step adds to the f32
   one and rounds its own gradient, so rounding stays within sqrt(2) of
   that distance and a wrong gradient does not; ``DIST_TP_GRAD_RATIO``),
   later losses, grad norms and parameters printed; then two f32 steps:
   step 1 within 1e-5 of the f32 twin's loss and grad norm, step 2 of the
   one process restarted from the masters the ranks started it from,
   parameters within 2 lr with at most 1e-3 beyond 1e-6; 32 + 32
   ``wgmma_bf16`` and 32 + 32 ``cuda_core_f32`` launches with the counts
   set to 0 just before; ``part=moe_dp``:
   moonshot at full width cut to 1 layer (32 of 64 experts a rank,
   2,048 tokens a data rank, the capacity and slots of the global 4,096)
   for 1 f32 step against the global batch in one process: its loss and
   grad norm within 1e-5, the parameters under the f32 rule, the dropped
   pairs over the data ranks equal to the one process's, 4 + 4
   ``cuda_core_f32`` launches at D = 128;
   then serving on a mesh (``--serve-tp``, a child of its own):
   ``[dist] part=stream_bf16``: the wrappers with the stream options on
   f32 inputs at hymba's shapes launch the bf16 kernels (``wgmma_bf16``,
   ``mma_bf16``) and agree with the plain versions with the same options
   within the bf16 kernels' tolerances; ``[dist] part=serve_tp``: four
   ranks on a (2, 2) ``("data", "model")`` mesh, each with its
   ``tree_shardings`` blocks of the parameters, run
   ``models.model.prefill`` and 16 teacher-forced ``decode_step``s under
   ``shardctx.set_ctx(mesh, blocks=True)`` at full width (moonshot cut to
   2 layers, deepseek to 1 + 1, hymba to 4; B = 4, a 2,000-token prompt),
   in bf16 and in f32, against one-process twins run alone on the card
   before them: the logits (whole on every rank) and every cache block
   (shaped as its ``CACHE_RULES`` block) within ``SERVE_TP_F32_RTOL`` of
   the twin's largest in f32, within ``SERVE_TP_BF16_RATIO`` times the
   bf16 twin's distance from the f32 twin's in bf16; the flash and SSD
   launches a rank with the counts set to 0 just before the prefill
   (moonshot 2, deepseek 2 at D = 192, hymba 4 + 4 SSD, bf16 kernels in
   bf16, f32 kernels in f32);
   then ``[dryrun]``: a child for each fake world (``--dryrun-world=``
   ``pod``, 256 ranks, and ``multipod``, 512, started before training
   and working on the host beside it and the ranks) runs
   ``launch.dryrun.run_cell`` on four cells and prints flops, bytes,
   collectives by axis and kind, the roofline terms and ``trace_s``;
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
10. 3-D and chiplet fabrics (``[topo3d]``): ``benchmarks/results/
    topo3d_sweep.json``'s latency grid (mesh3d and torus3d 4x4x4, the
    2x2-die chiplet package; uniform and hotspot traffic, MU/MP/NMP/DPM in
    one batched launch per fabric) reproduced exactly; then full size,
    ``torus3d`` 8x8x8 (512 six-port routers) and a 16-die package of 4x4
    routers, MU/MP/NMP/DPM at rates 0.01 and 0.03: every DPM plan of
    ``bulk_plan`` (batched on the card where ``batch_support`` admits the
    fabric) equal to host ``plan()``, the lowest rate drained, the cluster
    route alone (8 ranks) with the counts set to 0 just before, both routes
    equal to the plain cycle and timed in turns beside their bound; then
    ``WormholeSim`` against ``xsimulate`` on mesh3d 4x4x4 and the 2x2-die
    package (the same delivery sets and per-link flits);
11. ML-workload traces (``[trace]``): ``benchmarks/results/
    trace_replay.json`` reproduced (its six traces on the 4x4 mesh under
    MU/MP/NMP/DPM through ``cross_validate``: host simulator and xsim on
    the card, delivery sets equal; the ring all-to-all; the fault
    ladder), ``topo3d_sweep.json``'s four EP-trace rows (torus3d 4x4x4
    and the 2x2-die package), then an EP all-to-all over 256 ranks on the
    16x16 mesh (``dist.alltoall_schedule``: 255 rounds, 510 phases, 130,560
    events) replayed under MU, DPM and DPM with two links failing at the
    first combine round, each one cycle-kernel launch of B = 510 on the
    cluster route alone; both routes equal to the plain cycle and timed
    beside their bound; every 32nd phase cross-validated on the host;
12. the calibration loop (``[calibration]``): ``benchmarks/results/
    telemetry_calibration.json`` reproduced on its 16x16 mesh (nine
    iterations, the three-rate sweep, the energy constants), the loop's
    wall time split into host signature planning, compile and device time;
13. the ``kernels`` JSON line (eight kernels: the six TPU kernels' ports,
    the flash backward and the SSD backward, which replace the
    reference's jnp backwards; flash attention's launches also by head
    dim, the flash backward's by route, the SSD backward's by variant),
    then the result line.

Phases 4, 5, 7 and 8 read their kernels' profiler times from a child
process of this script (``python3 chip_smoke.py --noc-cycle-alone``,
``--dpm-cost-alone``, ``--serve-kernel-alone`` and
``--segmin-kernel-alone``), phase 7 the split of one prefill's time by
kernel family (``--prefill-profile``), and phases 7b, 7c, 7d, 7e, 7e',
7e'' and 7f run whole in a child each (``--serve-moe``, ``--serve-mla``,
``--serve-frames``, ``--train``, ``--train-mla``, ``--train-ssd``,
``--dist``). Each of these children is
started one ahead of its phase (``WARM_NEXT``): it makes its CUDA context,
imports the port and waits for its go file while the phase before it
runs. Phases 10-12 run in children of their own (``--phases=``) beside
card phases that leave the card room: 11 beside 7d-7e', 10 and 12 beside
7g; their times on the card are not taken alone, nor those of 7d-7e'
and 7g. Every ``[phase]`` line
ends with ``at_s``, the seconds since the script started.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
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
# the MoE serving phase (a child process): moonshot-v1-16b-a3b at full width
# and depth, the same requests; flash inputs captured from its first and
# last layers; the kernel path against the plain path over its first two
# layers in f32, routing flips excused only under this top-k gap
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_CAPTURE_LAYERS = (0, 47)
MOE_PLAIN_LAYERS = 2
MOE_NEAR_TIE = 1e-5
# the MLA serving phase (a child process): deepseek-v2-236b at full width,
# its dense first layer and 7 of its 59 MoE layers: 54.4 GiB of bf16
# weights, and during init the f32 draws of one 14.8 GiB MoE layer beside
# them, fit the 80 GB card (all 60 layers are 439 GiB); flash inputs
# captured from its first and last layers; its first two layers (dense,
# then MoE) in f32 against the plain path
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYOUT = (("mla_dense", 1), ("mla_moe", 7))
# the frame models (a child process): musicgen-medium at full width and
# depth; qwen2-vl-72b at full width, 32 of its 80 layers (54.6 GiB bf16 of
# its 133 GiB), also run with the int8 KV cache against the bf16 one for
# INT8_DECODE_STEPS teacher-forced steps
FRAME_ARCHS = (("musicgen-medium", None), ("qwen2-vl-72b", 32))
FRAME_PLAIN_LAYERS = 2  # each frame model's first layers in f32, kernel
#                         path against plain path
INT8_DECODE_STEPS = 8
# faults planted in the int8 path to show what the checks catch
INT8_FAULTS = ("decode_scale_zeroed", "prompt_v_scale_zeroed")
SERVE_CHILD_TIMEOUT_S = 600
# the child that each child's start warms (``warm``): started at once, it
# makes its CUDA context, imports the port and waits for its go file, so
# that its start-up overlaps the phase before it; None: the script's start.
# Nothing is warmed beside the --dist child, whose ranks fill the card.
WARM_NEXT = {
    None: "--noc-cycle-alone",
    "--noc-cycle-alone": "--dpm-cost-alone",
    "--dpm-cost-alone": "--serve-kernel-alone",
    "--serve-kernel-alone": "--prefill-profile",
    "--prefill-profile": "--serve-moe",
    "--serve-moe": "--serve-mla",
    "--serve-mla": "--serve-frames",
    "--serve-frames": "--train",
    "--train": "--train-mla",
    "--train-mla": "--train-ssd",
    "--train-ssd": "--dist",
    "--serve-tp": "--segmin-kernel-alone",
}
_WARM: dict = {}  # flag -> (its waiting child, its go file)
_WARMED: set = set()
# phases 10-12 run in children beside card phases that leave room on the
# card (``start_phases``): [trace] beside 7d-7e', [topo3d] and
# [calibration] beside 7g; the parent waits at most this long for one
BACKGROUND_TIMEOUT_S = 600
PROFILE_TRIES = 3  # traces of one call before "no device time" fails
# a torch.profiler trace started around a call often lacks the call's
# first kernel, and a spin kernel launched before the call does not help
# (tools/profiler_drops.py): a traced call follows one call in the
# profiler's warm-up step, whose kernels the trace leaves out
ATTN_ATOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}
# the largest |got - want| / |want| over the output rows (each a D-vector)
# on moonshot's captured inputs. Attention there is near-uniform, so late
# rows are a few hundredths and the absolute tolerance alone would pass a
# dropped key tile. tests/test_torch_flash_attention.py holds a CPU
# emulation of the bf16 kernel's arithmetic at S = 2,000, D = 128 within
# half the bf16 bound (about 0.004) and a zeroed 64-key tile over ten
# times it (about 0.25)
ATTN_ROW_RTOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-3}
SSD_ATOL = {"torch.bfloat16": 1e-1, "torch.float32": 5e-4}
# edge cases of the kernels' tiles on seeded random inputs:
# attention (label, B, Sq, Sk, H, KH, D, Dv, window, q_offset), v of width
# Dv (MLA's pair: q/k 192, v 128),
# SSD (label, B, S, H, G, N, P, chunk)
ATTN_EDGE_CASES = (
    ("window_dead_first_tile", 2, 300, 300, 4, 2, 64, 64, 70, 0),
    ("sk_below_one_tile", 2, 40, 40, 4, 2, 64, 64, None, 0),
    ("d16", 2, 333, 333, 4, 2, 16, 16, None, 0),
    ("d32", 2, 333, 333, 4, 1, 32, 32, 100, 0),
    ("d128", 2, 333, 333, 4, 2, 128, 128, 100, 0),
    ("d192_gqa_window", 2, 333, 333, 4, 2, 192, 192, 100, 0),
    ("d192_sk_below_one_tile", 2, 40, 40, 8, 8, 192, 192, None, 0),
    ("mla_gqa_window", 2, 333, 333, 4, 2, 192, 128, 100, 0),
    ("mla_sk_below_one_tile", 2, 40, 40, 8, 8, 192, 128, None, 0),
    ("mla_ragged", 2, 1377, 1377, 8, 8, 192, 128, None, 0),
    ("mla_q_offset_window", 2, 64, 1377, 8, 4, 192, 128, 1024, 1313),
)
SSD_EDGE_CASES = (
    ("groups2_n16", 2, 777, 8, 2, 16, 64, 256),
    ("mamba2_smoke_n32_p32", 2, 100, 8, 1, 32, 32, 32),
    ("short_chunk_n16_p32", 2, 100, 4, 1, 16, 32, 100),
)
# the training phase (a child process): stablelm-1.6b at full width and
# depth, TRAIN_BATCH sequences of TRAIN_SEQ tokens (SHAPES["train_4k"]'s
# length; its global batch of 256 cut to 2 on one card), TRAIN_STEPS steps
# of the training CLI's recipe (remat "none", lr 3e-3, seed 0)
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 2, 4096, 3e-3
TRAIN_PLAIN_LAYERS = 2  # its first layers in f32, kernel path against plain
# The backward kernel against its plain version. bf16: each gradient row's
# error norm within BWD_ROW_RTOL of the row's norm, the norm floored at
# BWD_ROW_FLOOR x the mean row norm. The kernel rounds P and dS to bf16 for
# its second products and its outputs to bf16, each a relative 2^-9
# (0.002) an element; summed with random signs over a row the three give
# about 0.005 (an H100 measured 0.0037-0.0065 on seeded inputs, D = 16 to
# 128, and up to 0.0105 on the small, cancelling dq of stablelm's last
# layer), so 2e-2 leaves a margin of 2 or more; a dropped 64-key tile
# gives about 1 (tests/test_torch_flash_backward.py emulates both on the
# CPU). The floor: a row whose gradient cancels to
# (nearly) 0 (the first causal row's dq is exactly 0: p = 1 on its one
# key, where dout . v equals delta) carries the rounding of its terms, not
# of its sum. f32: within BWD_F32_RTOL x max |.| of each output.
BWD_ROW_RTOL = 2e-2
BWD_ROW_FLOOR = 0.1
BWD_F32_RTOL = 1e-5
# edge cases of the backward's tiles on seeded random inputs
# (label, B, Sq, Sk, H, KH, D, Dv, window, q_offset); "q_offset_window" is
# a chunk of 40 queries at position 60 of 100 keys under a window (the CPU
# tests' q_offset case); the "mla_" cases are MLA's pair (q/k 192, v 128),
# whose dK/dV pass streams query tiles of 32 rows, "d192" (192, 192)'s of 16
BWD_EDGE_CASES = (
    ("gqa3_window", 2, 333, 333, 6, 2, 64, 64, 100, 0),
    ("gqa8", 1, 300, 300, 8, 1, 64, 64, None, 0),
    ("sk_below_one_tile", 2, 40, 40, 4, 2, 64, 64, None, 0),
    ("d16", 2, 200, 200, 4, 2, 16, 16, None, 0),
    ("d32_window", 2, 333, 333, 4, 1, 32, 32, 70, 0),
    ("d128", 2, 333, 333, 4, 2, 128, 128, 100, 0),
    ("q_offset_window", 1, 40, 100, 4, 2, 32, 32, 50, 60),
    ("d192_gqa_window", 2, 333, 333, 4, 2, 192, 192, 100, 0),
    ("mla_gqa_window", 2, 333, 333, 4, 2, 192, 128, 100, 0),
    ("mla_sk_below_one_tile", 2, 40, 40, 8, 8, 192, 128, None, 0),
    ("mla_ragged", 1, 1377, 1377, 4, 4, 192, 128, None, 0),
    ("mla_q_offset_window", 1, 64, 1377, 4, 2, 192, 128, 1024, 1313),
)
# the MLA training phase (a child process, --train-mla): deepseek-v2-236b
# at full width cut to its dense first layer (1.39 B parameters; one of its
# MoE layers is 3.8 B, whose f32 master, Adam and gradient state do not
# fit beside it), TRAIN_BATCH x TRAIN_SEQ tokens, MLA_TRAIN_STEPS steps of
# train_run_config() at MLA_TRAIN_LR, the peak learning rate of the
# DeepSeek-V2 technical report (2.4e-4): at the CLI's 3e-3 Adam's first
# steps, about lr x sign(g) a weight, overshoot at d = 5,120 and a
# 102,400-word head (an H100 ran 12.40, 1.59, 12.82, ..., 12.57), on the
# plain attention path as on the kernels (tools/mla_lr_witness.py); the
# plain backward on layer 0's captured inputs in groups of
# MLA_BWD_HEAD_GROUP KV heads (its S x S tensors at 128 heads and S =
# 4,096 are 8.6 GB each); the kernel path against the plain path over the
# layer in f32 at MLA_PLAIN_SEQ tokens
MLA_TRAIN_LAYOUT = (("mla_dense", 1),)
MLA_TRAIN_STEPS, MLA_TRAIN_LR = 6, 2.4e-4
MLA_BWD_HEAD_GROUP = 16
MLA_PLAIN_SEQ = 1024
# the SSD training phase (a child process, --train-ssd): hymba-1.5b at full
# width and depth, SSD_TRAIN_BATCH x TRAIN_SEQ tokens (one sequence: at
# remat "none" two ran out of an H100's 80 GB, 74.66 GiB allocated when
# the logits asked for 1 GiB more), SSD_TRAIN_STEPS steps of
# train_run_config() (remat "none"), one step split and its first
# TRAIN_PLAIN_LAYERS layers in f32 against the plain path; mamba2-1.3b at
# full width and depth, MAMBA_TRAIN_STEPS steps under remat "block"
# (RunConfig's default). The SSD backward kernel against its plain version:
# each gradient within SSD_BWD_RTOL x its largest |.| in both dtypes (the
# kernel computes in f32 from the same inputs, so only the order of its f32
# sums differs; the CPU tests hold the closed form to autograd within 1e-5,
# and dA sums every step of a head), two calls bit-equal. Timed, and held
# against the plain version on seeded inputs, at SSD_BWD_SHAPES (label, B,
# S, H, G, N, P, chunk): mamba2's is the only (128, 64) instance on the
# training path; SSD_BWD_SHORT_CASES
# (label, B, S, H, G, N, P, chunk) call the kernels directly with S below
# one chunk, which ssd_scan_kernel never passes them
SSD_TRAIN_ARCH, SSD_TRAIN_STEPS, SSD_TRAIN_BATCH = "hymba-1.5b", 6, 1
MAMBA_TRAIN_ARCH, MAMBA_TRAIN_STEPS = "mamba2-1.3b", 3
SSD_BWD_RTOL = 1e-4
SSD_BWD_SHAPES = (("hymba", 2, 4096, 50, 1, 16, 64, 256),
                  ("mamba2", 2, 4096, 64, 1, 128, 64, 256))
SSD_BWD_SHORT_CASES = (("seq_under_chunk", 2, 40, 4, 1, 16, 64, 64),)
# the checkpoint round trip: smollm-135m at full width, a save at step
# CKPT_AT of CKPT_STEPS
CKPT_ARCH = "smollm-135m"
CKPT_STEPS, CKPT_AT, CKPT_BATCH, CKPT_SEQ = 6, 3, 4, 1024
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
# xsim's batch split: the card listed this many times (the main path's
# B = 16 splits into 4 launches of 4 instances)
XSIM_SPLIT_DEVICES = 4
# the dist phase (a child process that spawns DIST_RANKS torch.distributed
# ranks on the machine's cards; one card: the ranks share it over gloo, the
# payloads staged through host memory). Executors: EP's own chunk (moonshot
# at B = 4, S = 2,000, 4 EP ranks: 16 experts x capacity 240 x d 2,048
# bf16); compress: a gradient the size of stablelm-1.6b's embedding
# (100,352 x 2,048 f32); EP: moonshot-v1-16b-a3b at full width,
# DIST_EP_LAYERS of its 48 layers (four ranks' attention, shared experts,
# embedding and head beside the dense comparison on the card); pipeline:
# stablelm-1.6b's 24 layers, 4 stages of 6, 4 microbatches of one
# DIST_PIPE_SEQ-token sequence
DIST_RANKS = 4
DIST_ALGOS = ("DPM", "MU", "ring")
DIST_TIMEOUT_S = 600
DIST_REPS = 3
DIST_COMPRESS_SHAPE = (100352, 2048)
DIST_COMPRESS_BOUND = 0.05  # tests/dist_checks.py's bound on the relative error
# part=ep's moonshot depth (12, then 6, now 3 layers): cut to keep the
# script within its time limit on a slow host
DIST_EP_LAYERS = 3
DIST_EP_B, DIST_EP_S = 4, 2000
DIST_EP_RTOL = 2e-5  # the f32 layer against the dense path, x max |y|
DIST_PIPE_M, DIST_PIPE_SEQ = 4, 4096
DIST_PIPE_GRAD_RTOL = 1e-5  # each stage leaf's gradient, x its max
# ZeRO-1 (part=zero1): stablelm-1.6b at full width cut to DIST_ZERO1_LAYERS
# of its 24 layers (0.61 B parameters; four ranks' f32 state blocks,
# gradients and bf16 copies of all 24 layers would not share the card),
# one TRAIN_SEQ-token sequence a rank, DIST_ZERO1_STEPS steps of the
# training CLI's recipe, a checkpoint at DIST_ZERO1_CKPT_AT and at the end;
# part=elastic restores that checkpoint on a (2, 2) ("data", "model")
# mesh and in one process
DIST_ZERO1_LAYERS = 4
DIST_ZERO1_STEPS, DIST_ZERO1_CKPT_AT = 3, 2
# tensor parallelism (part=tp): that 4-layer stablelm on a (2, 2) ("data",
# "model") mesh (16 of its 32 heads a rank), one TRAIN_SEQ-token sequence
# a data rank, DIST_TP_STEPS steps in bf16 and DIST_TP_F32_STEPS in f32;
# MoE over data ranks (part=moe_dp): moonshot at full width cut to
# DIST_MOE_DP_LAYERS layer (four ranks' f32 state, gradients and
# activations share the card), DIST_MOE_DP_SEQ tokens a data rank,
# DIST_MOE_DP_STEPS f32 steps (2, now 1: cut for the time limit; the f32
# part=tp run still checks a step taken from the ranks' masters). The
# bf16 rule's step-1 loss bound is
# DIST_TP_SIGMAS standard deviations of the extra roundings' first-order
# effect plus DIST_TP_F32_SLACK for the f32 sums' order. Its step-1
# gradient bound: each leaf block's distance to the one-process bf16
# gradient at most DIST_TP_GRAD_RATIO times that gradient's distance to
# the one-process f32 gradient. Each bf16 gradient is g_f32 + U + R: U the
# effect of the step's roundings before the last, R the last rounding of
# the gradient's own GEMM. Tensor parallelism moves a subset of the
# roundings behind U (at most sqrt(2) |U| apart) and rounds its own R, so
# |g - g_bf16| <= sqrt(2) |g_bf16 - g_f32| to first order; times
# 1 + 4 x 0.044, four standard deviations of the ratio of two norms over
# the smallest block's 512 elements
DIST_TP_MESH = (2, 2)
DIST_TP_STEPS, DIST_TP_F32_STEPS = 2, 2
DIST_MOE_DP_LAYERS, DIST_MOE_DP_SEQ, DIST_MOE_DP_STEPS = 1, 2048, 1
DIST_TP_SIGMAS, DIST_TP_F32_SLACK, DIST_TP_GRAD_RATIO = 6.0, 1e-5, 1.7
DIST_CHILD_TIMEOUT_S = 900
# serving on a mesh ([dist] part=serve_tp): four ranks on a (2, 2) ("data",
# "model") mesh, each holding its tree_shardings blocks of the parameters
# and its CACHE_RULES blocks of the caches, at full width: moonshot cut to
# 2 of its 48 layers, deepseek to 1 + 1 and hymba to 4 of 32 (both window
# kinds); B = 4 (2 a data rank), a SERVE_TP_PROMPT-token prompt and
# SERVE_TP_STEPS teacher-forced decode steps, in bf16 and in f32, against
# the one-process twins run alone on the card before the ranks. f32: the
# logits (the real vocabulary) within SERVE_TP_F32_RTOL of the twin's
# largest, every cache block within it of its leaf's largest. bf16: each
# logit and cache leaf is x_f32 + U + R (U the roundings before the last,
# R the last one's); the ranks round their row-parallel partials and sum
# them in f32, which moves a subset of the roundings behind U (at most
# sqrt(2) |U| apart to first order) and rounds its own R, so the ranks'
# bf16 values lie within sqrt(2) |x_bf16 - x_f32| of the bf16 twin's; the
# bound is SERVE_TP_BF16_RATIO = 2 times the bf16 twin's largest distance
# from the f32 twin's, over all 17 logit rows (prefill and decode) and
# over each leaf's block (the margin for MoE routing that the roundings
# flip on either side)
SERVE_TP_MESH = (2, 2)
SERVE_TP_B, SERVE_TP_PROMPT, SERVE_TP_STEPS = 4, 2000, 16
SERVE_TP_F32_RTOL, SERVE_TP_BF16_RATIO = 1e-5, 2.0
SERVE_TP_TIMEOUT_S, SERVE_TP_CHILD_TIMEOUT_S = 600, 750
# the dry run on the card's host ([dryrun]): rank 0 of each production
# mesh under a fake process group, a child a world
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k"),
                ("moonshot-v1-16b-a3b", "prefill_32k"),
                ("deepseek-v2-236b", "decode_32k"),
                ("hymba-1.5b", "long_500k"))
DRYRUN_CHILD_TIMEOUT_S = 300


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    """Print a ``[phase] key=value ...`` line; ``at_s`` closes it: the
    seconds since the top-level script started (its children's lines too)."""
    t0 = os.environ.get("CHIP_SMOKE_T0")
    if t0 is not None:
        kw["at_s"] = f"{time.time() - float(t0):.1f}"
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
    """The inputs ``xsimulate`` handed the engine, rebuilt from its results
    (any registered fabric: ``L`` is routers times the topology's ports)."""
    from repro_torch.noc.xsim.compile import geometry_tables, traffic_from_numpy

    tr = traffic_from_numpy(res.traffic, device)
    st = res.traffic
    g = cfg.make_topology()
    geom = geometry_tables(g.kind, g.n, g.m or g.rows, g.params,
                           cfg.vcs_per_class)
    kw = dict(
        T=res.cycles, F=max(cfg.flits_per_packet, int(st["flits"].max())),
        V=cfg.vcs_per_class, BD=cfg.buffer_depth, L=g.num_nodes * g.ports,
        NN=g.num_nodes, ND=int(st["dslot"].max()) + 1,
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
        routers_per_rank=c["NR"], ports=c["D"], children_per_rank=c["CC"],
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


def start_build() -> tuple:
    """Start building every kernel library at once, one ``nvcc`` per
    source: ``(libraries, futures by name)`` for ``finish_build``."""
    from repro_torch.kernels.dpm_cost import KERNEL as DPM_KERNEL
    from repro_torch.kernels.flash_attention import BWD_KERNEL, BWD_WGMMA_LIB
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.kernels.noc_step import KERNEL as SEGMIN_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.kernels.ssd import KERNEL_BWD as SSD_BWD

    kernels = [("noc_cycle", KERNEL), ("dpm_cost", DPM_KERNEL),
               ("flash_attention", FLASH_KERNEL),
               ("flash_attention_bwd", BWD_KERNEL),
               ("flash_attention_bwd_wgmma", BWD_WGMMA_LIB),
               ("ssd", SSD_KERNEL), ("ssd_bwd", SSD_BWD),
               ("noc_step", SEGMIN_KERNEL)]
    pool = ThreadPoolExecutor(len(kernels))
    futures = {name: pool.submit(k.build) for name, k in kernels}
    pool.shutdown(wait=False)
    return kernels, futures


def finish_build(build: tuple) -> None:
    """Wait for ``start_build``'s libraries; print each one's nvcc time and
    ptxas report and hold the shared-memory mirrors."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL, BWD_WGMMA_LIB
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.kernels.ssd import KERNEL_BWD as SSD_BWD

    kernels, futures = build
    for f in futures.values():
        f.result()
    wall = max(k.build_seconds for _, k in kernels)
    for name, k in kernels:
        say("build", library=name, seconds=f"{wall:.2f}",
            nvcc_seconds=f"{k.build_seconds:.2f}")
        for kernel, report in ptxas_report(k.build_log):
            print(f"[build] ptxas: library={name} kernel={kernel} {report}",
                  flush=True)
    check_smem_mirrors(FLASH_KERNEL.build(), SSD_KERNEL.build(),
                       BWD_KERNEL.build(), BWD_WGMMA_LIB.build(),
                       SSD_BWD.build())


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


def check_smem_mirrors(flash_lib, ssd_lib, bwd_lib, bwd_wgmma_lib,
                       ssd_bwd_lib) -> None:
    """Print each attention (forward and backward, both backward routes)
    and SSD (forward and backward) kernel instance's dynamic shared memory
    as its library computes it, and fail if the Python mirror that the CPU
    tests hold to the 227 KB limit says otherwise."""
    import torch

    from repro_torch.kernels.flash_attention.flash_attention import (
        HEAD_DIM_PAIRS, bwd_smem_bytes, smem_bytes as flash_smem,
    )
    from repro_torch.kernels.ssd.ssd import (
        TC_MAX_CHUNK, TC_SHAPES, bwd_smem_bytes as ssd_bwd_smem,
        smem_bytes as ssd_smem,
    )

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = int(dtype == torch.bfloat16)
        name = "flash_fwd_tc_kernel" if bf16 else "flash_fwd_kernel<f32>"
        for D, Dv in HEAD_DIM_PAIRS:
            got = flash_lib.flash_attention_smem_bytes(bf16, D, Dv)
            say("build", smem=f"{name}<{D},{Dv}>", dynamic_smem=got)
            if got != flash_smem(dtype, D, Dv):
                fail(f"flash smem mirror: {got} != "
                     f"{flash_smem(dtype, D, Dv)}")
            for part in ("dkdv", "dq"):
                dkdv = int(part == "dkdv")
                routes = [("mma_sync", bwd_lib.flash_attention_bwd_smem_bytes(
                    bf16, D, Dv, dkdv), "tc_kernel" if bf16 else "kernel<f32>")]
                if bf16:
                    routes.append((
                        "wgmma",
                        bwd_wgmma_lib.flash_attention_bwd_wgmma_smem_bytes(
                            D, Dv, dkdv), "wgmma_kernel"))
                for route, got, kind in routes:
                    want = bwd_smem_bytes(dtype, D, Dv, part, route=route)
                    say("build", smem=f"flash_bwd_{part}_{kind}<{D},{Dv}>",
                        route=route, dynamic_smem=got)
                    if got != want:
                        fail(f"flash backward smem mirror ({route}): {got} "
                             f"!= {want}")
        name = "ssd_intra_tc_kernel" if bf16 else "ssd_intra_kernel<f32>"
        for N, P in TC_SHAPES:
            args = (TC_MAX_CHUNK, N, P)
            got = ssd_lib.ssd_intra_chunk_smem_bytes(bf16, *args)
            say("build", smem=f"{name}<{N},{P}>", chunk=TC_MAX_CHUNK,
                dynamic_smem=got)
            if got != ssd_smem(dtype, *args):
                fail(f"SSD smem mirror: {got} != {ssd_smem(dtype, *args)}")
    for N, P in TC_SHAPES:  # both input types: one shared-memory layout
        got = ssd_bwd_lib.ssd_intra_chunk_bwd_smem_bytes(N, P, TC_MAX_CHUNK)
        say("build", smem=f"ssd_bwd_tile_kernel<{N},{P}>", chunk=TC_MAX_CHUNK,
            dynamic_smem=got)
        if got != ssd_bwd_smem(TC_MAX_CHUNK, N, P):
            fail(f"SSD backward smem mirror: {got} != "
                 f"{ssd_bwd_smem(TC_MAX_CHUNK, N, P)}")


def trace_kernels(fn) -> dict:
    """``{kernel name: (launches, device ms)}`` of the CUDA kernels in one
    ``torch.profiler`` trace of ``fn()``, taken in the step after a
    warm-up step of the same call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0 and e.device_type == DeviceType.CUDA:
            n, ms = out.get(e.key, (0, 0.0))
            out[e.key] = (n + e.count, ms + t / 1e3)
    return out


def profiled_ms(fn, match: str = "", kernels: int | None = None
                ) -> tuple[float | None, int, int]:
    """Device time (ms) and launch count of the CUDA kernels whose names
    contain ``match`` in one call of ``fn`` (``trace_kernels``), and the
    number of traces discarded before it: a trace without device time for
    them or, with ``kernels``, without that many launches. None when none
    of ``PROFILE_TRIES`` traces has them."""
    import torch

    fn()
    torch.cuda.synchronize()
    for tries in range(PROFILE_TRIES):
        seen = [v for k, v in trace_kernels(fn).items() if match in k]
        count = sum(n for n, _ in seen)
        if count and kernels in (None, count):
            return sum(ms for _, ms in seen), count, tries
    return None, 0, PROFILE_TRIES


def kernel_split_ms(fn, match: str) -> dict:
    """Device ms of one call of ``fn`` by CUDA kernel, for the kernels whose
    names contain ``match`` (``trace_kernels``; empty when the trace holds
    no device time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    return {re.search(rf"{match}\w*", k)[0]: ms
            for k, (_, ms) in trace_kernels(fn).items() if match in k}


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
    kernels_ms, n_kernels, _ = profiled_ms(
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

    def attn(q, k, v, *, causal, window=None, stream_bf16=False, device):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   stream_bf16=stream_bf16)

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
    q, k, v read once and the output (v's width Dv) written once over HBM
    bandwidth, and 2 D + 2 Dv operations per visible (query, key) pair (QK^T
    and PV, multiply and add; the causal and window masks counted exactly)
    over the bf16 tensor-core rate."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    pairs = int(attention_mask(Sq, Sk, causal=True, window=window,
                               q_offset=q_offset, device=q.device).sum())
    nbytes = (sum(t.numel() for t in (q, k, v)) + B * Sq * H * Dv) \
        * q.element_size()
    ops = (2 * D + 2 * Dv) * pairs * B * H
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


def check_attention(label, q, k, v, window, q_offset, dtype,
                    row_rtol: bool = False) -> dict:
    """The flash kernel against its plain version on the card; with
    ``row_rtol`` also at the per-row relative tolerance ``ATTN_ROW_RTOL``."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_ref,
    )
    from repro_torch.kernels.flash_attention.flash_attention import VARIANTS

    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got, k_ms = median_ms(lambda: flash_attention_cuda(q, k, v, **kw))
    want, p_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw))
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    atol = ATTN_ATOL[str(dtype)]
    rows = ((g - w).norm(dim=-1)
            / w.norm(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)).max()
    row_err, rtol = float(rows), ATTN_ROW_RTOL[str(dtype)]
    dead = dead_first_tile_rows(q.shape[1], k.shape[1], window, q_offset)
    say("kernel_vs_plain", kernel="flash_attention", case=label,
        dtype=str(dtype).removeprefix("torch."), variant=VARIANTS[dtype],
        shape=tuple(q.shape), kv=tuple(k.shape), dv=v.shape[-1],
        window=window, q_offset=q_offset, dead_first_tile_rows=dead,
        max_abs_err=err, atol=atol,
        plain_rms=f"{float(w.square().mean().sqrt()):.5f}",
        plain_median_abs=f"{float(w.abs().median()):.5f}",
        max_row_rel_err=f"{row_err:.3g}",
        row_rtol=rtol if row_rtol else "not asserted",
        finite=bool(got.isfinite().all()),
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
    if not err <= atol or not bool(got.isfinite().all()):
        fail(f"flash_attention != plain on {label} {dtype}: {err} > {atol}")
    if row_rtol and not row_err <= rtol:
        fail(f"flash_attention != plain on {label} {dtype}: a row's "
             f"relative error {row_err} > {rtol}")
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
    on values): hymba's global and window attention layers, moonshot's
    attention at D = 128, deepseek's MLA prefill (128 heads, q/k 192, v
    128), hymba's SSD layer and mamba2's. Run in a fresh
    process by ``phase_serve``: in a long run of this script the profiler
    stopped reporting device time for these launches after the earlier
    phases had profiled, though a fresh process reports it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    hy, mb, moon = ARCHS["hymba-1.5b"], ARCHS["mamba2-1.3b"], ARCHS[MOE_ARCH]
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
        # moonshot's layers: 16 heads of D = 128, no window
        qm, km, vm = (randn(B, S, moon.n_heads, moon.head_dim).to(dtype)
                      for _ in range(3))
        out[f"flash_attention/moonshot/{dt_name}"] = profiled_ms(
            lambda: flash_attention_cuda(qm, km, vm),
            f"flash_fwd{tc}_kernel")[0]
        del qm, km, vm
        # deepseek's MLA prefill: 128 heads, q/k 192, v 128
        ds = ARCHS[MLA_ARCH]
        D, Dv = attn_head_dims(ds)
        qd, kd, vd = (randn(B, S, ds.n_heads, d).to(dtype)
                      for d in (D, D, Dv))
        out[f"flash_attention/mla/{dt_name}"] = profiled_ms(
            lambda: flash_attention_cuda(qd, kd, vd),
            f"flash_fwd{tc}_kernel")[0]
        del qd, kd, vd
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
    params, _ = model_init(0, cfg, run, device="cuda")
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
    ``--prefill-profile``): profiler times taken in a fresh process. A
    time the child's traces lacked (None) is taken from a second child."""
    def run() -> dict:
        proc = start_child(flag)
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode != 0:
            fail(f"the child {flag} failed:\n{stderr[-2000:]}")
        return json.loads(stdout.strip().splitlines()[-1])

    def lacks(a) -> bool:
        return a is None or isinstance(a, dict) and any(map(lacks, a.values()))

    def fill(a, b):
        if isinstance(a, dict):
            return {k: fill(v, b.get(k) if isinstance(b, dict) else None)
                    for k, v in a.items()}
        return b if a is None else a

    out = run()
    return fill(out, run()) if lacks(out) else out


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
    Returns the kernels-line entries of the two kernels and the kernels'
    times alone (``--serve-kernel-alone``)."""
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
    params, _ = model_init(0, cfg, run, device="cuda")
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
    reset_flash_counts()
    SSD_KERNEL.reset()
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
    flash_dims = {pair_key(d): n
                  for d, n in FLASH_KERNEL.head_dim_launches.items() if n}
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
        params=n_params, params_dtype=run.activations_dtype,
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
    prompts = padded_prompts(reqs[:SERVE_MAX_BATCH])
    S = prompts.shape[1]
    toks = torch.from_numpy(prompts).cuda()
    for act in ("float32", "bfloat16"):
        r = RunConfig(activations_dtype=act)
        # each run on the tree model_init stores for it (f32: every leaf)
        p = (params if act == run.activations_dtype
             else model_init(0, cfg, r, device="cuda")[0])
        v0 = variant_counts()
        lk, _ = prefill(p, {"tokens": toks}, cfg, r)
        var = variant_delta(v0)
        expect_variants(f"{act} prefill", var, act, cfg.n_layers)
        with plain_path():
            f0 = FLASH_KERNEL.launches + SSD_KERNEL.launches
            lp, _ = prefill(p, {"tokens": toks}, cfg, r)
            if FLASH_KERNEL.launches + SSD_KERNEL.launches != f0:
                fail("the plain path launched a kernel")
        lk, lp = lk[..., :cfg.vocab], lp[..., :cfg.vocab]
        diff = float((lk - lp).abs().max())
        scale = float(lp.abs().max())
        finite = bool(lk.isfinite().all())
        del p
        say("serve_vs_plain", activations=act, batch=len(prompts), prompt_len=S,
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
    for lab, B_, Sq_, Sk_, H_, KH_, D_, Dv_, w, off in ATTN_EDGE_CASES:
        q, k, v = (torch.randn((B_, S_, h, d), generator=edge, device="cuda")
                   for S_, h, d in ((Sq_, H_, D_), (Sk_, KH_, D_),
                                    (Sk_, KH_, Dv_)))
        if lab == "window_dead_first_tile" and not dead_first_tile_rows(
                Sq_, Sk_, w, off):
            fail(f"{lab}: no row has a fully masked first key tile")
        for dtype in (torch.bfloat16, torch.float32):
            check_attention(lab, q, k, v, w, off, dtype)
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
                    "launches_by_head_dim_pair": flash_dims,
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
    return entries, alone_ms


# ---------------------------------------------------------------------------
# Mixture-of-Experts serving: moonshot-v1-16b-a3b at full width and depth
# ---------------------------------------------------------------------------
def moe_route_recorder(routes: list, module=None):
    """A ``route`` in ``module`` (default ``models.moe``) that also records
    each call's expert ids and the smallest gap between neighbours of the
    top k + 1 f32 probabilities (the margin a routing decision had)."""
    import torch

    import repro_torch.models.moe as moe

    moe = module or moe
    route_fn = moe.route

    def route(p, x, m, tp=None):
        ids, w, aux = route_fn(p, x, m, tp)
        probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
        top = probs.topk(m.top_k + 1, dim=-1).values
        routes.append((ids, (top[:, :-1] - top[:, 1:]).min(-1).values))
        return ids, w, aux

    return patched((moe, "route", route))


def moe_prefill_split(params, cfg, run, toks) -> None:
    """``[prefill_split]`` of one moonshot prefill on the device timeline:
    CUDA events recorded on the stream around each span (the attention
    sublayer and its flash kernel, the router, the routed experts' matrix
    products, the shared experts, the whole MoE FFN), summed over the 48
    layers. A span's time includes any idle gap inside it; dispatch and
    combine is the MoE FFN less router and experts; the rest is everything
    outside attention and MoE (norms, embedding, LM head, residuals)."""
    import torch

    import repro_torch.models.attention as attention
    import repro_torch.models.blocks as blocks
    import repro_torch.models.moe as moe
    from repro_torch.models import prefill

    spans: dict[str, list] = {}

    def span(name, fn):
        def wrapped(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans.setdefault(name, []).append((a, b))
            return out
        return wrapped

    names = (("attention", blocks, "gqa_apply"),
             ("flash_kernel", attention, "flash_attention"),
             ("moe", blocks, "_moe_ffn"), ("router", moe, "route"),
             ("experts", moe, "expert_ffn"), ("shared", moe, "shared_ffn"))
    with patched(*((mod, fn, span(name, getattr(mod, fn)))
                   for name, mod, fn in names)):
        prefill(params, {"tokens": toks}, cfg, run)  # warm-up
        spans.clear()
        t0 = time.monotonic()
        (_, _), total = timed(lambda: prefill(params, {"tokens": toks}, cfg,
                                              run))
        wall = (time.monotonic() - t0) * 1e3
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    counts = {k: len(v) for k, v in spans.items()}
    if any(counts[k] != cfg.n_layers for k in ms):
        fail(f"[prefill_split] spans per prefill {counts}, expected "
             f"{cfg.n_layers} each")
    split = {
        "attention_sublayer": ms["attention"],
        "flash_kernel": ms["flash_kernel"],
        "moe_router": ms["router"],
        "moe_dispatch_combine": ms["moe"] - ms["router"] - ms["experts"]
        - ms["shared"],
        "moe_expert_matmuls": ms["experts"],
        "moe_shared_experts": ms["shared"],
        "rest": total - ms["attention"] - ms["moe"],
    }
    say("prefill_split", arch=cfg.name, batch=toks.shape[0],
        prompt_len=toks.shape[1], activations=run.activations_dtype,
        device_timeline_ms=f"{total:.2f}", wall_ms=f"{wall:.2f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
        **{f"{k}_share": f"{v / total:.3f}" for k, v in split.items()
           if k != "flash_kernel"})


def padded_prompts(reqs) -> "np.ndarray":
    """The requests' prompts left-padded with token 0 to the longest, as
    ``BatchServer`` batches them."""
    import numpy as np

    S = max(len(r.prompt) for r in reqs)
    out = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        out[i, S - len(r.prompt):] = r.prompt
    return out


def attn_head_dims(cfg) -> tuple[int, int]:
    """The head-dim pair (q/k, v) of a model's prefill attention: MLA's
    (nope + rope, v_head_dim), else the GQA head dim twice."""
    if cfg.mla:
        return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                cfg.mla.v_head_dim)
    return cfg.head_dim, cfg.head_dim


def pair_key(pair) -> str:
    """A head-dim pair's key in the printed lines and the kernels line:
    ``"192x128"``; an int is a head dim with v as wide."""
    D, Dv = (pair, pair) if isinstance(pair, int) else pair
    return f"{D}x{Dv}"


def cut_depth(cfg, layout):
    """``cfg`` with the layout ``layout`` (full width, fewer layers)."""
    import dataclasses

    return dataclasses.replace(cfg, n_layers=sum(c for _, c in layout),
                               layout=tuple(layout))


def reset_flash_counts() -> None:
    """Set every flash-attention launch count to 0."""
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL

    FLASH_KERNEL.launches = 0
    for counts in ("variant_launches", "head_dim_launches"):
        setattr(FLASH_KERNEL, counts,
                dict.fromkeys(getattr(FLASH_KERNEL, counts), 0))


def counted_prefills(prefills: list):
    """Patch ``serve.engine.prefill`` so that the flash counts are set to 0
    just before each prefill and read just after: each prefill appends
    (launches, launches by variant, launches by head-dim pair) to
    ``prefills``."""
    import repro_torch.serve.engine as engine
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL

    prefill_fn = engine.prefill

    def counted(*args, **kw):
        reset_flash_counts()
        out = prefill_fn(*args, **kw)
        prefills.append((FLASH_KERNEL.launches,
                         dict(FLASH_KERNEL.variant_launches),
                         {d: n for d, n in
                          FLASH_KERNEL.head_dim_launches.items() if n}))
        return out

    return patched((engine, "prefill", counted))


def batch_line(tag: str, i: int, res, S: int, counts, cfg, **extra) -> int:
    """One ``[tag]`` line of batch ``i`` and its prefill's flash counts;
    fails unless the prefill launched the bf16 kernel once a layer, all at
    the model's attention head-dim pair. Returns the launches."""
    fl, var, dims = counts
    B = res.tokens.shape[0]
    say(tag, batch=i, requests=B, prompt_len=S,
        prefill_ms=f"{res.prefill_ms:.2f}",
        prefill_tokens_per_s=f"{B * S / res.prefill_ms * 1e3:.0f}",
        decode_ms_per_token=f"{res.decode_ms_per_token:.3f}",
        decode_tokens_per_s=f"{B / res.decode_ms_per_token * 1e3:.1f}",
        flash_launches=fl,
        variants=",".join(f"{k}:{v}" for k, v in var.items()),
        head_dims=",".join(f"{pair_key(d)}:{n}" for d, n in dims.items()),
        **extra)
    L, pair = cfg.n_layers, attn_head_dims(cfg)
    want = {"wgmma_bf16": L, "cuda_core_f32": 0}
    if fl != L or var != want or dims != {pair: L}:
        fail(f"{tag} batch {i}: {fl} flash launches {var} at head dims "
             f"{dims} a prefill, expected {want} at {pair}")
    if not ((0 <= res.tokens) & (res.tokens < cfg.vocab)).all():
        fail(f"{tag} batch {i}: tokens outside the vocabulary")
    return fl


def serve_batches(tag: str, params, cfg, run, reqs) -> tuple[list, int]:
    """``reqs`` through ``BatchServer`` on the card, the flash counts set to
    0 just before each prefill; one ``[tag]`` line a batch and one for the
    run (tokens/s, peak memory). Returns the batches' (responses,
    ``GenResult``) and the flash launches."""
    import torch

    from repro_torch.serve import BatchServer

    server = BatchServer(params, cfg, run, max_batch=SERVE_MAX_BATCH,
                         max_wait_s=0.01, device="cuda")
    for r in reqs:
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    prefills, responses, results = [], [], []
    t0 = time.monotonic()
    with counted_prefills(prefills):
        while len(responses) < len(reqs):
            out = server.serve_once()
            torch.cuda.synchronize()
            results.append((out, server.last_result))
            responses += out
    serve_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(prefills) != len(results):
        fail(f"{len(prefills)} prefills for {len(results)} batches")
    launches = sum(
        batch_line(tag, i, res, max(len(reqs[o.rid].prompt) for o in out),
                   counts, cfg)
        for i, ((out, res), counts) in enumerate(zip(results, prefills)))
    bad = [o.rid for o in responses if o.tokens.shape != (SERVE_MAX_TOKENS,)]
    if bad or len(results) != 2 or sorted(o.rid for o in responses) != list(
            range(len(reqs))):
        fail(f"{tag}: {len(results)} batches, bad responses {bad}")
    say(tag, requests=len(responses), batches=len(results),
        prompt_lens=",".join(str(len(r.prompt)) for r in reqs),
        max_tokens=SERVE_MAX_TOKENS, serve_s=f"{serve_s:.3f}",
        tokens_per_s=f"{sum(len(o.tokens) for o in responses) / serve_s:.1f}",
        flash_launches=launches, params_dtype=run.activations_dtype,
        activations=run.activations_dtype,
        peak_mem_gib=f"{peak / 2**30:.2f}")
    return results, launches


def routing_lines(tag: str, params, cfg, run, results, reqs) -> None:
    """Each batch's routing from an untimed prefill of its padded prompts:
    capacity, tokens per expert, dropped pairs."""
    import torch

    import repro_torch.models.moe as moe
    from repro_torch.models import prefill

    routed, dispatch_fn = [], moe.dispatch_indices
    moe_layers = sum(c for k, c in cfg.layout if k.endswith("_moe"))

    def counted_dispatch(ids, m_, cap, before=None):
        slot, keep = dispatch_fn(ids, m_, cap, before)
        routed.append((torch.bincount(ids.reshape(-1),
                                      minlength=m_.n_experts),
                       (~keep).sum(), cap))
        return slot, keep

    with patched((moe, "dispatch_indices", counted_dispatch)):
        for i, (out, _) in enumerate(results):
            routed.clear()
            prefill(params, {"tokens": torch.from_numpy(padded_prompts(
                [reqs[o.rid] for o in out])).cuda()}, cfg, run)
            loads = torch.stack([c for c, _, _ in routed]).cpu()  # (L, E)
            dropped = int(sum(int(d) for _, d, _ in routed))
            cap = routed[0][2]
            say(tag, batch=i, routing="untimed_prefill",
                moe_layers=len(routed), capacity=cap,
                routed_pairs=int(loads.sum()),
                tokens_per_expert_min=int(loads.min()),
                tokens_per_expert_mean=f"{float(loads.float().mean()):.1f}",
                tokens_per_expert_max=int(loads.max()),
                experts_over_capacity=int((loads > cap).sum()),
                dropped_pairs=dropped,
                dropped_share=f"{dropped / int(loads.sum()):.4f}")
            if len(routed) != moe_layers:
                fail(f"{tag} batch {i}: {len(routed)} MoE layers a prefill, "
                     f"expected {moe_layers}")


def capture_layers(params, cfg, run, batch: dict, layers) -> dict:
    """The q/k/v (and window) of the prefill attention of ``layers`` in one
    prefill of ``batch`` (``tokens`` or a frame model's ``frames``), by
    layer."""
    import repro_torch.models.attention as attention
    from repro_torch.models import prefill

    calls, attn_fn = [], attention.flash_attention

    def capture(q, k, v, **kw):
        calls.append((q, k, v, kw.get("window"))
                     if len(calls) in layers else None)
        return attn_fn(q, k, v, **kw)

    with patched((attention, "flash_attention", capture)):
        prefill(params, batch, cfg, run)
    return {i: calls[i] for i in layers}


def flash_checks(name: str, captured: dict, pair: tuple, ragged: int) -> tuple:
    """The flash kernel against its plain version, bf16 and f32, on each
    captured layer, also cut to ``ragged`` keys and as a 64-query
    ``q_offset`` chunk, at the absolute and the per-row tolerance. Returns
    the largest error and the first layer's whole-sequence timings by
    dtype."""
    import torch

    errs, timing = [], {}
    off = ATTN_CHECK_S - 64
    first = min(captured)
    for dtype in (torch.bfloat16, torch.float32):
        for layer, (q, k, v, w) in captured.items():
            if w is not None or (q.shape[-1], v.shape[-1]) != pair:
                fail(f"layer {layer}: window {w}, head dims {q.shape[-1]}, "
                     f"{v.shape[-1]}")
            lab = f"{name}_l{layer}"
            r = check_attention(lab, q, k, v, w, 0, dtype, row_rtol=True)
            errs.append(r["err"])
            if layer == first:
                timing[str(dtype).removeprefix("torch.")] = r
            errs.append(check_attention(f"{lab}_q_offset", q[:, off:], k, v,
                                        w, off, dtype, row_rtol=True)["err"])
            errs.append(check_attention(
                f"{lab}_S{ragged}", q[:, :ragged], k[:, :ragged],
                v[:, :ragged], w, 0, dtype, row_rtol=True)["err"])
    return max(errs), timing


def flash_timing(timing: dict, q, k, v) -> None:
    """SDPA's time and the bounds beside each dtype's kernel timing, on the
    inputs the kernel ran (v and the output at v's own width)."""
    import torch
    import torch.nn.functional as F

    for dt_name, t in timing.items():
        dtype = getattr(torch, dt_name)
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        _, lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            is_causal=True, enable_gqa=True))
        b_ms, b_by, nbytes, ops = attention_bound_ms(qd, kd, vd, None)
        t.update(sdpa_ms=lib_ms, shape=list(q.shape), dv=v.shape[-1])
        t.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops,
                 f32_core_bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                       ops / F32_FLOPS_PER_S) * 1e3)


def layers_vs_plain(cfg, layout, prompts: dict) -> None:
    """The first layers of ``cfg`` (``layout``) at full width in f32 on
    ``prompts`` (numpy ``tokens`` or a frame model's ``frames``): the
    kernel path against the plain path, logits within 1e-3 x max |logit|
    and every routed expert id equal save under a ``MOE_NEAR_TIE`` top-k
    gap."""
    import torch

    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.models import RunConfig, model_init, prefill

    cfg2 = cut_depth(cfg, layout)
    run32 = RunConfig(activations_dtype="float32")
    params, _ = model_init(0, cfg2, run32, device="cuda")
    batch = {k: torch.from_numpy(a).cuda() for k, a in prompts.items()}
    B, S = next(iter(prompts.values())).shape[:2]
    paths = {}
    for name in ("kernel", "plain"):
        routes = []
        with contextlib.ExitStack() as stack:
            if name == "plain":
                stack.enter_context(plain_path())
            stack.enter_context(moe_route_recorder(routes))
            f0 = FLASH_KERNEL.launches
            logits, _ = prefill(params, batch, cfg2, run32)
            fl = FLASH_KERNEL.launches - f0
        if fl != (cfg2.n_layers if name == "kernel" else 0):
            fail(f"the {name} path launched flash attention {fl} times")
        paths[name] = (logits[..., :cfg.vocab], routes)
    del params
    torch.cuda.empty_cache()
    (lk, rk), (lp, rp) = paths["kernel"], paths["plain"]
    diff = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    pairs = differ = near_tie = 0
    for (ik, _), (ip, gap) in zip(rk, rp):
        rows = (ik != ip).any(-1)
        near = gap < MOE_NEAR_TIE
        pairs += ik.numel()
        differ += int(rows.sum())
        near_tie += int((rows & near).sum())
        if bool((rows & ~near).any()):
            fail(f"expert ids differ off a near-tie: {int(rows.sum())} "
                 f"tokens, {int((rows & near).sum())} near ties")
    finite = bool(lk.isfinite().all())
    say("serve_vs_plain", arch=cfg.name, layers=cfg2.n_layers,
        kinds=",".join(k for k, _ in layout), activations="float32",
        params_dtype="float32", inputs=",".join(prompts), batch=B,
        prompt_len=S, max_abs_logit_diff=diff,
        max_abs_logit=scale, ratio=f"{diff / scale:.3g}", bound="1e-3",
        finite=finite, routed_pairs=pairs, tokens_with_other_ids=differ,
        near_tie_exceptions=near_tie, near_tie_gap=MOE_NEAR_TIE)
    if not finite or not diff <= 1e-3 * scale:
        fail(f"{cfg.name} f32 logits: kernel path vs plain path {diff} > "
             f"1e-3 x {scale}")


def serve_requests(cfg):
    """The 8 requests of the serving phases: prompt lengths and tokens
    from seed 0."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    SERVE_MAX_TOKENS) for i, n in enumerate(lens)]
    return rng, lens, reqs


def init_line(tag: str, cfg, run, **extra):
    """``model_init`` on the card for a bf16 run, timed, with one ``[tag]``
    line (parameters, weight bytes, init time and peak). Returns the
    parameters."""
    import torch

    from repro_torch.models import count_params, model_init
    from repro_torch.models.layers import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params, _ = model_init(0, cfg, run, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    say(tag, arch=cfg.name, **extra, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        attn_head_dims=pair_key(attn_head_dims(cfg)),
        params=count_params(params),
        weights_gib=f"{weight_bytes / 2**30:.2f}", init_s=f"{init_s:.2f}",
        init_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return params


def child_result(dims: dict, err: float | None = None,
                 timing: dict | None = None) -> None:
    """The last line of a serving child: its flash launches by head dim,
    the largest kernel-vs-plain error and the kernel timings."""
    print(json.dumps({"head_dim_launches": {pair_key(d): n
                                            for d, n in dims.items()},
                      "max_abs_err": err, "timing": timing or {}}),
          flush=True)


def serve_moe() -> None:
    """``--serve-moe``: moonshot-v1-16b-a3b at full width and depth on the
    card, in a process of its own (its 54 GiB of bf16 weights meet no other
    phase's memory). Prints its ``[serve_moe]``, ``[kernel_vs_plain]``,
    ``[serve_vs_plain]`` and ``[prefill_split]`` lines, then one JSON line
    for the kernels line and ``[kernel_time]``."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import RunConfig
    from repro_torch.serve import generate

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the MoE router must multiply in f32")
    cfg, run = ARCHS[MOE_ARCH], RunConfig()
    m = cfg.moe
    params = init_line("serve_moe", cfg, run, layers=cfg.n_layers,
                       experts=m.n_experts, top_k=m.top_k,
                       d_expert=m.d_expert, shared=m.n_shared)
    rng, lens, reqs = serve_requests(cfg)
    generate(params, cfg, run, reqs[0].prompt[None, :128], 2, device="cuda")
    results, launches = serve_batches("serve_moe", params, cfg, run, reqs)
    routing_lines("serve_moe", params, cfg, run, results, reqs)

    # ---- q/k/v of layers 0 and 47 from a full-width prefill, the split ----
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ATTN_CHECK_B, ATTN_CHECK_S)).astype(np.int32)).cuda()
    captured = capture_layers(params, cfg, run, {"tokens": toks},
                              MOE_CAPTURE_LAYERS)
    prompts = padded_prompts(reqs[:SERVE_MAX_BATCH])
    moe_prefill_split(params, cfg, run, torch.from_numpy(prompts).cuda())
    del params
    torch.cuda.empty_cache()

    # ---- the flash kernel against its plain version at D = 128 -----------
    ragged = int(lens[SERVE_MAX_BATCH:].max())  # batch 1's length
    err, timing = flash_checks("moonshot", captured, attn_head_dims(cfg),
                               ragged)
    flash_timing(timing, *captured[0][:3])
    del captured
    torch.cuda.empty_cache()

    # ---- kernel path against plain path: 2 layers at full width, f32 ------
    layers_vs_plain(cfg, (("attn_moe", MOE_PLAIN_LAYERS),),
                    {"tokens": prompts})
    child_result({attn_head_dims(cfg): launches}, err, timing)


def serve_mla() -> None:
    """``--serve-mla``: deepseek-v2-236b at full width, its dense first
    layer and ``MLA_LAYOUT``'s MoE layers, on the card in a process of its
    own: the same 8 requests through ``BatchServer`` (one ``wgmma_bf16``
    flash launch at the head-dim pair (192, 128) a layer a prefill),
    routing from untimed prefills, the flash kernel against its plain
    version on the q/k/v (q and k 192 wide, v 128) of the first and last
    layers, then the first two layers in f32 on the kernel path against
    the plain path. Prints
    ``[serve_mla]``, ``[kernel_vs_plain]`` and ``[serve_vs_plain]`` lines,
    then one JSON line."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import RunConfig
    from repro_torch.serve import generate

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the MoE router must multiply in f32")
    full, run = ARCHS[MLA_ARCH], RunConfig()
    cfg = cut_depth(full, MLA_LAYOUT)
    m, mla = cfg.moe, cfg.mla
    pair = attn_head_dims(cfg)
    params = init_line(
        "serve_mla", cfg, run,
        layers=f"{cfg.n_layers}_of_{full.n_layers}",
        layout=",".join(f"{k}:{c}" for k, c in cfg.layout),
        q_lora=mla.q_lora_rank, kv_lora=mla.kv_lora_rank,
        qk_head_dim=f"{mla.qk_nope_head_dim}+{mla.qk_rope_head_dim}",
        v_head_dim=mla.v_head_dim, experts=m.n_experts, top_k=m.top_k,
        d_expert=m.d_expert, shared=m.n_shared, dense_d_ff=cfg.dense_d_ff)
    rng, lens, reqs = serve_requests(cfg)
    generate(params, cfg, run, reqs[0].prompt[None, :128], 2, device="cuda")
    results, launches = serve_batches("serve_mla", params, cfg, run, reqs)
    routing_lines("serve_mla", params, cfg, run, results, reqs)

    # ---- q/k/v of the first and last layers of a full-width prefill -------
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ATTN_CHECK_B, ATTN_CHECK_S)).astype(np.int32)).cuda()
    captured = capture_layers(params, cfg, run, {"tokens": toks},
                              (0, cfg.n_layers - 1))
    del params
    torch.cuda.empty_cache()
    for layer, (q, k, v, _) in captured.items():
        if q.shape[2] != cfg.n_heads:
            fail(f"layer {layer}: {q.shape[2]} heads")
    ragged = int(lens[SERVE_MAX_BATCH:].max())  # batch 1's length
    err, timing = flash_checks("deepseek", captured, pair, ragged)
    flash_timing(timing, *captured[0][:3])
    del captured
    torch.cuda.empty_cache()

    # ---- kernel path against plain path: 2 layers at full width, f32 ------
    layers_vs_plain(full, (("mla_dense", 1), ("mla_moe", 1)),
                    {"tokens": padded_prompts(reqs[:SERVE_MAX_BATCH])})
    child_result({pair: launches}, err, timing)


def int8_run(params, cfg, run, kv: str, x, feed, fault: str | None = None):
    """One prefill of frames ``x`` and teacher-forced decode steps of
    ``feed`` with the KV cache in ``kv``. Returns the logits (B, 1 + steps,
    V), the caches and, by step, the K/V rows each decode step quantized
    (the inputs of ``attention.quantize_kv``, in call order: K then V of
    each layer). ``fault`` plants a fault in the int8 path: the decode
    steps write zero scales (``decode_scale_zeroed``) or the first layer's
    V scales over the prompt are zeroed (``prompt_v_scale_zeroed``)."""
    import dataclasses

    import torch

    import repro_torch.models.attention as attention
    from repro_torch.models import decode_step, prefill

    r = dataclasses.replace(run, kv_cache_dtype=kv)
    S, steps = x.shape[1], feed.shape[1]
    lg, c = prefill(params, {"frames": x}, cfg, r, cache_len=S + steps)
    if fault == "prompt_v_scale_zeroed":
        next(iter(c.values()))[0]["v_scale"][:, :S] = 0
    got, rows, quantize = [lg], [], attention.quantize_kv

    def recorded(t):
        rows[-1].append(t)
        qv, sc = quantize(t)
        return qv, (sc * 0 if fault == "decode_scale_zeroed" else sc)

    with patched((attention, "quantize_kv", recorded)):
        for t in range(steps):
            rows.append([])
            lg, c = decode_step(params, c, {"frames": feed[:, t:t + 1],
                                            "pos": S + t}, cfg, r)
            got.append(lg)
    return torch.cat(got, 1)[..., :cfg.vocab], c, rows


def int8_elem_err(c8, c_bf16, rows, S: int) -> tuple[float, float]:
    """The largest error of a cached int8 K/V element, in half quanta (its
    row's scale / 2): the prompt's rows against the bf16 cache's, and the
    rows each decode step wrote (slot S + step) against the K/V that step
    quantized (a stale slot or a scale left unwritten shows here; the
    decode rows of the two caches differ by more, as they follow from
    different caches). A zero scale reads inf (nan taken as inf)."""
    layers = [lc for group in c8.values() for lc in group]
    bf16 = [lc for group in c_bf16.values() for lc in group]
    prompt = decode = 0.0
    for s, step in enumerate(rows):
        if len(step) != 2 * len(layers):
            fail(f"decode step {s} quantized {len(step)} K/V rows, "
                 f"expected {2 * len(layers)}")
    for j, (lc, lb) in enumerate(zip(layers, bf16)):
        for n, name in enumerate(("k", "v")):
            sc = lc[f"{name}_scale"][:, :S]
            err = lc[name][:, :S].float() * sc - lb[name][:, :S].float()
            prompt = max(prompt, half_quanta(err, sc))
            for s, step in enumerate(rows):
                sc = lc[f"{name}_scale"][:, S + s]
                err = (lc[name][:, S + s].float() * sc
                       - step[2 * j + n][:, 0].float())
                decode = max(decode, half_quanta(err, sc))
    return prompt, decode


def half_quanta(err, sc) -> float:
    """max |err| / (sc / 2), nan (0 / 0) taken as inf."""
    return float((err.abs() / (sc / 2)).nan_to_num(
        nan=float("inf"), posinf=float("inf")).max())


def int8_vs_bf16(params, cfg, run, frames) -> None:
    """``[serve_int8]``: one prefill of ``frames`` and ``INT8_DECODE_STEPS``
    teacher-forced decode steps (the same seeded frames fed to both) with
    the int8 KV cache against the bf16 cache. Holds every cached K/V
    element within half an int8 quantum (its row's amax / 254) of the K/V
    it stands for (``int8_elem_err``), and the logits within
    ``int8_logit_bound`` x max |logit|. Then each planted fault of
    ``int8_run`` with its readings: the element check must flag it; whether
    the logit bound does too is printed."""
    import numpy as np
    import torch

    from repro_torch.models.layers import tree_leaves

    B, S = frames.shape[:2]
    steps = INT8_DECODE_STEPS
    feed = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, steps, cfg.d_model), dtype=np.float32)).cuda()
    x = torch.from_numpy(frames).cuda()
    logits, caches, cache_bytes = {}, {}, {}
    for kv in ("bfloat16", "int8"):
        logits[kv], caches[kv], rows = int8_run(params, cfg, run, kv, x, feed)
        cache_bytes[kv] = sum(t.numel() * t.element_size()
                              for layers in caches[kv].values()
                              for lc in layers for t in tree_leaves(lc))
    bound = int8_logit_bound(cfg.n_layers)
    lb = logits["bfloat16"]
    scale = float(lb.abs().max())

    def readings(l8, c8, rows) -> tuple[float, float, float]:
        prompt_err, decode_err = int8_elem_err(c8, caches["bfloat16"],
                                               rows, S)
        return float((l8 - lb).abs().max()), prompt_err, decode_err

    l8 = logits["int8"]
    diff, prompt_err, decode_err = readings(l8, caches["int8"], rows)
    del caches["int8"]
    agree = (l8.argmax(-1) == lb.argmax(-1)).float()
    say("serve_int8", arch=cfg.name, layers=cfg.n_layers, batch=B,
        prompt_len=S, decode_steps=steps, teacher_forced="seeded_frames",
        max_abs_logit_diff=diff, max_abs_logit=scale,
        ratio=f"{diff / scale:.4g}", bound=f"{bound:.4g}",
        bound_rule="2*sqrt(layers)/254",
        greedy_agreement=f"{float(agree.mean()):.4f}",
        first_token_agreement=f"{float(agree[:, 0].mean()):.4f}",
        cache_bytes_bf16=cache_bytes["bfloat16"],
        cache_bytes_int8=cache_bytes["int8"],
        cache_ratio=f"{cache_bytes['int8'] / cache_bytes['bfloat16']:.4f}",
        max_elem_err_half_quanta=f"{prompt_err:.6f}",
        decode_rows_max_elem_err_half_quanta=f"{decode_err:.6f}",
        elem_bound="1 (+1e-4)", finite=bool(l8.isfinite().all()))
    if not max(prompt_err, decode_err) <= 1 + 1e-4:
        fail(f"an int8 cache element is {max(prompt_err, decode_err)} half "
             "quanta off the K/V it stands for")
    if not bool(l8.isfinite().all()) or not diff <= bound * scale:
        fail(f"int8 cache logits {diff} > {bound:.4g} x {scale}")
    for fault in INT8_FAULTS:
        lf, cf, rows = int8_run(params, cfg, run, "int8", x, feed, fault)
        f_diff, f_prompt, f_decode = readings(lf, cf, rows)
        del cf
        flagged = not max(f_prompt, f_decode) <= 1 + 1e-4
        say("serve_int8_fault", arch=cfg.name, fault=fault,
            max_elem_err_half_quanta=f_prompt,
            decode_rows_max_elem_err_half_quanta=f_decode,
            elements_flag_it=flagged, ratio=f"{f_diff / scale:.4g}",
            bound=f"{bound:.4g}", logits_flag_it=f_diff > bound * scale)
        if not flagged:
            fail(f"the element check missed the planted fault {fault}")


def int8_logit_bound(layers: int) -> float:
    """The bound on max |logit(int8) - logit(bf16)| / max |logit|: a
    cached element moves by at most half an int8 quantum, 1/254 of its
    row's amax; each layer's K and V add one such relative error, and the
    layers' errors, independent roundings, add as a random walk:
    2 sqrt(layers) / 254 (0.0445 at 32 layers, under the 5e-2 ceiling)."""
    return min(5e-2, 2 * layers**0.5 / 254)


def serve_frames() -> None:
    """``--serve-frames``: the frame-input models on the card, in a process
    of their own: musicgen-medium at full width and depth and qwen2-vl-72b
    at full width with ``FRAME_ARCHS``' depth (M-RoPE, GQA at G = 8), each
    through ``generate`` on seeded numpy frame prompts in 2 batches of 4
    (the serving phases' prompt lengths), the flash counts set to 0 just
    before each prefill; then ``[serve_int8]`` on qwen2-vl; then, for
    each model, the flash kernel against its plain version on the q/k/v of
    the first and last layers of a full-width prefill of seeded frames
    (bf16 and f32, with 7b's cuts) and its first ``FRAME_PLAIN_LAYERS``
    layers in f32 on the kernel path against the plain path. Prints
    ``[serve_frames]``, ``[serve_int8]``, ``[kernel_vs_plain]`` and
    ``[serve_vs_plain]`` lines, then one JSON line."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import RunConfig
    from repro_torch.serve import generate

    run = RunConfig()
    dims: dict[int, int] = {}
    errs = []
    for name, depth in FRAME_ARCHS:
        full = ARCHS[name]
        cfg = full if depth is None else cut_depth(
            full, ((full.layout[0][0], depth),))
        params = init_line("serve_frames", cfg, run,
                           layers=f"{cfg.n_layers}_of_{full.n_layers}",
                           pos=cfg.pos, norm=cfg.norm, mlp=cfg.mlp)
        _, lens, _ = serve_requests(cfg)
        rng = np.random.default_rng(0)
        batches = [rng.standard_normal(
            (SERVE_MAX_BATCH, int(lens[b:b + SERVE_MAX_BATCH].max()),
             cfg.d_model), dtype=np.float32)
            for b in range(0, SERVE_REQUESTS, SERVE_MAX_BATCH)]
        generate(params, cfg, run, batches[0][:, :128], 2, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        prefills, results = [], []
        t0 = time.monotonic()
        with counted_prefills(prefills):
            for frames in batches:
                results.append(generate(params, cfg, run, frames,
                                        SERVE_MAX_TOKENS, device="cuda"))
        serve_s = time.monotonic() - t0
        launches = sum(batch_line("serve_frames", i, res, frames.shape[1],
                                  counts, cfg, arch=cfg.name)
                       for i, (res, frames, counts)
                       in enumerate(zip(results, batches, prefills)))
        if any(res.tokens.shape != (SERVE_MAX_BATCH, SERVE_MAX_TOKENS)
               for res in results):
            fail(f"{name}: token shapes {[r.tokens.shape for r in results]}")
        pair = attn_head_dims(cfg)
        dims[pair] = dims.get(pair, 0) + launches
        say("serve_frames", arch=cfg.name, batches=len(results),
            prompt_lens=",".join(str(f.shape[1]) for f in batches),
            max_tokens=SERVE_MAX_TOKENS, serve_s=f"{serve_s:.3f}",
            tokens_per_s=f"{len(batches) * SERVE_MAX_BATCH * SERVE_MAX_TOKENS / serve_s:.1f}",
            flash_launches=launches,
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
        if cfg.pos == "mrope":
            int8_vs_bf16(params, cfg, run, batches[0])

        # ---- q/k/v of the first and last layers of a full-width prefill --
        frames = torch.from_numpy(rng.standard_normal(
            (ATTN_CHECK_B, ATTN_CHECK_S, cfg.d_model),
            dtype=np.float32)).cuda()
        captured = capture_layers(params, cfg, run, {"frames": frames},
                                  (0, cfg.n_layers - 1))
        del params, frames
        torch.cuda.empty_cache()
        err, _ = flash_checks(cfg.name, captured, pair, batches[1].shape[1])
        errs.append(err)
        del captured
        torch.cuda.empty_cache()

        # ---- kernel path against plain path: 2 layers at full width, f32 --
        layers_vs_plain(full, ((full.layout[0][0], FRAME_PLAIN_LAYERS),),
                        {"frames": batches[0]})
    child_result(dims, max(errs))


# ---------------------------------------------------------------------------
# training: stablelm-1.6b through repro_torch.train.train, flash attention
# forward and backward kernels
# ---------------------------------------------------------------------------
def bwd_bound_ms(q, k, v, window, q_offset=0) -> tuple[float, str, int, int]:
    """Least time the card could take for one attention backward: the
    larger of q, k, v, out, dout and lse read once and dq, dk, dv written
    once over HBM bandwidth (out, dout and dv at v's width Dv), and 6 D +
    4 Dv operations per visible (query, key) pair (Q K^T and dO V^T
    recomputed, P^T dO, dS^T Q, dS K; the masks counted exactly) over the
    bf16 tensor-core rate."""
    from repro_torch.kernels.flash_attention import attention_mask

    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    pairs = int(attention_mask(Sq, k.shape[1], causal=True, window=window,
                               q_offset=q_offset, device=q.device).sum())
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv)
              * q.element_size() + B * Sq * H * 4)
    return roofline(nbytes, (6 * D + 4 * Dv) * pairs * B * H,
                    BF16_FLOPS_PER_S)


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / max(||want||, BWD_ROW_FLOOR x the mean
    row norm of want) over the rows (each a D-vector)."""
    g, w = got.float(), want.float()
    norms = w.norm(dim=-1)
    floor = BWD_ROW_FLOOR * float(norms.mean())
    return float(((g - w).norm(dim=-1) / norms.clamp_min(max(floor, 1e-30)))
                 .max())


def kv_groups(KH: int, G: int, group: int | None) -> list:
    """(KV-head slice, query-head slice) of each group of ``group`` KV heads
    (one group of all where ``group`` is None)."""
    n = KH if group is None else group
    return [(slice(h, min(h + n, KH)), slice(h * G, min(h + n, KH) * G))
            for h in range(0, KH, n)]


def plain_bwd(q, k, v, out, lse, dout, group: int | None = None, **kw):
    """``flash_attention_bwd_ref`` in groups of ``group`` KV heads and
    their query heads, the groups' results joined: the same function,
    each group's S x S tensors alone in memory."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    G = q.shape[2] // k.shape[2]
    parts = [flash_attention_bwd_ref(q[:, :, qh], k[:, :, kh], v[:, :, kh],
                                     out[:, :, qh], lse[:, :, qh],
                                     dout[:, :, qh], **kw)
             for kh, qh in kv_groups(k.shape[2], G, group)]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def plain_lse(q, k, v, group: int | None = None, **kw):
    """The row log-sum-exp of ``flash_attention_ref`` in groups of
    ``group`` KV heads, as ``plain_bwd``."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_ref

    G = q.shape[2] // k.shape[2]
    return torch.cat([flash_attention_ref(q[:, :, qh], k[:, :, kh],
                                          v[:, :, kh], return_lse=True,
                                          **kw)[1]
                      for kh, qh in kv_groups(k.shape[2], G, group)], dim=2)


def check_bwd(label, q, k, v, dout, window, q_offset, dtype,
              group: int | None = None) -> dict:
    """The backward kernels against their plain version on the card, on
    the forward kernel's own out and lse (so that the backward alone is
    compared); bf16 on both routes (``wgmma``, ``mma_sync``) at the per-row
    bound ``BWD_ROW_RTOL``, f32 (one kernel whatever the route) within
    ``BWD_F32_RTOL`` x max |.|; a second call of each must give the same
    bits. With ``group`` the plain version runs in groups of that many KV
    heads (``plain_bwd``); the kernels run on every head at once."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_ROUTES, BWD_VARIANTS,
    )

    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    lse_err = float((lse - plain_lse(q, k, v, group, **kw)).abs().max())
    want, p_ms = median_ms(lambda: plain_bwd(q, k, v, out, lse, dout, group,
                                             **kw))
    scales = [float(b.float().abs().max()) for b in want]
    bf16 = dtype == torch.bfloat16
    res = {}
    for route in BWD_ROUTES if bf16 else BWD_ROUTES[:1]:
        fn = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              route=route, **kw)
        got, k_ms = median_ms(fn)
        again = fn()
        repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        rows = [row_rel_err(a, b) for a, b in zip(got, want)]
        finite = all(bool(t.isfinite().all()) for t in got)
        ok = (max(rows) <= BWD_ROW_RTOL if bf16 else
              all(e <= BWD_F32_RTOL * s for e, s in zip(errs, scales)))
        say("kernel_vs_plain", kernel="flash_attention_bwd", case=label,
            dtype=str(dtype).removeprefix("torch."), route=route,
            variant=BWD_VARIANTS[route][dtype], shape=tuple(q.shape),
            kv=tuple(k.shape), dv=v.shape[-1], window=window,
            q_offset=q_offset,
            plain_split=(f"{group}_kv_heads_a_group" if group else "none"),
            max_abs_err_dq_dk_dv=",".join(f"{e:.3g}" for e in errs),
            max_abs_dq_dk_dv=",".join(f"{s:.3g}" for s in scales),
            max_row_rel_err_dq_dk_dv=",".join(f"{r:.3g}" for r in rows),
            bound=(f"row_rel<={BWD_ROW_RTOL}" if bf16
                   else f"abs<={BWD_F32_RTOL}*max"),
            lse_max_abs_err=f"{lse_err:.3g}", repeat_equal=repeat_equal,
            finite=finite, kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
        if not (ok and finite and repeat_equal and lse_err <= 1e-3):
            fail(f"flash_attention_bwd ({route}) != plain on {label} "
                 f"{dtype}: errors {errs}, row {rows}, lse {lse_err}, "
                 f"repeat {repeat_equal}")
        res[route] = dict(err=max(errs), ms=k_ms)
    return dict(err=max(r["err"] for r in res.values()), plain_ms=p_ms,
                routes=res)


def bwd_kernel_time(case: str, B: int, S: int, H: int, KH: int, D: int,
                    Dv: int, group: int | None = None) -> dict:
    """The backward kernels at a training shape on seeded inputs (q and k
    of head dim D, v of Dv), both routes from one run: each alone from the
    profiler (its three kernels) and through the wrapper (CUDA events, the
    routes in turns), the plain version (``plain_bwd``, in groups of
    ``group`` KV heads where given), SDPA's backward on the same bf16
    inputs (the library yardstick), the bound (6 D + 4 Dv a visible pair)
    and the design floor of the two-pass kernels (8 D + 6 Dv: Q K^T and dO
    V^T recomputed in each pass). Run first in the ``--train`` and
    ``--train-mla`` children."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.flash_attention import (
        BWD_ROUTES, BWD_VARIANTS,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                     .to(torch.bfloat16)
                     for shape in ((B, S, H, D), (B, S, KH, D),
                                   (B, S, KH, Dv), (B, S, H, Dv)))
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    fns = {r: (lambda r=r: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                    route=r))
           for r in BWD_ROUTES}
    alone, split = {}, {}
    for route, fn in fns.items():
        # a call is three kernels: delta, dK/dV, dQ
        alone[route] = profiled_ms(fn, "flash_bwd", kernels=3)
        if alone[route][0] is None:
            fail(f"no trace held the three flash backward kernels ({route})")
        split[route] = kernel_split_ms(fn, "flash_bwd")
    runs = {r: [] for r in BWD_ROUTES}
    for turn in (BWD_ROUTES, BWD_ROUTES[::-1], BWD_ROUTES):
        for route in turn:
            runs[route].append(timed(fns[route])[1])
    wrapper = {r: statistics.median(t) for r, t in runs.items()}
    _, p_ms = median_ms(lambda: plain_bwd(q, k, v, out, lse, dout, group))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    do = dout.transpose(1, 2)
    _, lib_ms = median_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do, retain_graph=True))
    del o, qt, kt, vt
    b_ms, b_by, nbytes, ops = bwd_bound_ms(q, k, v, None)
    # the two passes' own work: 8 D + 6 Dv a visible pair
    floor_ops = ops // (6 * D + 4 * Dv) * (8 * D + 6 * Dv)
    floor_ms = floor_ops / BF16_FLOPS_PER_S * 1e3
    for route in BWD_ROUTES:
        a_ms, kernels, discarded = alone[route]
        ms = wrapper[route]
        say("kernel_time", kernel="flash_attention_bwd", case=case,
            dtype="bfloat16", route=route,
            variant=BWD_VARIANTS[route][torch.bfloat16], shape=(B, S, H, D),
            kv_heads=KH, dv=Dv, ms=f"{ms:.4f}",
            ms_runs=",".join(f"{t:.4f}" for t in runs[route]),
            kernel_alone_ms=f"{a_ms:.4f}", kernels_per_call=kernels,
            discarded_traces=discarded,
            kernels_ms=",".join(f"{k}:{t:.4f}"
                                for k, t in split[route].items())
            or "not measured",
            plain_ms=f"{p_ms:.4f}",
            plain_split=(f"{group}_kv_heads_a_group" if group else "none"),
            sdpa_bwd_ms=f"{lib_ms:.4f}",
            vs_sdpa=f"{ms / lib_ms:.3f}",
            alone_vs_sdpa=f"{a_ms / lib_ms:.3f}",
            bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes, ops=ops,
            design_floor_ms=f"{floor_ms:.5f}",
            times_bound=f"{ms / b_ms:.2f}",
            alone_times_bound=f"{a_ms / b_ms:.2f}",
            alone_times_floor=f"{a_ms / floor_ms:.2f}",
            achieved_tflops_of_executed=f"{floor_ops / a_ms / 1e9:.1f}")
    return dict(ms=wrapper["wgmma"], alone_ms=alone["wgmma"][0],
                plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def train_run_config():
    """The training CLI's RunConfig at ``TRAIN_SEQ`` on a full-size
    configuration (``launch/train.py``)."""
    from repro_torch.models import RunConfig

    return RunConfig(remat="none", attn_chunk_q=min(512, TRAIN_SEQ),
                     attn_chunk_k=min(1024, TRAIN_SEQ),
                     learning_rate=TRAIN_LR, vocab_round=128)


SSD_KINDS = ("ssd", "hymba_g", "hymba_w")


def layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, SSD layers) of a configuration: hymba's layers
    have both, mamba2's SSD alone."""
    attn = sum(n for kind, n in cfg.layout if kind != "ssd")
    ssd = sum(n for kind, n in cfg.layout if kind in SSD_KINDS)
    return attn, ssd


def plain_ssd_counter(calls: list):
    """Count the calls of the SSD pass's plain versions (forward and
    backward) on the autograd path, each appending its name to ``calls``."""
    import repro_torch.kernels.ssd.ops as ssd_ops

    def counted(name):
        real = getattr(ssd_ops, name)

        def fn(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return fn

    return patched(*((ssd_ops, n, counted(n)) for n in (
        "ssd_intra_chunk_ref", "ssd_intra_chunk_bwd_ref")))


def train_main(cfg, run, tag: str = "train", steps: int = TRAIN_STEPS,
               batch: int = TRAIN_BATCH) -> tuple[int, int, dict, dict]:
    """The main path: ``train`` on the card for ``steps`` steps of
    ``batch`` x TRAIN_SEQ tokens, the launch counts set to 0 just before
    and read just after; every flash launch must be at the model's head-dim
    pair, and an SSD layer must launch the forward kernel in bf16 and the
    backward kernel once a step and the plain versions never. Returns the
    forward and backward flash launches, the backward's by variant and the
    SSD kernels' by variant (``{"fwd": ..., "bwd": ...}``)."""
    import statistics

    import torch

    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.kernels.ssd import KERNEL_BWD as SSD_BWD
    from repro_torch.models import count_params, model_init
    from repro_torch.train import LoopConfig, train

    n_params = count_params(model_init(0, cfg, run, device="meta")[0])
    loop = LoopConfig(steps=steps, batch=batch, seq=TRAIN_SEQ,
                      log_every=0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    BWD_KERNEL.reset()
    SSD_KERNEL.reset()
    SSD_BWD.reset()
    plain_calls = []
    with plain_ssd_counter(plain_calls):
        res = train(cfg, run, loop, device="cuda")
        torch.cuda.synchronize()
    fwd = dict(FLASH_KERNEL.variant_launches)
    bwd = dict(BWD_KERNEL.variant_launches)
    ssd_fwd = dict(SSD_KERNEL.variant_launches)
    ssd_bwd = dict(SSD_BWD.variant_launches)
    pairs_run = {pair_key(p): (n, BWD_KERNEL.head_dim_launches[p])
                 for p, n in FLASH_KERNEL.head_dim_launches.items()
                 if n or BWD_KERNEL.head_dim_launches[p]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (loss, gn, ms) in enumerate(zip(res.losses, res.grad_norms,
                                           res.step_ms)):
        say(tag, arch=cfg.name, step=i + 1, loss=repr(loss),
            grad_norm=repr(gn), ms=f"{ms:.2f}")
    L = cfg.n_layers
    n_attn, n_ssd = layer_counts(cfg)
    again = 2 if run.remat == "block" else 1
    n_fwd = steps * n_attn * again
    want_fwd = {"wgmma_bf16": n_fwd, "cuda_core_f32": 0}
    want_bwd = {"wgmma_bf16": steps * n_attn, "mma_bf16": 0,
                "cuda_core_f32": 0}
    want_ssd_fwd = {"mma_bf16": steps * n_ssd * again, "cuda_core_f32": 0}
    want_ssd_bwd = {"cuda_core_bf16_in": steps * n_ssd, "cuda_core_f32": 0}
    D, Dv = attn_head_dims(cfg)
    want_pairs = {pair_key((D, Dv)): (n_fwd, steps * n_attn)} if n_attn else {}
    med = statistics.median(res.step_ms[2:])
    tokens = batch * TRAIN_SEQ
    # visible (query, key) pairs of the attention layers (hymba_w's window)
    pairs = sum(n * sum(min(i + 1, cfg.window if kind.endswith("_w")
                            else TRAIN_SEQ) for i in range(TRAIN_SEQ))
                for kind, n in cfg.layout if kind != "ssd")
    # 6 a parameter a token; attention 2 D + 2 Dv a visible pair forward,
    # twice that backward; an SSD head 2 N + 2 P a causal pair of a chunk
    # and 2 N P a step forward, 4 P + 6 N and 4 N P backward
    flops = (6 * n_params * tokens
             + 6 * (D + Dv) * pairs * cfg.n_heads * batch)
    ssd_extra = {}
    if n_ssd:
        s = cfg.ssm
        N, P, H = s.d_state, s.head_dim, s.n_heads(cfg.d_model)
        Lc = min(run.ssd_chunk or s.chunk, TRAIN_SEQ)
        ssd_pairs = sum(ln * (ln + 1) // 2 for ln in (
            min(Lc, TRAIN_SEQ - c) for c in range(0, TRAIN_SEQ, Lc)))
        flops += n_ssd * H * batch * (
            ssd_pairs * (6 * P + 8 * N) + 6 * N * P * TRAIN_SEQ)
        ssd_extra = dict(
            ssd_layers=n_ssd,
            ssd_fwd_launches=",".join(f"{k}:{n}" for k, n in ssd_fwd.items()),
            ssd_bwd_launches=",".join(f"{k}:{n}" for k, n in ssd_bwd.items()),
            ssd_plain_calls=len(plain_calls))
    finite = all(map(math.isfinite, res.losses + res.grad_norms))
    say(tag, part="summary", arch=cfg.name, layers=L,
        d_model=cfg.d_model, heads=cfg.n_heads,
        head_dims=pair_key((D, Dv)) if n_attn else "none",
        params=n_params, batch=batch, seq=TRAIN_SEQ,
        steps=steps, lr=run.learning_rate, remat=run.remat,
        params_dtype=run.params_dtype, master="float32",
        first_loss=repr(res.losses[0]), last_loss=repr(res.losses[-1]),
        **{f"median_step_ms_3_to_{steps}": f"{med:.2f}"},
        tokens_per_s=f"{tokens / med * 1e3:.1f}",
        model_flops_per_step=flops,
        model_flops_share_of_bf16_peak=f"{flops / (med / 1e3) / BF16_FLOPS_PER_S:.4f}",
        peak_mem_gib=f"{peak:.2f}",
        flash_fwd_launches=",".join(f"{k}:{n}" for k, n in fwd.items()),
        flash_bwd_launches=",".join(f"{k}:{n}" for k, n in bwd.items()),
        fwd_bwd_launches_by_head_dims=",".join(
            f"{k}:{a}+{b}" for k, (a, b) in pairs_run.items()) or "none",
        **ssd_extra, wall_s=f"{res.wall_s:.2f}", finite=finite)
    if not finite or not res.losses[-1] < res.losses[0]:
        fail(f"training did not lower a finite loss: {res.losses}")
    if fwd != want_fwd or bwd != want_bwd or pairs_run != want_pairs:
        fail(f"training launched flash {fwd} and its backward {bwd} at "
             f"{pairs_run}, expected {want_fwd} and {want_bwd} at "
             f"{want_pairs}")
    if ssd_fwd != want_ssd_fwd or ssd_bwd != want_ssd_bwd or plain_calls:
        fail(f"training launched the SSD kernels {ssd_fwd} and {ssd_bwd} "
             f"and the plain versions {len(plain_calls)} times, expected "
             f"{want_ssd_fwd}, {want_ssd_bwd} and none")
    return (sum(fwd.values()), sum(bwd.values()), bwd,
            {"fwd": ssd_fwd, "bwd": ssd_bwd})


def train_split(cfg, run, ssd_bwd_args: list | None = None,
                batch: int = TRAIN_BATCH) -> dict:
    """One training step split by CUDA events: forward (flash forward
    kernel ms apart, and the SSD forward kernel's where the model has SSD
    layers), backward (the backward kernels' ms apart), clip and AdamW;
    the q/k/v and output gradients of the first and last layers'
    attention captured on the way, and into ``ssd_bwd_args`` the SSD
    backward kernel's arguments in layer 0 (the step's last SSD
    backward)."""
    import torch

    import repro_torch.kernels.flash_attention.ops as flash_ops
    import repro_torch.kernels.ssd.ops as ssd_ops
    import repro_torch.models.attention as attention
    from repro_torch.models import loss_fn, model_init
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train import (
        adamw_update, cast_params, clip_by_global_norm, cosine_lr,
        init_state, synthetic_batch,
    )

    f32_run = dataclasses.replace(run, activations_dtype="float32")
    state = init_state(model_init(0, cfg, f32_run, device="cuda")[0])
    tokens = synthetic_batch(cfg, batch, TRAIN_SEQ, 0, 0, device="cuda")
    layers, captured = (0, cfg.n_layers - 1), {}
    spans = {"fwd": [], "bwd": [], "ssd_fwd": [], "ssd_bwd": []}
    attn_fn = attention.flash_attention

    def capture(q, k, v, **kw):
        i = len(captured.setdefault("calls", []))
        captured["calls"].append(i)
        out = attn_fn(q, k, v, **kw)
        if i in layers:
            captured[i] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(lambda g, i=i: captured[i].__setitem__(3, g))
        return out

    def evented(name, fn):
        def run_(*a, **kw):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            out = fn(*a, **kw)
            e[1].record()
            spans[name].append(e)
            return out
        return run_

    ssd_bwd = evented("ssd_bwd", ssd_ops.ssd_intra_chunk_bwd_cuda)

    def ssd_bwd_kept(*a):
        if ssd_bwd_args is not None:
            ssd_bwd_args[:] = a
        return ssd_bwd(*a)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with patched((attention, "flash_attention", capture),
                 (flash_ops, "flash_attention_cuda",
                  evented("fwd", flash_ops.flash_attention_cuda)),
                 (flash_ops, "flash_attention_bwd_cuda",
                  evented("bwd", flash_ops.flash_attention_bwd_cuda)),
                 (ssd_ops, "ssd_intra_chunk_cuda",
                  evented("ssd_fwd", ssd_ops.ssd_intra_chunk_cuda)),
                 (ssd_ops, "ssd_intra_chunk_bwd_cuda", ssd_bwd_kept)):
        torch.cuda.synchronize()
        alias = tree_map(lambda t: t.detach().requires_grad_(True),
                         state.params)
        ev[0].record()
        with torch.enable_grad():
            loss, _ = loss_fn(cast_params(alias, getattr(torch, run.params_dtype)),
                              tokens, cfg, run)
        ev[1].record()
        leaves = tree_leaves(alias)
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        it = iter(grads)
        grads = tree_map(lambda _: next(it), alias)
        grads, gnorm = clip_by_global_norm(grads)
        ev[3].record()
        adamw_update(state, grads, run, cosine_lr(run, warmup=2,
                                                  total=TRAIN_STEPS))
        ev[4].record()
        torch.cuda.synchronize()
    span = lambda a, b: ev[a].elapsed_time(ev[b])
    sums = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    ssd = {} if not spans["ssd_fwd"] else dict(
        ssd_fwd_ms=f"{sums['ssd_fwd']:.2f}",
        ssd_fwd_calls=len(spans["ssd_fwd"]),
        ssd_bwd_ms=f"{sums['ssd_bwd']:.2f}",
        ssd_bwd_calls=len(spans["ssd_bwd"]))
    say("train_split", arch=cfg.name, batch=batch, seq=TRAIN_SEQ,
        step_ms=f"{span(0, 4):.2f}", forward_ms=f"{span(0, 1):.2f}",
        flash_fwd_ms=f"{sums['fwd']:.2f}", flash_fwd_calls=len(spans["fwd"]),
        backward_ms=f"{span(1, 2):.2f}", flash_bwd_ms=f"{sums['bwd']:.2f}",
        flash_bwd_calls=len(spans["bwd"]), **ssd, clip_ms=f"{span(2, 3):.2f}",
        adamw_ms=f"{span(3, 4):.2f}", loss=repr(float(loss.detach())),
        grad_norm=repr(float(gnorm)))
    del state, alias, grads, leaves, loss
    torch.cuda.empty_cache()
    if any(captured.get(i, [None])[-1] is None for i in layers):
        fail("no output gradient captured for the first and last layers")
    return {i: captured[i] for i in layers}


def train_vs_plain(cfg, run, layers: int = TRAIN_PLAIN_LAYERS,
                   seq: int = TRAIN_SEQ) -> None:
    """The first ``layers`` layers at full width in f32 (one sequence of
    ``seq``): loss and every gradient leaf on the kernel path against the
    plain path."""
    import torch

    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.kernels.ssd import KERNEL_BWD as SSD_BWD
    from repro_torch.models import loss_fn, model_init, value_and_grad
    from repro_torch.models.layers import tree_flatten
    from repro_torch.train import synthetic_batch

    cfg2 = cut_depth(cfg, ((cfg.layout[0][0], layers),))
    n_attn, n_ssd = layer_counts(cfg2)
    run32 = dataclasses.replace(run, params_dtype="float32",
                                activations_dtype="float32")
    params, _ = model_init(0, cfg2, run32, device="cuda")
    batch = synthetic_batch(cfg2, 1, seq, 0, 0, device="cuda")
    paths = {}
    for name in ("kernel", "plain"):
        with contextlib.ExitStack() as stack:
            if name == "plain":
                stack.enter_context(plain_path())
            before = (FLASH_KERNEL.launches, BWD_KERNEL.launches,
                      SSD_KERNEL.launches, SSD_BWD.launches)
            (loss, _), grads = value_and_grad(
                lambda p: loss_fn(p, batch, cfg2, run32), params)
            torch.cuda.synchronize()
            n = tuple(k.launches - b for k, b in zip(
                (FLASH_KERNEL, BWD_KERNEL, SSD_KERNEL, SSD_BWD), before))
        want = ((n_attn,) * 2 + (n_ssd,) * 2 if name == "kernel"
                else (0,) * 4)
        if n != want:
            fail(f"the {name} path launched flash forward/backward and SSD "
                 f"forward/backward {n}, expected {want}")
        paths[name] = (float(loss), tree_flatten(grads))
    (lk, gk), (lp, gp) = paths["kernel"], paths["plain"]
    worst, worst_leaf = 0.0, ""
    for (name, a), (_, b) in zip(gk, gp):
        r = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if r >= worst:
            worst, worst_leaf = r, name
    rel = abs(lk - lp) / abs(lp)
    say("train_vs_plain", arch=cfg.name, layers=cfg2.n_layers, batch=1,
        seq=seq, activations="float32", params_dtype="float32",
        loss_kernel=repr(lk), loss_plain=repr(lp), loss_rel_diff=f"{rel:.3g}",
        loss_bound="1e-5", leaves=len(gk), worst_grad_ratio=f"{worst:.3g}",
        worst_leaf=worst_leaf, grad_bound="1e-3 x max|.| per leaf")
    if not (rel <= 1e-5 and worst <= 1e-3):
        fail(f"{cfg.name} f32 training: kernel path vs plain path loss "
             f"{rel}, worst gradient leaf {worst_leaf} {worst}")
    del params, paths
    torch.cuda.empty_cache()


def train_checkpoints() -> None:
    """``CKPT_ARCH`` at full width: ``CKPT_STEPS`` steps through ``train``
    with a save at step ``CKPT_AT``; the run resumed from a copy of that
    checkpoint beside the continuous run's steps; a state saved after
    ``CKPT_AT`` steps of ``build_train_step`` and restored, bit for bit.
    The directory is in the checkout's ``build/`` and removed after."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import latest_step, restore, save
    from repro_torch.configs import ARCHS
    from repro_torch.models import model_init
    from repro_torch.train import (
        LoopConfig, build_train_step, cosine_lr, init_state, synthetic_batch,
        train,
    )

    cfg = ARCHS[CKPT_ARCH]
    run = dataclasses.replace(train_run_config(),
                              attn_chunk_q=min(512, CKPT_SEQ),
                              attn_chunk_k=min(1024, CKPT_SEQ))
    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    try:
        loop = dict(steps=CKPT_STEPS, batch=CKPT_BATCH, seq=CKPT_SEQ,
                    ckpt_every=CKPT_AT, log_every=0)
        cont = train(cfg, run, LoopConfig(ckpt_dir=str(base / "a"), **loop))
        step_dir = f"step_{CKPT_AT:08d}"
        shutil.copytree(base / "a" / step_dir, base / "b" / step_dir)
        resumed = train(cfg, run, LoopConfig(ckpt_dir=str(base / "b"), **loop))
        if resumed.resumed_from != CKPT_AT or latest_step(base / "b") != CKPT_STEPS:
            fail(f"resume from step {CKPT_AT}: resumed_from="
                 f"{resumed.resumed_from}, latest {latest_step(base / 'b')}")
        for i, (a, b) in enumerate(zip(cont.losses[CKPT_AT:], resumed.losses)):
            say("train_ckpt", arch=cfg.name, step=CKPT_AT + i + 1,
                continuous_loss=repr(a), resumed_loss=repr(b),
                equal=a == b, abs_diff=f"{abs(a - b):.3g}")
        # a state saved and restored, bit for bit
        f32_run = dataclasses.replace(run, activations_dtype="float32")
        state = init_state(model_init(0, cfg, f32_run, device="cuda")[0])
        step_fn = build_train_step(cfg, run, lr_fn=cosine_lr(
            run, warmup=max(2, CKPT_STEPS // 20), total=CKPT_STEPS))
        for s in range(CKPT_AT):
            state, _ = step_fn(state, synthetic_batch(
                cfg, CKPT_BATCH, CKPT_SEQ, 0, s, device="cuda"))
        save(base / "c", CKPT_AT, state)
        back = restore(base / "c", CKPT_AT, state)
        loop_ckpt = restore(base / "a", CKPT_AT, state)
        same = all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
                   zip(tree_leaves_state(state), tree_leaves_state(back)))
        same_loop = all(torch.equal(a, b) for a, b in zip(
            tree_leaves_state(state), tree_leaves_state(loop_ckpt)))
        say("train_ckpt", part="round_trip", arch=cfg.name, step=CKPT_AT,
            leaves=len(tree_leaves_state(state)), restored_equal=same,
            equal_to_loop_checkpoint=same_loop,
            resumed_from=resumed.resumed_from)
        if not same:
            fail("a restored checkpoint differs from the state saved")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()


def named_state_leaves(state) -> list:
    """``(name, tensor)`` of a ``TrainState``, named as ``ckpt`` names its
    leaves (``.step``, ``.params/g0/...``)."""
    from repro_torch.models.layers import tree_flatten

    return [(".step", state.step)] + [
        (f".{field}/{k}", t) for field in ("params", "m", "v")
        for k, t in tree_flatten(getattr(state, field))]


def tree_leaves_state(state) -> list:
    """Every tensor of a ``TrainState``: the step, then the parameters and
    moments in the checkpoint's leaf order."""
    return [t for _, t in named_state_leaves(state)]


def bwd_edge_cases(errs: list) -> None:
    """``BWD_EDGE_CASES`` on seeded inputs, bf16 and f32 (``check_bwd``);
    their largest errors go into ``errs``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    for label, B, Sq, Sk, H, KH, D, Dv, window, q_off in BWD_EDGE_CASES:
        q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                         for shape in ((B, Sq, H, D), (B, Sk, KH, D),
                                       (B, Sk, KH, Dv), (B, Sq, H, Dv)))
        for dtype in (torch.bfloat16, torch.float32):
            errs.append(check_bwd(label, q, k, v, dout, window, q_off,
                                  dtype)["err"])


def train_child() -> None:
    """``--train``: stablelm-1.6b trained at full width and depth on the
    card, in a process of its own. Prints ``[kernel_time]``, ``[train]``,
    ``[train_split]``, ``[train_vs_plain]``, ``[kernel_vs_plain]
    kernel=flash_attention_bwd`` (its layers and ``BWD_EDGE_CASES``) and
    ``[train_ckpt]`` lines, then one JSON line for the kernels line."""
    import torch

    from repro_torch.configs import ARCHS

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the f32 comparison needs f32 products")
    timing = bwd_kernel_time("stablelm", TRAIN_BATCH, TRAIN_SEQ, 32, 32, 64,
                             64)
    cfg, run = ARCHS[TRAIN_ARCH], train_run_config()
    fwd, bwd, bwd_by_variant, _ = train_main(cfg, run)
    captured = train_split(cfg, run)
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for layer, (q, k, v, dout) in captured.items():
            errs.append(check_bwd(f"stablelm_l{layer}", q, k, v, dout, None,
                                  0, dtype)["err"])
    del captured
    torch.cuda.empty_cache()
    bwd_edge_cases(errs)
    train_vs_plain(cfg, run)
    train_checkpoints()
    print(json.dumps({"fwd_launches": fwd, "bwd_launches": bwd,
                      "bwd_launches_by_variant": bwd_by_variant,
                      "head_dims": pair_key(attn_head_dims(cfg)),
                      "max_abs_err": max(errs), "timing": timing}),
          flush=True)


def train_mla_child() -> None:
    """``--train-mla``: deepseek-v2-236b at full width, cut to its dense
    first layer (``MLA_TRAIN_LAYOUT``), trained on the card in a process of
    its own: the backward kernels timed at its shape (B = TRAIN_BATCH, S =
    TRAIN_SEQ, 128 heads, q/k 192, v 128), ``MLA_TRAIN_STEPS`` steps of
    ``train`` (every flash launch, forward and backward, at the pair (192,
    128)), one step split, and the backward kernels against their plain
    version on layer 0's captured q, k, v and output gradient, the plain
    version in groups of ``MLA_BWD_HEAD_GROUP`` KV heads, and the layer in
    f32 on the kernel path against the plain path (``MLA_PLAIN_SEQ``
    tokens). Prints ``[kernel_time]``, ``[train_mla]``, ``[train_split]``,
    ``[kernel_vs_plain] kernel=flash_attention_bwd`` and
    ``[train_vs_plain]`` lines, then one JSON line for the kernels line."""
    import torch

    from repro_torch.configs import ARCHS

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the f32 comparison needs f32 products")
    cfg = cut_depth(ARCHS[MLA_ARCH], MLA_TRAIN_LAYOUT)
    run = dataclasses.replace(train_run_config(), learning_rate=MLA_TRAIN_LR)
    D, Dv = attn_head_dims(cfg)
    timing = bwd_kernel_time("mla", TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                             cfg.n_heads, D, Dv, group=MLA_BWD_HEAD_GROUP)
    torch.cuda.empty_cache()
    fwd, bwd, bwd_by_variant, _ = train_main(cfg, run, "train_mla",
                                             MLA_TRAIN_STEPS)
    torch.cuda.empty_cache()
    captured = train_split(cfg, run)
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for layer, (q, k, v, dout) in captured.items():
            if (q.shape[-1], v.shape[-1]) != (D, Dv):
                fail(f"layer {layer}: head dims {q.shape[-1]}, "
                     f"{v.shape[-1]}, expected {D}, {Dv}")
            errs.append(check_bwd(f"deepseek_l{layer}", q, k, v, dout, None,
                                  0, dtype, group=MLA_BWD_HEAD_GROUP)["err"])
    del captured
    torch.cuda.empty_cache()
    train_vs_plain(cfg, run, layers=1, seq=MLA_PLAIN_SEQ)
    print(json.dumps({"fwd_launches": fwd, "bwd_launches": bwd,
                      "bwd_launches_by_variant": bwd_by_variant,
                      "head_dims": pair_key((D, Dv)),
                      "max_abs_err": max(errs), "timing": timing}),
          flush=True)


def ssd_bwd_bound_ms(x, Bm, L) -> tuple[float, str, int, int]:
    """Least time the card could take for one intra-chunk backward (the
    kernels' own work): the larger of x, B and C (in their type, B and C
    once per group), dt, A, cum, dy, dsc, ddec and dcum read once and the
    function's outputs dx, ddt, dA and the per-group dB and dC (f32)
    written once over HBM bandwidth, and the operations of each real chunk
    (length l <= L: 2 N
    and 2 P a causal pair to recompute C.B and dy.x, 2 P for dx and 2 N
    each for dB and dC; 4 N P a step for the state's terms) over the f32
    rate of the CUDA cores, where the kernels compute."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = -(-S // L)
    es = x.element_size()
    f32_in = (B_ * S * H + H + 2 * B_ * nc * L * H + B_ * nc * L * H * P
              + B_ * nc * H * N * P + B_ * nc * H)
    f32_out = B_ * S * H * P + B_ * S * H + H + 2 * B_ * S * G * N
    nbytes = (B_ * S * H * P + 2 * B_ * S * G * N) * es + 4 * (f32_in
                                                              + f32_out)
    ops = 0
    for c in range(nc):
        ln = min(L, S - c * L)
        ops += ln * (ln + 1) // 2 * (4 * P + 6 * N) + 4 * N * P * ln
    ops *= B_ * H
    return roofline(nbytes, ops, F32_FLOPS_PER_S)


def check_ssd_bwd(label, args, dtype) -> dict:
    """The SSD backward kernels against their plain version on the card:
    ``args`` as ``SsdIntraChunk`` hands them to the backward (x, dt, A, Bm,
    Cm, cum, dy, dsc, ddec, dcum, chunk), x, Bm and Cm cast to ``dtype``;
    each gradient within ``SSD_BWD_RTOL`` x its largest |.|, finite, and a
    second call bit-equal."""
    import torch

    from repro_torch.kernels.ssd import (
        ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_bwd_ref,
    )
    from repro_torch.kernels.ssd.ssd import BWD_VARIANTS

    x, dt, A, Bm, Cm, *rest = (t.detach() if isinstance(t, torch.Tensor)
                               else t for t in args)
    a = (x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), *rest)
    x, Bm, L = a[0], a[3], a[-1]
    with torch.no_grad():
        got, k_ms = median_ms(lambda: ssd_intra_chunk_bwd_cuda(*a))
        again = ssd_intra_chunk_bwd_cuda(*a)
        want, p_ms = median_ms(lambda: ssd_intra_chunk_bwd_ref(*a))
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    rel = [e / max(m, 1e-30) for e, m in zip(errs, scales)]
    repeat_equal = all(torch.equal(g, h) for g, h in zip(got, again))
    finite = all(bool(g.isfinite().all()) for g in got)
    S = x.shape[1]
    say("kernel_vs_plain", kernel="ssd_intra_chunk_bwd", case=label,
        dtype=str(dtype).removeprefix("torch."), variant=BWD_VARIANTS[dtype],
        x=tuple(x.shape), B=tuple(Bm.shape), chunk=L,
        last_chunk_steps=S - (-(-S // L) - 1) * L,
        max_abs_err_dx_ddt_dA_dB_dC=",".join(f"{e:.3g}" for e in errs),
        max_abs_dx_ddt_dA_dB_dC=",".join(f"{m:.3g}" for m in scales),
        max_err_over_max=",".join(f"{r:.3g}" for r in rel),
        bound=f"abs<={SSD_BWD_RTOL}*max", repeat_equal=repeat_equal,
        finite=finite, kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}")
    if not (max(rel) <= SSD_BWD_RTOL and finite and repeat_equal):
        fail(f"ssd_intra_chunk_bwd != plain on {label} {dtype}: errors over "
             f"max {rel}, finite {finite}, repeat {repeat_equal}")
    return dict(err=max(errs), ms=k_ms, plain_ms=p_ms)


def ssd_bwd_inputs(g, B, S, H, G, N, P, L, dtype):
    """Seeded inputs of the backward as the forward kernel makes them: x,
    B, C in ``dtype``; dt = softplus(z - 4) (~0.02, near the models' init
    of 0.01) and A = -(1 .. 16) (the models' init), so that a chunk's decay
    spans ~0.1 to ~80; the cotangents of y, sc, dec and cum standard
    normal."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda

    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = randn(B, S, H, P).to(dtype)
    dt = F.softplus(randn(B, S, H) - 4.0)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm, Cm = (randn(B, S, G, N).to(dtype) for _ in range(2))
    outs = ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, L)
    return (x, dt, A, Bm, Cm, outs[3], *(randn(*t.shape) for t in outs), L)


def ssd_bwd_kernel_time(case, B, S, H, G, N, P, L) -> dict:
    """The SSD backward at a training shape on seeded bf16 inputs
    (``ssd_bwd_inputs``): alone from the profiler (its two kernels, in a
    trace after a warm-up step), through the wrapper (CUDA events, median
    of 3), the plain version, the forward kernel beside it and the bound;
    then held against the plain version on these inputs in bf16 and, cast,
    in f32 (``check_ssd_bwd``). No single PyTorch call computes it: no
    library yardstick."""
    import torch

    from repro_torch.kernels.ssd import (
        ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda,
    )
    from repro_torch.kernels.ssd.ssd import BWD_VARIANTS

    g = torch.Generator(device="cuda").manual_seed(0)
    a = ssd_bwd_inputs(g, B, S, H, G, N, P, L, torch.bfloat16)
    fn = lambda: ssd_intra_chunk_bwd_cuda(*a)
    alone, kernels, discarded = profiled_ms(fn, "ssd_bwd", kernels=2)
    if alone is None:
        fail(f"no trace held the two SSD backward kernels ({case})")
    split = kernel_split_ms(fn, "ssd_bwd")
    runs = [timed(fn)[1] for _ in range(3)]
    ms = sorted(runs)[1]
    checks = [check_ssd_bwd(f"{case}_seeded", a, dtype)
              for dtype in (torch.bfloat16, torch.float32)]
    p_ms = checks[0]["plain_ms"]
    _, f_ms = median_ms(lambda: ssd_intra_chunk_cuda(*a[:5], L))
    b_ms, b_by, nbytes, ops = ssd_bwd_bound_ms(a[0], a[3], L)
    say("kernel_time", kernel="ssd_intra_chunk_bwd", case=case,
        dtype="bfloat16", variant=BWD_VARIANTS[torch.bfloat16],
        x=(B, S, H, P), B=(B, S, G, N), chunk=L, ms=f"{ms:.4f}",
        ms_runs=",".join(f"{t:.4f}" for t in runs),
        kernel_alone_ms=f"{alone:.4f}", kernels_per_call=kernels,
        discarded_traces=discarded,
        kernels_ms=",".join(f"{k}:{t:.4f}" for k, t in split.items())
        or "not measured",
        plain_ms=f"{p_ms:.4f}", forward_kernel_ms=f"{f_ms:.4f}",
        library="none", bound_ms=f"{b_ms:.5f}", bound_by=b_by,
        bytes=nbytes, ops=ops, times_bound=f"{ms / b_ms:.2f}",
        alone_times_bound=f"{alone / b_ms:.2f}",
        achieved_f32_tflops=f"{ops / alone / 1e9:.2f}")
    return dict(ms=ms, alone_ms=alone, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, err=max(c["err"] for c in checks))


def ssd_bwd_edge_cases(errs: list) -> None:
    """``SSD_EDGE_CASES`` under grad: ``ssd_scan_kernel`` on the card (the
    ``SsdIntraChunk`` path: the forward and backward kernels) with seeded
    cotangents on y and h_last, and the backward kernel's arguments as the
    Function handed them held against the plain version
    (``check_ssd_bwd``), bf16 and f32; then ``SSD_BWD_SHORT_CASES``
    directly. Their largest errors go into ``errs``."""
    import torch
    import torch.nn.functional as F

    import repro_torch.kernels.ssd.ops as ssd_ops
    from repro_torch.kernels.ssd import ssd_scan_kernel

    g = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    for lab, B_, S_, H_, G_, N_, P_, L_ in SSD_EDGE_CASES:
        base = (randn(B_, S_, H_, P_), F.softplus(randn(B_, S_, H_) - 2.0),
                -torch.exp(randn(H_)), randn(B_, S_, G_, N_),
                randn(B_, S_, G_, N_))
        dy, dh = randn(B_, S_, H_, P_), randn(B_, H_, N_, P_)
        for dtype in (torch.bfloat16, torch.float32):
            leaves = [t.to(dtype if i in (0, 3, 4) else torch.float32)
                      .requires_grad_(True) for i, t in enumerate(base)]
            calls = []

            def kept(*a, calls=calls, real=ssd_ops.ssd_intra_chunk_bwd_cuda):
                calls.append(a)
                return real(*a)

            with patched((ssd_ops, "ssd_intra_chunk_bwd_cuda", kept)):
                y, h = ssd_scan_kernel(*leaves, chunk=L_, device="cuda")
                torch.autograd.backward((y, h), (dy, dh))
            if len(calls) != 1 or not all(
                    bool(t.grad.isfinite().all()) for t in leaves):
                fail(f"{lab} {dtype}: {len(calls)} SSD backward launches "
                     "under grad, or a gradient not finite")
            errs.append(check_ssd_bwd(lab, calls[0], dtype)["err"])
    for lab, B_, S_, H_, G_, N_, P_, L_ in SSD_BWD_SHORT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            a = ssd_bwd_inputs(g, B_, S_, H_, G_, N_, P_, L_, dtype)
            errs.append(check_ssd_bwd(lab, a, dtype)["err"])


def train_ssd_child() -> None:
    """``--train-ssd``: the SSD configurations trained at full width and
    depth on the card, in a process of their own. The backward kernel timed
    at hymba's and mamba2's shapes and held against its plain version there
    (bf16 and f32); ``hymba-1.5b`` for ``SSD_TRAIN_STEPS``
    steps of ``train_run_config()`` (remat "none"), one step split (its
    layer 0's SSD backward arguments captured), the backward kernel
    against its plain version on that layer (bf16 and f32) and on the edge
    cases under grad, its first two layers in f32 against the plain path;
    ``mamba2-1.3b`` for ``MAMBA_TRAIN_STEPS`` steps under remat "block".
    Prints ``[kernel_time]``, ``[train_ssd]``, ``[train_split]``,
    ``[kernel_vs_plain] kernel=ssd_intra_chunk_bwd`` and
    ``[train_vs_plain]`` lines, then one JSON line for the kernels line."""
    import torch

    from repro_torch.configs import ARCHS

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the f32 comparison needs f32 products")
    timing = {case: ssd_bwd_kernel_time(case, *shape)
              for case, *shape in SSD_BWD_SHAPES}
    errs = [t["err"] for t in timing.values()]
    torch.cuda.empty_cache()
    fwd, bwd, ssd = {}, {}, {}
    cfg, run = ARCHS[SSD_TRAIN_ARCH], train_run_config()
    fwd[cfg.name], bwd[cfg.name], _, ssd[cfg.name] = train_main(
        cfg, run, "train_ssd", SSD_TRAIN_STEPS, SSD_TRAIN_BATCH)
    torch.cuda.empty_cache()
    layer0 = []
    train_split(cfg, run, layer0, SSD_TRAIN_BATCH)
    for dtype in (torch.bfloat16, torch.float32):
        errs.append(check_ssd_bwd("hymba_l0", layer0, dtype)["err"])
    del layer0
    torch.cuda.empty_cache()
    ssd_bwd_edge_cases(errs)
    train_vs_plain(cfg, run)
    cfg = ARCHS[MAMBA_TRAIN_ARCH]
    run = dataclasses.replace(train_run_config(), remat="block")
    fwd[cfg.name], bwd[cfg.name], _, ssd[cfg.name] = train_main(
        cfg, run, "train_ssd", MAMBA_TRAIN_STEPS)
    sum_by = lambda part: {k: sum(c[part][k] for c in ssd.values())
                           for k in next(iter(ssd.values()))[part]}
    print(json.dumps({"fwd_launches": fwd, "bwd_launches": bwd,
                      "ssd_fwd_by_variant": sum_by("fwd"),
                      "ssd_bwd_by_variant": sum_by("bwd"),
                      "head_dims": pair_key(attn_head_dims(ARCHS[
                          SSD_TRAIN_ARCH])),
                      "max_abs_err": max(errs), "timing": timing}),
          flush=True)


def phase_train_ssd_child(entries: list) -> None:
    """The ``--train-ssd`` child: hymba's flash launches join the flash
    entries of the kernels line, the SSD forward launches the SSD entry's,
    and the SSD backward gets its own entry."""
    res = run_child("--train-ssd")
    flash = next(e for e in entries if e["name"] == "flash_attention")
    fbwd = next(e for e in entries if e["name"] == "flash_attention_bwd")
    hymba = SSD_TRAIN_ARCH
    add_launches(flash, res["head_dims"], res["fwd_launches"][hymba])
    add_launches(fbwd, res["head_dims"], res["bwd_launches"][hymba],
                 "wgmma_bf16")
    ssd = next(e for e in entries if e["name"] == "ssd_intra_chunk")
    ssd["launches"] += sum(res["ssd_fwd_by_variant"].values())
    t = res["timing"]["hymba"]
    entries.append({
        "name": "ssd_intra_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_bwd.cu",
        "replaces": "src/repro/models/ssm.py:25",
        "launches": sum(res["ssd_bwd_by_variant"].values()),
        "launches_by_variant": res["ssd_bwd_by_variant"],
        "max_abs_err": res["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    })


def phase_train_child(entries: list) -> None:
    """The ``--train`` child; its forward launches join flash attention's
    entry of the kernels line, and the backward kernel gets its own."""
    res = run_child("--train")
    flash = next(e for e in entries if e["name"] == "flash_attention")
    by_dim = flash["launches_by_head_dim_pair"]
    d = res["head_dims"]
    by_dim[d] = by_dim.get(d, 0) + res["fwd_launches"]
    flash["launches"] += res["fwd_launches"]
    t = res["timing"]
    entries.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/models/attention.py:134",
        "launches": res["bwd_launches"],
        "launches_by_route": res["bwd_launches_by_variant"],
        "launches_by_head_dim_pair": {d: res["bwd_launches"]},
        "max_abs_err": res["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })


def add_launches(entry: dict, key: str, n: int, route: str | None = None
                 ) -> None:
    """Add ``n`` launches at the head-dim pair ``key`` (and, for the
    backward, on ``route``) to a kernels-line entry."""
    entry["launches"] += n
    by_dim = entry["launches_by_head_dim_pair"]
    by_dim[key] = by_dim.get(key, 0) + n
    if route is not None:
        by_route = entry["launches_by_route"]
        by_route[route] = by_route.get(route, 0) + n


def phase_train_mla_child(entries: list) -> None:
    """The ``--train-mla`` child; its forward and backward launches join
    the kernels line's flash entries, its errors the backward's."""
    res = run_child("--train-mla")
    flash = next(e for e in entries if e["name"] == "flash_attention")
    bwd = next(e for e in entries if e["name"] == "flash_attention_bwd")
    add_launches(flash, res["head_dims"], res["fwd_launches"])
    for route, n in res["bwd_launches_by_variant"].items():
        add_launches(bwd, res["head_dims"], n, route)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], res["max_abs_err"])


def popen_child(flag: str, go: Path | None = None) -> subprocess.Popen:
    """This script with ``flag`` in a child process; with ``go``, a warmed
    child that waits for that file (``warm_wait``)."""
    env = dict(os.environ)
    if go is not None:
        env["CHIP_SMOKE_GO"] = str(go)
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )


def warm(flag: str | None) -> None:
    """Start ``flag``'s child ahead of its phase (``WARM_NEXT``), waiting
    at its go file; killed at exit if never let go."""
    if flag is None or flag in _WARMED:
        return
    _WARMED.add(flag)
    go = ROOT / "build" / "go" / f"{flag.strip('-')}.{os.getpid()}"
    go.parent.mkdir(parents=True, exist_ok=True)
    go.unlink(missing_ok=True)
    _WARM[flag] = (popen_child(flag, go), go)
    atexit.register(stop_children, [_WARM[flag][0]])


def warm_wait(go: Path) -> None:
    """In a warmed child: make the CUDA context and import the port, then
    wait for the parent to create ``go``; exit if the parent is gone."""
    import torch

    torch.zeros(1, device="cuda")
    import repro_torch.models  # noqa: F401
    import repro_torch.noc  # noqa: F401
    import repro_torch.train  # noqa: F401

    parent = os.getppid()
    while not go.exists():
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.02)
    go.unlink(missing_ok=True)


def start_child(flag: str) -> subprocess.Popen:
    """Start this script with ``flag`` in a child process (let the warmed
    one go, if ``warm`` started it), and warm the child after it."""
    import torch

    torch.cuda.empty_cache()
    if flag in _WARM:
        proc, go = _WARM.pop(flag)
        go.touch()
    else:
        _WARMED.add(flag)
        proc = popen_child(flag)
    warm(WARM_NEXT.get(flag))
    return proc


def finish_child(proc: subprocess.Popen, flag: str,
                 timeout_s: float = SERVE_CHILD_TIMEOUT_S) -> dict:
    """Wait for a ``start_child`` child (killed at ``timeout_s``), print
    its lines and return its last line's JSON."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = stdout.strip().splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        print(line, flush=True)
    if proc.returncode != 0:
        fail(f"the child {flag} failed:\n{stderr[-3000:]}")
    return json.loads(lines[-1])


def run_child(flag: str, timeout_s: float = SERVE_CHILD_TIMEOUT_S) -> dict:
    """Run this script with ``flag`` in a child process, print its lines
    and return its last line's JSON."""
    return finish_child(start_child(flag), flag, timeout_s)


def phase_serve_child(flag: str, case: str, entries: list,
                      alone_ms: dict) -> None:
    """A serving child (``--serve-moe``, ``--serve-mla``,
    ``--serve-frames``); then, for a child that timed the flash kernel, its
    ``[kernel_time]`` (the wrapper, SDPA and the bound from the child, the
    kernel alone from ``--serve-kernel-alone``). The child's launches, by
    head-dim pair, and errors go into flash attention's entry of the
    kernels line."""
    res = run_child(flag)
    for dt_name, t in res["timing"].items():
        alone = alone_ms[f"flash_attention/{case}/{dt_name}"]
        if alone is None:
            fail(f"no device time for the {case} flash kernel ({dt_name})")
        extra = ({} if dt_name == "bfloat16" else dict(
            f32_core_bound_ms=f"{t['f32_core_bound_ms']:.5f}",
            alone_times_f32_core_bound=f"{alone / t['f32_core_bound_ms']:.2f}"))
        say("kernel_time", kernel="flash_attention", case=case,
            dtype=dt_name, shape=tuple(t["shape"]), dv=t["dv"],
            ms=f"{t['ms']:.4f}",
            kernel_alone_ms=f"{alone:.4f}",
            alone_times_bound=f"{alone / t['bound_ms']:.2f}",
            plain_ms=f"{t['plain_ms']:.4f}", sdpa_ms=f"{t['sdpa_ms']:.4f}",
            vs_sdpa=f"{t['ms'] / t['sdpa_ms']:.3f}",
            alone_vs_sdpa=f"{alone / t['sdpa_ms']:.3f}",
            bound_ms=f"{t['bound_ms']:.5f}", bound_by=t["bound_by"],
            bytes=t["bytes"], ops=t["ops"],
            times_bound=f"{t['ms'] / t['bound_ms']:.1f}", **extra)
    flash = next(e for e in entries if e["name"] == "flash_attention")
    by_dim = flash["launches_by_head_dim_pair"]
    for d, n in res["head_dim_launches"].items():
        by_dim[d] = by_dim.get(d, 0) + n
        flash["launches"] += n
    if res["max_abs_err"] is not None:
        flash["max_abs_err"] = max(flash["max_abs_err"], res["max_abs_err"])


# ---------------------------------------------------------------------------
# dist: executors, compressed all-reduce, expert parallelism, pipeline
# ---------------------------------------------------------------------------
def dist_plan() -> dict:
    """The dist phase's configurations at full width: moonshot cut to
    ``DIST_EP_LAYERS`` layers, stablelm-1.6b whole."""
    from repro_torch.configs import ARCHS

    return {"ep_cfg": cut_depth(ARCHS[MOE_ARCH],
                                (("attn_moe", DIST_EP_LAYERS),)),
            "pipe_cfg": ARCHS[TRAIN_ARCH], "B": DIST_EP_B, "S": DIST_EP_S,
            "pipe_m": DIST_PIPE_M, "pipe_seq": DIST_PIPE_SEQ,
            "compress_shape": DIST_COMPRESS_SHAPE,
            "zero1_cfg": cut_depth(ARCHS[TRAIN_ARCH],
                                   (("attn_dense", DIST_ZERO1_LAYERS),)),
            "zero1_dir": str(ROOT / "build" / "dist_zero1"),
            "moe_dp_cfg": cut_depth(ARCHS[MOE_ARCH],
                                    (("attn_moe", DIST_MOE_DP_LAYERS),)),
            "tp_dir": str(ROOT / "build" / "dist_tp"),
            "tp_seq": TRAIN_SEQ, "moe_dp_seq": DIST_MOE_DP_SEQ}


def dist_time(ax, fn, dev, reps: int = DIST_REPS) -> tuple:
    """(result, median over ``reps`` of the slowest rank's ms): every rank
    starts together, the card synchronised."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.dist.comm import all_reduce_sum

    times = []
    for _ in range(reps):
        dist.barrier(group=ax.group)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = torch.tensor([(time.perf_counter() - t0) * 1e3])
        # the slowest rank: a max as the sum of one-hot contributions
        every = all_reduce_sum(ax, torch.zeros(ax.n).index_fill_(
            0, torch.tensor([ax.me]), ms.item()))
        times.append(float(every.max()))
    return out, statistics.median(times)


def dist_all(ax, ok: bool) -> bool:
    """True on every rank when ``ok`` holds on every rank."""
    import torch

    from repro_torch.dist.comm import all_reduce_sum

    return int(all_reduce_sum(ax, torch.tensor([int(ok)]))) == ax.n


def dist_executors(mesh, dev, plan) -> None:
    """``part=executors``: the broadcast and all-to-all schedules on EP's
    own chunk, bit-equal to the expected permutation, timed beside the
    collective of the same group."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import (alltoall_schedule, apply_alltoall_schedule,
                                  apply_schedule, dp_broadcast_schedule,
                                  ring_alltoall_schedule,
                                  ring_broadcast_schedule)
    from repro_torch.dist.comm import Axis, all_to_all
    from repro_torch.models.moe import capacity

    ax = Axis(mesh, "model")
    n, me = ax.n, ax.me
    cfg = plan["ep_cfg"]
    m = cfg.moe
    cap = capacity(m, plan["B"] * plan["S"] // n)
    rows, d = m.n_experts // n * cap, cfg.d_model

    def chunk(src: int, dst: int):
        g = torch.Generator(device=dev).manual_seed(1000 * src + dst)
        return torch.randn((rows, d), generator=g,
                           device=dev).to(torch.bfloat16)

    def bits(t):
        return t.contiguous().view(torch.int16)

    chunks = torch.stack([chunk(me, j) for j in range(n)])
    want_a2a = torch.stack([chunk(i, me) for i in range(n)])
    own, want_b = chunk(me, me), chunk(0, 0)

    def host_broadcast():
        h = own.cpu() if ax.staged(own) else own.clone()
        dist.broadcast(h, src=ax.ranks[0], group=ax.group)
        return h.to(dev)

    base = {"broadcast": dist_time(ax, host_broadcast, dev),
            "alltoall": dist_time(ax, lambda: all_to_all(ax, chunks), dev)}
    for kind in ("broadcast", "alltoall"):
        if not dist_all(ax, torch.equal(
                bits(base[kind][0]),
                bits(want_b if kind == "broadcast" else want_a2a))):
            raise RuntimeError(f"the {kind} collective moved other bytes")
    for kind in ("broadcast", "alltoall"):
        for algo in DIST_ALGOS:
            if kind == "broadcast":
                sched = (ring_broadcast_schedule(n) if algo == "ring" else
                         dp_broadcast_schedule(n, algo, device=dev.type))
                got, ms = dist_time(
                    ax, lambda: apply_schedule(own, sched, mesh, "model"), dev)
                want = want_b
            else:
                sched = (ring_alltoall_schedule(n) if algo == "ring" else
                         alltoall_schedule(n, algo, device=dev.type))
                got, ms = dist_time(ax, lambda: apply_alltoall_schedule(
                    chunks, sched, mesh, "model"), dev)
                want = want_a2a
            equal = dist_all(ax, torch.equal(bits(got), bits(want)))
            if me == 0:
                say("dist", part="executors", schedule=kind, algo=algo,
                    ranks=n, rounds=sched.num_rounds,
                    transfers=sum(len(r) for r in sched.rounds),
                    chunk_shape=(rows, d), chunk_bytes=rows * d * 2,
                    bit_equal=equal, ms=f"{ms:.3f}",
                    collective=("broadcast" if kind == "broadcast"
                                else "all_to_all_single"),
                    collective_ms=f"{base[kind][1]:.3f}",
                    vs_collective=f"{ms / base[kind][1]:.2f}",
                    via="gloo_through_host" if ax.staged(own) else
                    dist.get_backend(ax.group))
            if not equal:
                raise RuntimeError(f"{kind} {algo}: a rank's result is not "
                                   "the expected permutation, bit for bit")


def dist_compress(mesh, dev, plan) -> None:
    """``part=compress``: ``compressed_psum`` of a gradient the size of
    stablelm-1.6b's embedding on every rank, against the exact sum."""
    import torch

    from repro_torch.dist import compressed_psum
    from repro_torch.dist.comm import Axis, all_gather, all_reduce_sum

    ax = Axis(mesh, "data")
    g = torch.randn(plan["compress_shape"], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        100 + ax.me))
    err = torch.zeros_like(g)
    (s, e), ms = dist_time(ax, lambda: compressed_psum(g, err, mesh, "data"),
                           dev, reps=2)
    exact, exact_ms = dist_time(ax, lambda: all_reduce_sum(ax, g), dev,
                                reps=2)
    rel = float((s - exact).abs().max() / exact.abs().max())
    # the sums' bits, strided: equal on every rank
    b = s.view(torch.int32)
    digest = torch.stack([b[k::7].sum(dtype=torch.int64) for k in range(7)])
    same = bool((all_gather(ax, digest) == digest).all())
    err_norm, g_norm = float(e.norm()), float(g.norm())
    del g, err, s, e, exact
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ax.me == 0:
        n = math.prod(plan["compress_shape"])
        say("dist", part="compress", shape=plan["compress_shape"],
            bytes_f32=4 * n, payload_bytes_int8=n + 4 * ax.n,
            ranks=ax.n, rel_err=f"{rel:.6f}", bound=DIST_COMPRESS_BOUND,
            identical_on_ranks=same, residual_norm=f"{err_norm:.4f}",
            grad_norm=f"{g_norm:.2f}", ms=f"{ms:.2f}",
            all_reduce_ms=f"{exact_ms:.2f}",
            via="gloo_through_host" if ax.staged(b) else "device")
    if not (same and rel < DIST_COMPRESS_BOUND):
        raise RuntimeError(f"compressed_psum: identical={same}, relative "
                           f"error {rel} (bound {DIST_COMPRESS_BOUND})")


def ep_slice_init(seed: int, cfg, run, dev, me: int, e_loc: int):
    """``model_init``'s draws, layer after layer, keeping this rank's
    ``e_loc`` experts of each MoE layer: the same values as the whole
    tree's, and no rank holds the whole tree."""
    import repro_torch.models.model as model_mod

    stack = model_mod.stack_init

    def sliced(init_fn, gen, n, cast=None):
        def draw(g):
            layer, specs = init_fn(g)
            f = layer["ffn"]
            for k in ("wi", "wg", "wo"):
                f[k] = f[k][me * e_loc:(me + 1) * e_loc].clone()
            return layer, specs

        return stack(draw, gen, n, cast)

    with patched((model_mod, "stack_init", sliced)):
        return model_mod.model_init(seed, cfg, run, device=dev)[0]


def keep_recorder(module, keeps: list):
    """``module.dispatch_indices`` that also records each call's kept
    pairs."""
    real = module.dispatch_indices

    def rec(ids, m, cap, before=None):
        slot, keep = real(ids, m, cap, before)
        keeps.append(keep)
        return slot, keep

    return patched((module, "dispatch_indices", rec))


def dist_ep(mesh, dev, plan, on_card: bool) -> dict:
    """``part=ep``: one f32 MoE layer of moonshot under EP against the
    dense path (nothing dropped), then bf16 prefills of the cut model with
    ``moe_impl="ep"`` under ``shardctx`` against dense prefills, at the
    config's capacity factor and at one that drops nothing."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import repro_torch.dist.ep as ep_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.dist import moe_apply_ep
    from repro_torch.dist.comm import Axis, all_gather, all_reduce_sum
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.models import RunConfig, count_params, model_init, prefill
    from repro_torch.models.moe import moe_apply_dense, moe_init
    from repro_torch.shardctx import clear_ctx, set_ctx

    ax = Axis(mesh, "model")
    me, n = ax.me, ax.n
    cfg = plan["ep_cfg"]
    m = cfg.moe
    e_loc = m.n_experts // n
    B, S, d = plan["B"], plan["S"], cfg.d_model
    no_drop = m.n_experts / m.top_k

    def with_cf(cf):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=cf))

    def empty():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- one f32 MoE layer, nothing dropped
    layer, _ = moe_init(torch.Generator(device=dev).manual_seed(7), cfg,
                        dev)
    p = {k: v[me * e_loc:(me + 1) * e_loc].clone()
         if k in ("wi", "wg", "wo") else v for k, v in layer.items()}
    del layer
    empty()
    x = torch.randn((B, S, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    routes = []
    with moe_route_recorder(routes, ep_mod):
        (y_ep, _), ep_ms = dist_time(
            ax, lambda: moe_apply_ep(p, x, with_cf(no_drop), mesh), dev,
            reps=1)
    ids_ep = all_gather(ax, routes[0][0]).reshape(B * S, m.top_k)
    del p
    empty()
    dist.barrier(group=ax.group)
    out = {}
    if me == 0:
        layer, _ = moe_init(torch.Generator(device=dev).manual_seed(7),
                            cfg, dev)
        routes_d = []
        with moe_route_recorder(routes_d):
            t0 = time.perf_counter()
            y_d, _ = moe_apply_dense(layer, x, with_cf(no_drop))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
        ids_d, gap_d = routes_d[0]
        flipped = (ids_d != ids_ep).any(-1)
        near = int((flipped & (gap_d < MOE_NEAR_TIE)).sum())
        err = float((y_ep - y_d).abs().max() / y_d.abs().max())
        say("dist", part="ep", case="f32_layer", shape=(B, S, d),
            experts=m.n_experts, experts_per_rank=e_loc, top_k=m.top_k,
            capacity_factor=f"{no_drop:.4f}", max_err_over_max=f"{err:.3e}",
            bound=DIST_EP_RTOL, routed_ids_differ=int(flipped.sum()),
            near_tie_exceptions=near, ep_ms=f"{ep_ms:.2f}",
            dense_ms=f"{dense_ms:.2f}")
        if err > DIST_EP_RTOL or int(flipped.sum()) != near:
            raise RuntimeError(f"EP f32 layer: error {err} (bound "
                               f"{DIST_EP_RTOL}), {int(flipped.sum())} tokens "
                               f"routed otherwise, {near} of them near ties")
        del layer, y_d
    del x, y_ep
    empty()
    dist.barrier(group=ax.group)

    # -- bf16 prefills of the cut model: EP under shardctx, then dense
    run = RunConfig(moe_impl="ep")
    params = ep_slice_init(0, cfg, run, dev, me, e_loc)
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(9))
    logits_ep, drops_ep, flash, ids_ep = {}, {}, {}, {}
    for cf in (m.capacity_factor, no_drop):
        keeps, routes = [], []
        reset_flash_counts()
        set_ctx(mesh)
        try:
            with keep_recorder(ep_mod, keeps), \
                    moe_route_recorder(routes, ep_mod):
                (lg, _), ms = dist_time(ax, lambda: prefill(
                    params, {"tokens": toks}, with_cf(cf), run), dev, reps=1)
        finally:
            clear_ctx()
        launches = torch.tensor([FLASH_KERNEL.variant_launches.get(v, 0)
                                 for v in ("wgmma_bf16", "cuda_core_f32")])
        flash[cf] = [int(v) for v in all_reduce_sum(ax, launches)]
        drops_ep[cf] = int(all_reduce_sum(ax, torch.tensor(
            [sum(int((~k).sum()) for k in keeps)])))
        ids_ep[cf] = [all_gather(ax, ids).reshape(B * S, m.top_k)
                      for ids, _ in routes]
        logits_ep[cf] = (lg, ms)
    n_rank = count_params(params)
    del params
    empty()
    dist.barrier(group=ax.group)
    if me == 0:
        dense_run = dataclasses.replace(run, moe_impl="dense")
        params, _ = model_init(0, cfg, run, device=dev)
        route = moe_mod.route

        def blocked_route(p, x, mc, tp=None):
            """The router on EP's row blocks, one a rank."""
            parts = [route(p, xb, mc, tp) for xb in x.chunk(n)]
            return (torch.cat([a for a, _, _ in parts]),
                    torch.cat([b for _, b, _ in parts]), parts[0][2])

        for cf in (m.capacity_factor, no_drop):
            keeps, routes_d = [], []
            with keep_recorder(moe_mod, keeps), moe_route_recorder(routes_d):
                t0 = time.perf_counter()
                want, _ = prefill(params, {"tokens": toks}, with_cf(cf),
                                  dense_run)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                dense_ms = (time.perf_counter() - t0) * 1e3
            with patched((moe_mod, "route", blocked_route)):
                control, _ = prefill(params, {"tokens": toks}, with_cf(cf),
                                     dense_run)
            got, ms = logits_ep[cf]
            finite = bool(torch.isfinite(got).all())
            scale = want.abs().max()
            ratio = float((got - want).abs().max() / scale)
            control_ratio = float((control - want).abs().max() / scale)
            equal_control = torch.equal(got, control)
            dropped = sum(int((~k).sum()) for k in keeps)
            differ = [int((ids_d != ids_e).any(-1).sum()) for (ids_d, _), ids_e
                      in zip(routes_d, ids_ep[cf])]
            flip0 = (routes_d[0][0] != ids_ep[cf][0]).any(-1)
            near0 = int((flip0 & (routes_d[0][1] < MOE_NEAR_TIE)).sum())
            say("dist", part="ep", case="bf16_prefill", arch=cfg.name,
                layers=f"{cfg.n_layers}_of_48", batch=B, seq=S,
                capacity_factor=f"{cf:.4f}", logit_ratio=f"{ratio:.5f}",
                control_ratio=f"{control_ratio:.5f}",
                equal_to_control=equal_control, finite=finite,
                tokens_routed_otherwise_by_layer=",".join(map(str, differ)),
                layer0_near_tie_exceptions=near0,
                dropped_pairs_ep=drops_ep[cf], dropped_pairs_dense=dropped,
                routed_pairs=cfg.n_layers * B * S * m.top_k,
                flash_launches_ep=f"wgmma_bf16:{flash[cf][0]},"
                                  f"cuda_core_f32:{flash[cf][1]}",
                ep_ms=f"{ms:.2f}", dense_ms=f"{dense_ms:.2f}",
                params_per_rank=n_rank, params_dense=count_params(params))
            # layer 0's MoE input is the same in both paths: its routing
            # may differ only where the top-k decision is a near tie
            # with nothing dropped EP computes the control's function: the
            # same products on the same rows, the router on the same blocks
            if (not finite or differ[0] != near0
                    or (cf == no_drop and not equal_control)):
                raise RuntimeError(
                    f"EP prefill at capacity factor {cf}: finite={finite}, "
                    f"layer 0 routes {differ[0]} tokens otherwise, {near0} "
                    f"of them near ties, equal to the control: "
                    f"{equal_control}")
            if on_card and flash[cf] != [n * cfg.n_layers, 0]:
                raise RuntimeError(f"EP prefill launched flash {flash[cf]}, "
                                   f"expected {n * cfg.n_layers} wgmma_bf16 "
                                   "and no f32 kernel")
        del params
        empty()
    dist.barrier(group=ax.group)
    out["flash_launches"] = sum(v[0] for v in flash.values())
    out["head_dim"] = cfg.head_dim
    return out


def dist_pipeline(mesh, dev, plan, on_card: bool) -> dict:
    """``part=pipeline``: stablelm-1.6b's layers in 4 stages through
    ``pipeline_apply`` (f32 masters, bf16 compute, a loss on the output),
    against the same layers applied microbatch by microbatch in one
    process on the same card."""
    import torch

    from repro_torch.dist import pipeline_apply
    from repro_torch.dist.comm import Axis, all_reduce_sum, exchange
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.models.blocks import block_apply, block_init
    from repro_torch.models.layers import (stack_init, tree_flatten,
                                           tree_map)
    from repro_torch.train.step import cast_params

    ax = Axis(mesh, "pipe")
    me, n = ax.me, ax.n
    cfg = plan["pipe_cfg"]
    L, M, seq = cfg.n_layers, plan["pipe_m"], plan["pipe_seq"]
    per = L // n
    run = train_run_config()
    def draw():
        return stack_init(lambda g: block_init("attn_dense", g, cfg, dev),
                          torch.Generator(device=dev).manual_seed(0), L)[0]

    # this rank's stage, f32 masters; the stage leaves pipeline_apply takes
    # are views of it (leading dim n, every index this stage: only this
    # rank's is read), so no rank keeps the other stages
    own = tree_map(lambda t: t.reshape(n, per, *t.shape[1:])[me].clone()
                   .requires_grad_(), draw())
    sp = tree_map(lambda t: t[None].expand(n, *t.shape), own)
    positions = torch.arange(seq, dtype=torch.int32, device=dev)[None]
    x = torch.randn((M, 1, seq, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(10)
                    ).to(torch.bfloat16)

    def layer_fn(lp, h):
        return block_apply("attn_dense", cast_params(lp, torch.bfloat16), h,
                           cfg, run, positions)[0]

    def step():
        y = pipeline_apply(layer_fn, sp, x, mesh, "pipe")
        (y.float() ** 2).mean(dim=(1, 2, 3)).sum().backward()
        return y.detach()

    step()  # each rank's first calls of every kernel and library
    tree_map(lambda t: setattr(t, "grad", None), own)
    reset_flash_counts()
    BWD_KERNEL.reset()
    y_pipe, step_ms = dist_time(ax, step, dev, reps=1)
    launches = all_reduce_sum(ax, torch.tensor([
        FLASH_KERNEL.variant_launches["wgmma_bf16"],
        FLASH_KERNEL.variant_launches["cuda_core_f32"],
        BWD_KERNEL.variant_launches["wgmma_bf16"],
        BWD_KERNEL.variant_launches["mma_bf16"],
        BWD_KERNEL.variant_launches["cuda_core_f32"]]))
    fwd, bwd = [int(v) for v in launches[:2]], [int(v) for v in launches[2:]]
    names = [k for k, _ in tree_flatten(own)]
    mine = {k: t.grad for k, t in tree_flatten(own)}
    del sp, own
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the sequential reference on rank 0; each rank gets its stage's slice
    want = {k: torch.empty_like(t) for k, t in mine.items()}
    out = {}
    if me == 0:
        params = tree_map(lambda t: t.requires_grad_(), draw())
        leaves = [t for _, t in tree_flatten(params)]
        grads = [torch.zeros_like(t) for t in leaves]
        outs = []
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for mb in range(M):
            parts = tree_map(lambda t: torch.unbind(t, 0), params)
            h = x[mb]
            for i in range(L):
                h = layer_fn(tree_map(lambda t: t[i], parts), h)
            outs.append(h.detach())
            for g, d in zip(grads, torch.autograd.grad(
                    (h.float() ** 2).mean(), leaves)):
                g += d
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        y_seq = torch.stack(outs)
        equal = torch.equal(y_pipe, y_seq)
        bit_diff = int((y_pipe.view(torch.int16)
                        != y_seq.view(torch.int16)).sum())
        neg_zero = int(((y_seq == 0) & torch.signbit(y_seq)).sum())
        full = dict(zip(names, grads))
        del params, leaves, outs
    else:
        full = None
    for k in names:
        if me == 0:
            src = full[k].reshape(n, per, *full[k].shape[1:])
            want[k] = src[0].clone()
            exchange(ax, [(r, src[r]) for r in range(1, n)], [])
        else:
            exchange(ax, [], [(0, want[k])])
    worst = max(float((mine[k] - want[k]).abs().max() / want[k].abs().max())
                for k in names)
    every = all_reduce_sum(ax, torch.zeros(n).index_fill_(
        0, torch.tensor([me]), worst))
    worst_all = float(every.max())
    if me == 0:
        say("dist", part="pipeline", arch=cfg.name, layers=L, stages=n,
            layers_per_stage=per, microbatches=M, seq=seq,
            master="float32", compute="bfloat16",
            forward_equal=equal, forward_bits_differing=bit_diff,
            negative_zeros_in_sequential=neg_zero,
            worst_leaf_grad_err_over_max=f"{worst_all:.3e}",
            bound=DIST_PIPE_GRAD_RTOL, leaves=len(names),
            flash_fwd_launches=f"wgmma_bf16:{fwd[0]},cuda_core_f32:{fwd[1]}",
            flash_bwd_launches=f"wgmma_bf16:{bwd[0]},mma_bf16:{bwd[1]},"
                               f"cuda_core_f32:{bwd[2]}",
            step_ms=f"{step_ms:.2f}", sequential_one_process_ms=f"{seq_ms:.2f}",
            handoff_bytes=seq * cfg.d_model * 2,
            all_reduce=f"bfloat16_{'through_host' if ax.staged(x) else 'device'}")
        if not equal:
            raise RuntimeError(f"pipeline forward differs from the "
                               f"sequential layers in {bit_diff} elements")
        want_l = n * per * M
        if on_card and (fwd != [want_l, 0] or bwd != [want_l, 0, 0]):
            raise RuntimeError(f"pipeline launched flash {fwd} and its "
                               f"backward {bwd}, expected {want_l} of each "
                               "on wgmma_bf16 alone")
        out = {"fwd": fwd[0], "bwd": bwd[0], "head_dim": cfg.head_dim}
    if worst_all > DIST_PIPE_GRAD_RTOL:
        raise RuntimeError(f"pipeline gradients: worst leaf {worst_all} of "
                           f"its max (bound {DIST_PIPE_GRAD_RTOL})")
    return out


def spec_block(full, spec: tuple, sizes: dict, coords: dict):
    """The block of the array ``full`` that the ranks at mesh ``coords``
    hold under the spec tuple ``spec``, by ``np.split``: a sharded dim split
    over each of its axes in turn, the major one first."""
    import numpy as np

    out = full
    for d, entry in enumerate(spec):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else entry)
        for a in axes:
            out = np.split(out, sizes[a], axis=d)[coords[a]]
    return np.asarray(out)


def dist_zero1(mesh, dev, plan, on_card: bool) -> dict:
    """``part=zero1`` on each rank: ``train`` under the (4,) ``data`` mesh in
    ``shardctx`` (ZeRO-1: this rank's rows and state blocks), a checkpoint
    at ``DIST_ZERO1_CKPT_AT`` and at the end (gathered, rank 0 writes); the
    flash counts set to 0 just before. Returns this rank's losses, step
    times, state bytes, peak memory and the ranks' launches."""
    import torch

    import repro_torch.train.loop as loop_mod
    from repro_torch.dist.comm import Axis, all_reduce_sum
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.models import count_params, model_init
    from repro_torch.models.layers import tree_flatten
    from repro_torch.shardctx import clear_ctx, set_ctx
    from repro_torch.train import LoopConfig

    cfg, run = plan["zero1_cfg"], train_run_config()
    kept, first = {}, {}
    real_save, real_build = loop_mod.save, loop_mod.build_train_step

    def keep_bytes(ckpt_dir, step, tree, *args, **kw):
        kept["bytes"] = sum(t.numel() * t.element_size()
                            for _, t in named_state_leaves(tree))
        return real_save(ckpt_dir, step, tree, *args, **kw)

    def keep_first(*args, **kw):
        step_fn = real_build(*args, **kw)

        def step(state, batch):
            state, metrics = step_fn(state, batch)
            if not first:  # this rank's blocks after step 1, on the card
                first.update((k, t.clone()) for k, t in
                             tree_flatten(state.params))
            return state, metrics

        return step

    loop = LoopConfig(steps=DIST_ZERO1_STEPS, batch=DIST_RANKS, seq=TRAIN_SEQ,
                      ckpt_every=DIST_ZERO1_CKPT_AT,
                      ckpt_dir=plan["zero1_dir"], log_every=0, seed=0)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    BWD_KERNEL.reset()
    set_ctx(mesh)
    try:
        with patched((loop_mod, "save", keep_bytes),
                     (loop_mod, "build_train_step", keep_first)):
            res = loop_mod.train(cfg, run, loop, device=dev)
    finally:
        clear_ctx()
    if on_card:
        torch.cuda.synchronize()
    launches = all_reduce_sum(Axis(mesh, "data"), torch.tensor([
        FLASH_KERNEL.variant_launches["wgmma_bf16"],
        FLASH_KERNEL.variant_launches["cuda_core_f32"],
        BWD_KERNEL.variant_launches["wgmma_bf16"],
        BWD_KERNEL.variant_launches["mma_bf16"],
        BWD_KERNEL.variant_launches["cuda_core_f32"]]))
    n_params = count_params(model_init(0, cfg, run, device="meta")[0])
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "step_ms": res.step_ms, "wall_s": res.wall_s,
            "params1": {k: t.cpu().numpy() for k, t in first.items()},
            "state_bytes": kept["bytes"], "whole_bytes": 4 + 12 * n_params,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else 0.0),
            "fwd": [int(v) for v in launches[:2]],
            "bwd": [int(v) for v in launches[2:]]}


def dist_elastic(mesh, plan) -> dict:
    """``part=elastic`` on each rank: the step-``DIST_ZERO1_CKPT_AT``
    checkpoint of ``part=zero1`` restored onto the (2, 2) ``("data",
    "model")`` ``mesh`` under ``tree_shardings`` (the parameters' model-axis
    layout), each block held against ``spec_block`` of the memory-mapped
    file."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import restore
    from repro_torch.dist.comm import Axis, all_reduce_sum
    from repro_torch.dist.sharding import mesh_coords, tree_shardings
    from repro_torch.models import abstract_init
    from repro_torch.train import TrainState

    dist.barrier()
    cfg, run = plan["zero1_cfg"], train_run_config()
    shapes, specs = abstract_init(cfg, dataclasses.replace(
        run, activations_dtype="float32"))
    like = TrainState(torch.empty((), dtype=torch.int32, device="meta"),
                      shapes, shapes, shapes)
    sh = tree_shardings(specs, shapes, mesh)
    sh_state = TrainState((), sh, sh, sh)
    t0 = time.perf_counter()
    state = restore(plan["zero1_dir"], DIST_ZERO1_CKPT_AT, like, sh_state,
                    mesh=mesh)
    restore_s = time.perf_counter() - t0
    arrays = (Path(plan["zero1_dir"]) / f"step_{DIST_ZERO1_CKPT_AT:08d}"
              / "arrays")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = mesh_coords(mesh)
    spec_of = dict(named_state_leaves(sh_state))
    exact, nbytes, whole, split = True, 0, 0, 0
    for name, block in named_state_leaves(state):
        full = np.load(arrays / (name.replace("/", "__") + ".npy"),
                       mmap_mode="r")
        want = spec_block(full, spec_of[name], sizes, coords)
        exact = exact and block.shape == want.shape and np.array_equal(
            block.numpy(), want)
        nbytes += block.numel() * block.element_size()
        whole += full.nbytes
        split += block.numel() < full.size
    agree = int(all_reduce_sum(Axis(mesh, "model"), all_reduce_sum(
        Axis(mesh, "data"), torch.tensor([int(exact)]))))
    return {"exact": exact, "all_exact": agree == mesh.size(),
            "coords": coords, "bytes": nbytes, "whole_bytes": whole,
            "split_leaves": split, "leaves": len(spec_of),
            "restore_s": restore_s}


def tp_run_configs() -> dict:
    """``part=tp``'s bf16 run (the training CLI's recipe) and its f32 twin,
    and ``part=moe_dp``'s f32 run."""
    run = train_run_config()
    f32 = dict(params_dtype="float32", activations_dtype="float32")
    return {"bf16": run, "f32": dataclasses.replace(run, **f32),
            "moe_dp": dataclasses.replace(
                run, attn_chunk_q=min(512, DIST_MOE_DP_SEQ),
                attn_chunk_k=min(1024, DIST_MOE_DP_SEQ), **f32)}


def tp_cases(plan) -> list:
    """``(tag, cfg, run, steps, seq, twin accum)`` of ``part=tp`` and
    ``part=moe_dp``: the dense twins take one data rank's row a microbatch
    (the ranks' arithmetic), the MoE twin the global batch in one pass
    (its capacity and ranks are the global batch's)."""
    runs = tp_run_configs()
    n_data = DIST_TP_MESH[0]
    return [("bf16", plan["zero1_cfg"], runs["bf16"], DIST_TP_STEPS,
             plan["tp_seq"], n_data),
            ("f32", plan["zero1_cfg"], runs["f32"], DIST_TP_F32_STEPS,
             plan["tp_seq"], n_data),
            ("moe_dp", plan["moe_dp_cfg"], runs["moe_dp"], DIST_MOE_DP_STEPS,
             plan["moe_dp_seq"], 1)]


@contextlib.contextmanager
def train_spies(kept: dict, masters_to: Path | None = None,
                grads1: bool = False):
    """Inside the block, ``train`` keeps its last state (``kept["state"]``),
    the bytes of the first forward's parameters (``kept["fwd_bytes"]``) and
    the routed pairs each MoE layer dropped (``kept["dropped"]``); with
    ``masters_to``, the masters each step after the first starts from are
    saved there (``step{i}/rank{r}.pt``, this rank's blocks); with
    ``grads1``, step 1's f32 gradients as the clip receives them (averaged
    over the data ranks, this rank's blocks) go to the host
    (``kept["grads1"]``, by leaf name)."""
    import repro_torch.models.moe as moe_mod
    import repro_torch.train.loop as loop_mod
    import repro_torch.train.step as step_mod

    real_build, real_loss = loop_mod.build_train_step, step_mod.loss_fn
    real_dispatch, real_clip = (moe_mod.dispatch_indices,
                                step_mod.clip_by_global_norm)
    kept.setdefault("dropped", [])

    def build(*args, **kw):
        step_fn = real_build(*args, **kw)

        def step(state, batch):
            i = kept["steps"] = kept.get("steps", 0) + 1
            if masters_to is not None and i > 1:
                import torch
                import torch.distributed as dist

                from repro_torch.models.layers import tree_flatten

                d = masters_to / f"step{i}"
                d.mkdir(parents=True, exist_ok=True)
                torch.save({k: t.detach().cpu() for k, t in
                            tree_flatten(state.params)},
                           d / f"rank{dist.get_rank()}.pt")
            state, metrics = step_fn(state, batch)
            kept["state"] = state
            return state, metrics

        return step

    def loss(params, *args, **kw):
        if "fwd_bytes" not in kept:
            from repro_torch.models.layers import tree_leaves

            kept["fwd_bytes"] = sum(t.numel() * t.element_size()
                                    for t in tree_leaves(params))
        return real_loss(params, *args, **kw)

    def dispatch(ids, m, cap, before=None):
        slot, keep = real_dispatch(ids, m, cap, before)
        kept["dropped"].append(int(keep.numel() - keep.sum()))
        return slot, keep

    def clip(grads, *args, **kw):
        if grads1 and "grads1" not in kept:
            from repro_torch.models.layers import tree_flatten

            kept["grads1"] = {k: t.detach().float().cpu()
                              for k, t in tree_flatten(grads)}
        return real_clip(grads, *args, **kw)

    with patched((loop_mod, "build_train_step", build),
                 (step_mod, "loss_fn", loss),
                 (moe_mod, "dispatch_indices", dispatch),
                 (step_mod, "clip_by_global_norm", clip)):
        yield kept


def twin_dir(plan, tag: str) -> Path:
    return Path(plan["tp_dir"]) / f"twin_{tag}"


def masters_dir(plan, tag: str) -> Path:
    return Path(plan["tp_dir"]) / f"masters_{tag}"


def grads_dir(plan, tag: str) -> Path:
    return Path(plan["tp_dir"]) / f"grads1_{tag}"


def save_leaves(d: Path, flat: dict) -> None:
    """One ``.npy`` a leaf of a flat dict of host tensors."""
    import numpy as np

    d.mkdir(parents=True, exist_ok=True)
    for k, t in flat.items():
        np.save(d / (k.replace("/", "__") + ".npy"), t.numpy())


def load_leaf(d: Path, k: str):
    import numpy as np

    return np.load(d / (k.replace("/", "__") + ".npy"), mmap_mode="r")


def grads_against_twins(plan, grads: dict, specs: dict, sizes: dict,
                        coords: dict) -> list:
    """Step 1's gradient blocks of this rank (bf16 run) against the same
    blocks of the one-process bf16 twin's and f32 twin's, which start from
    the same masters: ``(leaf, |g - g_bf16|, |g_bf16 - g_f32|)`` a leaf,
    Euclidean norms over the block."""
    import numpy as np

    out = []
    for k, g in grads.items():
        b = spec_block(load_leaf(grads_dir(plan, "bf16"), k), specs[k],
                       sizes, coords)
        f = spec_block(load_leaf(grads_dir(plan, "f32"), k), specs[k],
                       sizes, coords)
        out.append((k, float(np.linalg.norm(g.numpy() - b)),
                    float(np.linalg.norm(b - f))))
    return out


def blocks_against_twin(plan, tag: str, state, specs: dict, sizes: dict,
                        coords: dict) -> tuple[float, int, int]:
    """This rank's master blocks against ``spec_block`` of the one-process
    twin's final parameters (one ``.npy`` a leaf, memory-mapped): the
    largest |difference|, the elements beyond 1e-6 and the elements."""
    import numpy as np

    from repro_torch.models.layers import tree_flatten

    worst, beyond, n = 0.0, 0, 0
    for k, t in tree_flatten(state.params):
        full = load_leaf(twin_dir(plan, tag), k)
        d = np.abs(t.detach().float().cpu().numpy()
                   - spec_block(full, specs[k], sizes, coords))
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-6).sum())
        n += d.size
    return worst, beyond, n


def dist_tp(mesh, dev, plan, on_card: bool) -> dict:
    """``part=tp`` (stablelm in bf16, then in f32) and ``part=moe_dp``
    (moonshot in f32) on each rank: ``train`` under the (2, 2) ``("data",
    "model")`` mesh in ``shardctx``, the flash counts set to 0 just before
    each run. Returns each run's losses, grad norms, step ms, state and
    forward-parameter bytes, peak memory, launches, dropped pairs and its
    blocks against the one-process twin's parameters."""
    import torch

    from repro_torch.dist.comm import Axis, all_reduce_sum
    from repro_torch.dist.sharding import mesh_coords
    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.models.layers import tree_flatten
    from repro_torch.shardctx import clear_ctx, set_ctx
    from repro_torch.train import LoopConfig, train

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coords = mesh_coords(mesh)
    out = {"coords": coords}
    for tag, cfg, run, steps, seq, _ in tp_cases(plan):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        BWD_KERNEL.reset()
        kept: dict = {}
        loop = LoopConfig(steps=steps, batch=DIST_TP_MESH[0], seq=seq,
                          log_every=0, seed=0)
        bf16 = run.params_dtype == "bfloat16"
        masters = None if bf16 else masters_dir(plan, tag)
        set_ctx(mesh)
        try:
            with train_spies(kept, masters, grads1=bf16):
                res = train(cfg, run, loop, device=dev)
        finally:
            clear_ctx()
        if on_card:
            torch.cuda.synchronize()
        state = kept.pop("state")
        fwd = dict(FLASH_KERNEL.variant_launches)
        bwd = dict(BWD_KERNEL.variant_launches)
        launches = torch.tensor([fwd["wgmma_bf16"], fwd["cuda_core_f32"],
                                 bwd["wgmma_bf16"], bwd["mma_bf16"],
                                 bwd["cuda_core_f32"]])
        for a in mesh.mesh_dim_names:
            launches = all_reduce_sum(Axis(mesh, a), launches)
        from repro_torch.dist.sharding import zero1_shardings
        from repro_torch.models import abstract_init

        shapes, specs = abstract_init(cfg, dataclasses.replace(
            run, activations_dtype="float32"))
        zspecs = dict(tree_flatten(zero1_shardings(specs, shapes, mesh)))
        worst, beyond, n = blocks_against_twin(plan, tag, state, zspecs,
                                               sizes, coords)
        grads = (grads_against_twins(plan, kept.pop("grads1"), zspecs, sizes,
                                     coords) if bf16 else [])
        out[tag] = {
            "losses": res.losses, "grad_norms": res.grad_norms,
            "step_ms": res.step_ms, "wall_s": res.wall_s,
            "state_bytes": sum(t.numel() * t.element_size()
                               for _, t in named_state_leaves(state)),
            "fwd_bytes": kept["fwd_bytes"], "dropped": kept["dropped"],
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if on_card else 0.0),
            "fwd": fwd, "bwd": bwd,
            "launches_all_ranks": [int(v) for v in launches],
            "param_worst": worst, "param_beyond": beyond, "param_n": n,
            "grads1": grads}
        del state
    return out


def dist_rank(rank: int, plan: dict, device_type: str = "cuda") -> dict:
    """One rank of the ``--dist`` child: the four parts in order; rank 0
    prints and returns the launches and errors for the kernels line."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.comm import Axis, all_reduce_sum
    from repro_torch.launch.mesh import make_mesh

    on_card = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    meshes = {a: make_mesh((DIST_RANKS,), (a,), device_type)
              for a in ("model", "data", "pipe")}
    meshes["data_model"] = make_mesh((2, DIST_RANKS // 2), ("data", "model"),
                                     device_type)
    if rank == 0:
        ax = Axis(meshes["model"], "model")
        say("dist", part="route", backend=dist.get_backend(),
            ranks=DIST_RANKS, cards=torch.cuda.device_count() if on_card
            else 0, staged_through_host=ax.staged(torch.empty(0,
                                                              device=dev)))
    t0 = time.perf_counter()
    dist_executors(meshes["model"], dev, plan)
    t1 = time.perf_counter()
    dist_compress(meshes["data"], dev, plan)
    t2 = time.perf_counter()
    ep = dist_ep(meshes["model"], dev, plan, on_card)
    t3 = time.perf_counter()
    pipe = dist_pipeline(meshes["pipe"], dev, plan, on_card)
    t4 = time.perf_counter()
    ax = Axis(meshes["model"], "model")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    peaks = all_reduce_sum(ax, torch.zeros(ax.n).index_fill_(
        0, torch.tensor([ax.me]), peak))
    zero1 = dist_zero1(meshes["data"], dev, plan, on_card)
    t5 = time.perf_counter()
    elastic = dist_elastic(meshes["data_model"], plan)
    t6 = time.perf_counter()
    tp = dist_tp(meshes["data_model"], dev, plan, on_card)
    t7 = time.perf_counter()
    if rank == 0:
        say("dist", part="walls", executors_s=f"{t1 - t0:.1f}",
            compress_s=f"{t2 - t1:.1f}", ep_s=f"{t3 - t2:.1f}",
            pipeline_s=f"{t4 - t3:.1f}", zero1_s=f"{t5 - t4:.1f}",
            elastic_s=f"{t6 - t5:.1f}", tp_and_moe_dp_s=f"{t7 - t6:.1f}",
            peak_gib_by_rank_before_zero1=",".join(
                f"{g:.2f}" for g in peaks.tolist()))
    return {"ep": ep, "pipeline": pipe, "zero1": zero1, "elastic": elastic,
            "tp": tp}


def zero1_one_process(cfg, accum: int) -> dict:
    """``part=zero1``'s one-process run: ``DIST_ZERO1_STEPS`` steps of
    ``build_train_step`` on the global batch in ``accum`` microbatches, as
    ``train`` runs them (the same seed, data and schedule); the losses,
    grad norms and the f32 parameters after the first and the last step
    kept on the host."""
    import torch

    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_flatten
    from repro_torch.train import (build_train_step, cosine_lr, init_state,
                                   synthetic_batch)

    run = train_run_config()
    f32_run = dataclasses.replace(run, activations_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model_init(0, cfg, f32_run, device="cuda")[0])
    step_fn = build_train_step(cfg, run, accum=accum, lr_fn=cosine_lr(
        run, warmup=max(2, DIST_ZERO1_STEPS // 20), total=DIST_ZERO1_STEPS))
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    for s in range(DIST_ZERO1_STEPS):
        batch = synthetic_batch(cfg, DIST_RANKS, TRAIN_SEQ, 0, s,
                                device="cuda")
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        out["losses"].append(float(m["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norms"].append(float(m["grad_norm"]))
        if s == 0:
            out["params1"] = {k: t.cpu().numpy().copy() for k, t in
                              tree_flatten(state.params)}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["params"] = {k: t.cpu().numpy() for k, t in
                     tree_flatten(state.params)}
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def checkpoint_params(base: Path, step: int) -> dict:
    """The whole ``.params`` leaves of checkpoint ``step`` under ``base``,
    keyed as ``tree_flatten`` keys them."""
    import numpy as np

    arrays = base / f"step_{step:08d}" / "arrays"
    return {f.stem[len(".params__"):].replace("__", "/"): np.load(f)
            for f in arrays.glob(".params__*.npy")}


def param_rule(got: dict, want: dict) -> tuple[float, float]:
    """The largest |got - want| over every parameter and the share of
    elements beyond 1e-6 (``tests/test_torch_train.py``'s rule: at most
    2 lr and 1e-3)."""
    import numpy as np

    worst, beyond, n = 0.0, 0, 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-6).sum())
        n += d.size
    return worst, beyond / n


def zero1_report(plan, ranks: list, one: dict) -> tuple[dict, dict]:
    """``part=zero1`` in the parent: each rank's state bytes against the
    whole and against what its ``zero1_shardings`` blocks imply, peak
    memory and step times; then the ranks against the one-process runs.
    The ``accum=DIST_RANKS`` run is the ranks' twin (each microbatch one
    rank's rows, the same bf16 arithmetic; only the f32 sums over the
    ranks come in gloo's order) and must agree under the rule: every
    step's loss and grad norm within 1e-5, the parameters within 2 lr and
    at most 1e-3 of them beyond 1e-6, after step 1 (each rank's blocks
    against ``spec_block`` of the twin's) and at the end (the ranks'
    gathered checkpoint). The global batch in one pass (``accum=1``: other
    matrix shapes, so other bf16 roundings) is printed beside it, not
    bounded. Returns the ranks' launches and their final parameters."""
    from repro_torch.dist.sharding import abstract_mesh, zero1_shardings
    from repro_torch.models import abstract_init
    from repro_torch.models.layers import tree_flatten

    cfg, run = plan["zero1_cfg"], train_run_config()
    shapes, specs = abstract_init(cfg, dataclasses.replace(
        run, activations_dtype="float32"))
    mesh = abstract_mesh(("data", DIST_RANKS))
    zspecs = dict(tree_flatten(zero1_shardings(specs, shapes, mesh)))
    implied = 4 + 12 * sum(
        t.numel() // (DIST_RANKS if any(e is not None for e in zspecs[k])
                      else 1)
        for k, t in tree_flatten(shapes))
    twin = one[DIST_RANKS]
    worst1, beyond1 = 0.0, 0.0
    for r, z in enumerate(ranks):
        blocks = {k: spec_block(w, zspecs[k], {"data": DIST_RANKS},
                                {"data": r})
                  for k, w in twin["params1"].items()}
        w1, b1 = param_rule(z["params1"], blocks)
        worst1, beyond1 = max(worst1, w1), max(beyond1, b1)
        say("dist", part="zero1", rank=r, arch=cfg.name,
            layers=f"{cfg.n_layers}_of_24", seq=TRAIN_SEQ, rows=1,
            state_bytes=z["state_bytes"], implied_by_specs=implied,
            whole_state_bytes=z["whole_bytes"],
            share_of_whole=f"{z['state_bytes'] / z['whole_bytes']:.4f}",
            peak_gib=f"{z['peak_gib']:.2f}",
            step_ms=",".join(f"{t:.2f}" for t in z["step_ms"]),
            wall_s=f"{z['wall_s']:.1f}",
            losses=",".join(repr(x) for x in z["losses"]),
            step1_param_max_abs_diff=f"{w1:.3e}",
            step1_param_share_beyond_1e6=f"{b1:.3e}")
        if z["state_bytes"] != implied:
            fail(f"rank {r} holds {z['state_bytes']} state bytes, its "
                 f"blocks imply {implied}")
        if z["losses"] != ranks[0]["losses"]:
            fail(f"rank {r}'s losses differ from rank 0's")
    loss1 = abs(ranks[0]["losses"][0] - twin["losses"][0])
    norm1 = abs(ranks[0]["grad_norms"][0] - twin["grad_norms"][0])
    step1_met = (loss1 <= 1e-5 and norm1 <= 1e-5
                 and worst1 <= 2 * TRAIN_LR and beyond1 <= 1e-3)
    got = checkpoint_params(Path(plan["zero1_dir"]), DIST_ZERO1_STEPS)
    for accum, o in one.items():
        worst, beyond = param_rule(got, o["params"])
        loss_d = max(abs(a - b) for a, b in zip(ranks[0]["losses"],
                                                o["losses"]))
        norm_d = max(abs(a - b) for a, b in zip(ranks[0]["grad_norms"],
                                                o["grad_norms"]))
        met = (loss_d <= 1e-5 and norm_d <= 1e-5 and worst <= 2 * TRAIN_LR
               and beyond <= 1e-3)
        say("dist", part="zero1", against=f"one_process_accum{accum}",
            losses=",".join(repr(x) for x in o["losses"]),
            loss_abs_diff_by_step=",".join(
                f"{abs(a - b):.3e}" for a, b in zip(ranks[0]["losses"],
                                                    o["losses"])),
            grad_norm_abs_diff_by_step=",".join(
                f"{abs(a - b):.3e}" for a, b in zip(ranks[0]["grad_norms"],
                                                    o["grad_norms"])),
            final_param_max_abs_diff=f"{worst:.3e}", bound=2 * TRAIN_LR,
            final_param_share_beyond_1e6=f"{beyond:.3e}", share_bound=1e-3,
            within_rule=met, peak_gib=f"{o['peak_gib']:.2f}",
            step_ms=",".join(f"{t:.2f}" for t in o["step_ms"]))
        if accum == DIST_RANKS and not met:
            fail("ZeRO-1 on the ranks differs from its one-process twin "
                 "beyond the rule")
    say("dist", part="zero1", step1_against="one_process_accum"
        f"{DIST_RANKS}", loss_abs_diff=f"{loss1:.3e}",
        grad_norm_abs_diff=f"{norm1:.3e}",
        param_max_abs_diff=f"{worst1:.3e}",
        param_share_beyond_1e6=f"{beyond1:.3e}", within_rule=step1_met)
    if not step1_met:
        fail("ZeRO-1's first step on the ranks differs from its one-process "
             "twin beyond the rule")
    fwd, bwd = ranks[0]["fwd"], ranks[0]["bwd"]
    want = DIST_RANKS * DIST_ZERO1_STEPS * cfg.n_layers
    say("dist", part="zero1", launches_all_ranks=True,
        flash_fwd_launches=f"wgmma_bf16:{fwd[0]},cuda_core_f32:{fwd[1]}",
        flash_bwd_launches=f"wgmma_bf16:{bwd[0]},mma_bf16:{bwd[1]},"
                           f"cuda_core_f32:{bwd[2]}")
    if fwd != [want, 0] or bwd != [want, 0, 0]:
        fail(f"ZeRO-1 launched flash {fwd} and its backward {bwd}, "
             f"expected {want} of each on wgmma_bf16 alone")
    return {"fwd": fwd[0], "bwd": bwd[0], "head_dim": cfg.head_dim}, got


def elastic_report(plan, ranks: list, ranks_final: dict) -> dict:
    """``part=elastic`` in the parent: each rank's restore onto the (2, 2)
    mesh, then the step-``DIST_ZERO1_CKPT_AT`` checkpoint restored in one
    process by ``train`` and trained on to step ``DIST_ZERO1_STEPS`` (its
    microbatches one rank's rows each), against the four ranks' step
    ``DIST_ZERO1_STEPS`` under the rule; the flash counts set to 0 just
    before. Returns the launches."""
    import os
    import shutil

    import torch

    from repro_torch.kernels.flash_attention import BWD_KERNEL
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.train import LoopConfig, train

    for r, e in enumerate(ranks):
        say("dist", part="elastic", rank=r, mesh="data2_model2",
            coords=",".join(f"{a}:{c}" for a, c in e["coords"].items()),
            restored_bytes=e["bytes"], whole_bytes=e["whole_bytes"],
            split_leaves=f"{e['split_leaves']}_of_{e['leaves']}",
            each_block_exact=e["exact"], restore_s=f"{e['restore_s']:.2f}")
    if not all(e["all_exact"] for e in ranks):
        fail("a block restored onto the (2, 2) mesh differs from its spec's "
             "block of the checkpoint")
    cfg, run = plan["zero1_cfg"], train_run_config()
    base = Path(plan["zero1_dir"])
    step_dir = f"step_{DIST_ZERO1_CKPT_AT:08d}"
    one_dir = base.parent / "dist_elastic"
    shutil.rmtree(one_dir, ignore_errors=True)
    shutil.copytree(base / step_dir, one_dir / step_dir,
                    copy_function=os.link)
    # the ranks' last checkpoint is read already: room for this run's
    shutil.rmtree(base / f"step_{DIST_ZERO1_STEPS:08d}")
    reset_flash_counts()
    BWD_KERNEL.reset()
    res = train(cfg, run, LoopConfig(
        steps=DIST_ZERO1_STEPS, batch=DIST_RANKS, seq=TRAIN_SEQ,
        accum=DIST_RANKS, ckpt_dir=str(one_dir), log_every=0, seed=0),
        device="cuda")
    torch.cuda.synchronize()
    fwd = dict(FLASH_KERNEL.variant_launches)
    bwd = dict(BWD_KERNEL.variant_launches)
    worst, beyond = param_rule(checkpoint_params(one_dir, DIST_ZERO1_STEPS),
                               ranks_final)
    shutil.rmtree(one_dir, ignore_errors=True)
    loss_d = max(abs(a - b) for a, b in zip(
        res.losses, plan["ranks_losses"][DIST_ZERO1_CKPT_AT:]))
    met = worst <= 2 * TRAIN_LR and beyond <= 1e-3 and loss_d <= 1e-5
    want = (DIST_ZERO1_STEPS - DIST_ZERO1_CKPT_AT) * DIST_RANKS * cfg.n_layers
    say("dist", part="elastic", one_process=True,
        resumed_from=res.resumed_from, steps=len(res.losses),
        losses=",".join(repr(x) for x in res.losses),
        loss_max_abs_diff=f"{loss_d:.3e}",
        param_max_abs_diff=f"{worst:.3e}", bound=2 * TRAIN_LR,
        param_share_beyond_1e6=f"{beyond:.3e}", share_bound=1e-3,
        within_rule=met,
        flash_fwd_launches=",".join(f"{k}:{n}" for k, n in fwd.items()),
        flash_bwd_launches=",".join(f"{k}:{n}" for k, n in bwd.items()))
    if res.resumed_from != DIST_ZERO1_CKPT_AT or not met:
        fail("the one-process run resumed from the ranks' checkpoint differs "
             "from the ranks' last step beyond the rule")
    if (fwd != {"wgmma_bf16": want, "cuda_core_f32": 0}
            or bwd != {"wgmma_bf16": want, "mma_bf16": 0,
                       "cuda_core_f32": 0}):
        fail(f"the resumed run launched flash {fwd} and its backward {bwd}, "
             f"expected {want} of each on wgmma_bf16 alone")
    return {"fwd": fwd["wgmma_bf16"], "bwd": bwd["wgmma_bf16"],
            "head_dim": cfg.head_dim}


@contextlib.contextmanager
def rounding_sigma(acc: list):
    """Inside the block, each differentiable bf16 product of the layers
    (``dense_apply``, ``row_parallel``) and the LM head registers, for its
    output ``y``, a
    hook that adds ``sum(g**2 * v)`` to ``acc[0]`` (``g`` the loss's
    gradient at ``y``): ``v = p0**2 + p1**2 + 2 y**2`` bounds, in units of
    ``2**-14 / 12``, the variance of the difference between the tensor-
    parallel output ``bf16(bf16(p0) + bf16(p1))`` of the two half-K partial
    products and the one-process ``bf16(p0 + p1)``: four independent
    roundings, each uniform within half an ulp of at most ``|a| 2**-7``.
    A column-parallel output (the same dot products, perhaps summed in
    another f32 order) takes the same bound; the LM head's ``2 y**2``."""
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.layers as layers_mod
    import repro_torch.models.model as model_mod

    real_dense, real_head = layers_mod.dense_apply, model_mod.lm_head_apply
    real_row = layers_mod.row_parallel

    def site(y, v):
        def hook(g):
            acc[0] = acc[0] + (g.float().square() * v).sum().double()

        y.register_hook(hook)

    def watch(y, p, x):
        if y.requires_grad:
            w = p["w"].to(x.dtype)
            k = w.shape[0] // 2
            with torch.no_grad():
                v = ((x[..., :k] @ w[:k]).float().square()
                     + (x[..., k:] @ w[k:]).float().square()
                     + 2 * y.float().square())
            site(y, v)
        return y

    def dense(p, x):
        return watch(real_dense(p, x), p, x)

    def row(tp, p, h):
        return watch(real_row(tp, p, h), p, h)

    def head(p, x):
        y = real_head(p, x)
        if y.requires_grad:
            site(y, 2 * y.detach().float().square())
        return y

    with patched((layers_mod, "dense_apply", dense),
                 (attn_mod, "dense_apply", dense),
                 (layers_mod, "row_parallel", row),
                 (attn_mod, "row_parallel", row),
                 (model_mod, "lm_head_apply", head)):
        yield acc


def tp_twin(plan, tag: str, cfg, run, steps: int, seq: int,
            accum: int, device: str = "cuda") -> dict:
    """A ``part=tp``/``part=moe_dp`` run's one-process twin, alone on the
    card: ``steps`` steps of ``build_train_step`` on the global batch (one
    row a data rank) in ``accum`` microbatches, as ``train`` runs them (the
    same seed, data and schedule). The bf16 run's first step runs under
    ``rounding_sigma``. Writes the final f32 parameters to ``twin_dir``
    and, for ``part=tp``, step 1's gradients to ``grads_dir``, one
    ``.npy`` a leaf, and returns the losses, grad norms, step ms, peak
    memory, forward bytes, dropped pairs and the rounding sigma."""
    import torch

    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_flatten
    from repro_torch.train import (build_train_step, cosine_lr, init_state,
                                   synthetic_batch)

    on_card = device == "cuda"
    f32_run = dataclasses.replace(run, activations_dtype="float32")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_state(model_init(0, cfg, f32_run, device=device)[0])
    step_fn = build_train_step(cfg, run, accum=accum, lr_fn=cosine_lr(
        run, warmup=max(2, steps // 20), total=steps))
    out = {"losses": [], "grad_norms": [], "step_ms": []}
    acc = [torch.zeros((), dtype=torch.float64, device=device)]
    kept: dict = {}
    with train_spies(kept, grads1=tag in ("bf16", "f32")):
        for s in range(steps):
            batch = synthetic_batch(cfg, DIST_TP_MESH[0], seq, 0, s,
                                    device=device)
            t0 = time.perf_counter()
            with (rounding_sigma(acc) if s == 0 and tag == "bf16"
                  else contextlib.nullcontext()):
                state, m = step_fn(state, batch)
            out["losses"].append(float(m["loss"]))
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["grad_norms"].append(float(m["grad_norm"]))
    out["sigma"] = math.sqrt(float(acc[0]) * 2.0**-14 / 12) / accum
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30 if on_card
                       else 0.0)
    out["fwd_bytes"], out["dropped"] = kept["fwd_bytes"], kept["dropped"]
    if "grads1" in kept:
        save_leaves(grads_dir(plan, tag), kept.pop("grads1"))
    save_leaves(twin_dir(plan, tag), {k: t.cpu() for k, t in
                                      tree_flatten(state.params)})
    del state, step_fn
    if on_card:
        torch.cuda.empty_cache()
    return out


def twin_at_rank_masters(plan, tag: str, cfg, run, steps: int, seq: int,
                         accum: int, coords: list,
                         device: str = "cuda") -> list:
    """The one-process step's loss and grad norm at each later step of an
    f32 run, from the masters the ranks started that step from (their
    blocks assembled whole): each step's function at one state, whatever
    the first steps' AdamW did to the two trajectories."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import (abstract_mesh, shard_slices,
                                           zero1_shardings)
    from repro_torch.models import abstract_init
    from repro_torch.models.layers import tree_flatten
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train import synthetic_batch

    mesh = abstract_mesh(("data", DIST_TP_MESH[0]),
                         ("model", DIST_TP_MESH[1]))
    shapes, specs = abstract_init(cfg, run)
    z = dict(tree_flatten(zero1_shardings(specs, shapes, mesh)))
    step_fn = build_train_step(cfg, run, accum=accum)
    out = []
    for i in range(2, steps + 1):
        blocks = [torch.load(masters_dir(plan, tag) / f"step{i}" /
                             f"rank{r}.pt") for r in range(len(coords))]
        flat = {}
        for k, t in tree_flatten(shapes):
            full = np.empty(t.shape, dtype=np.float32)
            for co, b in zip(coords, blocks):
                full[shard_slices(z[k], t.shape, mesh, co)] = b[k].numpy()
            flat[k] = torch.from_numpy(full).to(device)
        del blocks
        params = {}
        for k, t in flat.items():
            node = params
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = t
        batch = synthetic_batch(cfg, DIST_TP_MESH[0], seq, 0, i - 1,
                                device=device)
        _, m = step_fn(init_state(params), batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        del params, flat
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def tp_report(plan, ranks: list, twins: dict) -> dict:
    """``part=tp`` and ``part=moe_dp`` in the parent: each rank's state and
    forward-parameter bytes against what its blocks imply, peak memory,
    step ms and flash launches; then each run against its one-process twin
    under its rule (module docstring, 7f). Returns the launches for the
    kernels line."""
    from repro_torch.dist.sharding import (abstract_mesh, shard_slices,
                                           tree_shardings, zero1_shardings)
    from repro_torch.models import abstract_init
    from repro_torch.models.layers import tree_flatten

    mesh = abstract_mesh(("data", DIST_TP_MESH[0]),
                         ("model", DIST_TP_MESH[1]))
    launches, failed = {}, []
    for tag, cfg, run, steps, seq, accum in tp_cases(plan):
        part = "moe_dp" if tag == "moe_dp" else "tp"
        twin = twins[tag]
        shapes, specs = abstract_init(cfg, dataclasses.replace(
            run, activations_dtype="float32"))
        z = dict(tree_flatten(zero1_shardings(specs, shapes, mesh)))
        mb = dict(tree_flatten(tree_shardings(specs, shapes, mesh)))
        elem = 2 if run.params_dtype == "bfloat16" else 4

        def numel(spec, shape, coords):
            return math.prod(s.stop - s.start for s in shard_slices(
                spec, shape, mesh, coords))

        for r, got in enumerate(ranks):
            g, co = got[tag], got["coords"]
            leaves = tree_flatten(shapes)
            state_implied = 4 + 12 * sum(numel(z[k], t.shape, co)
                                         for k, t in leaves)
            fwd_implied = elem * sum(numel(mb[k], t.shape, co)
                                     for k, t in leaves)
            say("dist", part=part, dtype=run.params_dtype, rank=r,
                arch=cfg.name, layers=cfg.n_layers, seq=seq, rows=1,
                coords=",".join(f"{a}:{c}" for a, c in co.items()),
                state_bytes=g["state_bytes"], implied_by_specs=state_implied,
                fwd_param_bytes=g["fwd_bytes"],
                fwd_implied_by_model_blocks=fwd_implied,
                twin_fwd_param_bytes=twin["fwd_bytes"],
                peak_gib=f"{g['peak_gib']:.2f}",
                step_ms=",".join(f"{t:.2f}" for t in g["step_ms"]),
                wall_s=f"{g['wall_s']:.1f}",
                losses=",".join(repr(x) for x in g["losses"]),
                grad_norms=",".join(repr(x) for x in g["grad_norms"]),
                flash_fwd=",".join(f"{k}:{n}" for k, n in g["fwd"].items()),
                flash_bwd=",".join(f"{k}:{n}" for k, n in g["bwd"].items()))
            if g["state_bytes"] != state_implied:
                failed.append(f"{part} {tag}: rank {r} holds {g['state_bytes']} state "
                     f"bytes, its blocks imply {state_implied}")
            if g["fwd_bytes"] != fwd_implied:
                failed.append(f"{part} {tag}: rank {r}'s forward holds "
                     f"{g['fwd_bytes']} parameter bytes, its model blocks "
                     f"imply {fwd_implied}")
            if g["losses"] != ranks[0][tag]["losses"]:
                failed.append(f"{part} {tag}: rank {r}'s losses differ from rank 0's")
        g0 = ranks[0][tag]
        dl = [abs(a - b) for a, b in zip(g0["losses"], twin["losses"])]
        dn = [abs(a - b) for a, b in zip(g0["grad_norms"],
                                         twin["grad_norms"])]
        worst = max(got[tag]["param_worst"] for got in ranks)
        share = (sum(got[tag]["param_beyond"] for got in ranks)
                 / sum(got[tag]["param_n"] for got in ranks))
        fields = dict(
            part=part, dtype=run.params_dtype, against=f"one_process_accum"
            f"{accum}", twin_losses=",".join(repr(x) for x in twin["losses"]),
            twin_grad_norms=",".join(repr(x) for x in twin["grad_norms"]),
            loss_abs_diff_by_step=",".join(f"{x:.3e}" for x in dl),
            grad_norm_abs_diff_by_step=",".join(f"{x:.3e}" for x in dn),
            final_param_max_abs_diff=f"{worst:.3e}",
            final_param_share_beyond_1e6=f"{share:.3e}",
            twin_step_ms=",".join(f"{t:.2f}" for t in twin["step_ms"]),
            twin_peak_gib=f"{twin['peak_gib']:.2f}")
        if tag == "bf16":
            f32 = twins["f32"]
            bound = DIST_TP_SIGMAS * twin["sigma"] + DIST_TP_F32_SLACK
            # step 1's gradient, leaf by leaf on every rank's blocks:
            # |g - g_bf16| against |g_bf16 - g_f32|
            per_leaf = [(r, k, a, b) for r, got in enumerate(ranks)
                        for k, a, b in got[tag]["grads1"]]
            over = [(r, k, a, b) for r, k, a, b in per_leaf
                    if a > DIST_TP_GRAD_RATIO * b]
            r_w, k_w, a_w, b_w = max(per_leaf,
                                     key=lambda x: x[2] / max(x[3], 1e-30))
            tot_a = math.sqrt(sum(a * a for _, _, a, _ in per_leaf))
            tot_b = math.sqrt(sum(b * b for _, _, _, b in per_leaf))
            met = dl[0] <= bound and not over
            fields.update(
                step1_loss_bound=f"{bound:.3e}", sigma=f"{twin['sigma']:.3e}",
                step1_loss_in_sigmas=f"{dl[0] / twin['sigma']:.2f}",
                grad1_leaf_blocks=len(per_leaf),
                grad1_ratio_bound=DIST_TP_GRAD_RATIO,
                grad1_blocks_over_bound=len(over),
                grad1_worst_ratio=f"{a_w / max(b_w, 1e-30):.3f}",
                grad1_worst_leaf=f"rank{r_w}:{k_w}",
                grad1_worst_abs=f"{a_w:.3e},{b_w:.3e}",
                grad1_all_blocks_ratio=f"{tot_a / max(tot_b, 1e-30):.3f}",
                twin_vs_f32_twin_step1_loss=f"{abs(twin['losses'][0] - f32['losses'][0]):.3e}",
                twin_vs_f32_twin_step1_grad_norm=f"{abs(twin['grad_norms'][0] - f32['grad_norms'][0]):.3e}",
                within_rule=met)
        else:
            same = twin.get("at_rank_masters", [])
            sl = [abs(a - b[0]) for a, b in zip(g0["losses"][1:], same)]
            sn = [abs(a - b[1]) for a, b in zip(g0["grad_norms"][1:], same)]
            met = (max(dl[:1] + sl) <= 1e-5 and max(dn[:1] + sn) <= 1e-5
                   and worst <= 2 * TRAIN_LR and share <= 1e-3)
            if same:
                fields.update(
                    loss_abs_diff_at_rank_masters=",".join(
                        f"{x:.3e}" for x in dl[:1] + sl),
                    grad_norm_abs_diff_at_rank_masters=",".join(
                        f"{x:.3e}" for x in dn[:1] + sn))
            fields.update(bound=1e-5, param_bound=2 * TRAIN_LR,
                          share_bound=1e-3, within_rule=met)
        if tag == "moe_dp":
            # each data rank's drops, read on model coordinate 0
            drops = [sum(x) for x in zip(*(got[tag]["dropped"] for got in ranks
                                           if got["coords"]["model"] == 0))]
            fields.update(dropped_pairs_by_layer_call=",".join(map(str, drops)),
                          twin_dropped=",".join(map(str, twin["dropped"])))
            if drops != twin["dropped"]:
                failed.append("moe_dp: the ranks dropped other routed pairs than the "
                     f"global batch does in one process: {drops} against "
                     f"{twin['dropped']}")
        say("dist", **fields)
        name = part if tag == part else f"{part} {tag}"
        if not met:
            failed.append(f"{name}: the ranks differ from the one-process twin beyond "
                 "the rule")
        la = g0["launches_all_ranks"]
        want = DIST_TP_MESH[0] * DIST_TP_MESH[1] * steps * cfg.n_layers
        bf16 = run.params_dtype == "bfloat16"
        fwd, bwd = ([want, 0], [want, 0, 0]) if bf16 else \
            ([0, want], [0, 0, want])
        say("dist", part=part, dtype=run.params_dtype,
            launches_all_ranks=True, head_dim=cfg.head_dim,
            flash_fwd_launches=f"wgmma_bf16:{la[0]},cuda_core_f32:{la[1]}",
            flash_bwd_launches=f"wgmma_bf16:{la[2]},mma_bf16:{la[3]},"
                               f"cuda_core_f32:{la[4]}")
        if la[:2] != fwd or la[2:] != bwd:
            failed.append(f"{name} launched flash {la[:2]} and its backward "
                 f"{la[2:]}, expected {fwd} and {bwd}")
        launches[tag] = {"fwd": sum(la[:2]), "bwd": sum(la[2:]),
                         "bwd_route": "wgmma_bf16" if bf16
                         else "cuda_core_f32", "head_dim": cfg.head_dim}
    if failed:
        fail("; ".join(failed))
    return launches


def tp_twins_after(plan, twins: dict, ranks: list,
                   device: str = "cuda") -> None:
    """After the ranks: each f32 run's later steps in one process from the
    ranks' masters (``twin_at_rank_masters``), into ``twins``."""
    coords = [r["tp"]["coords"] for r in ranks]
    for tag, cfg, run, steps, seq, accum in tp_cases(plan):
        if run.params_dtype == "float32" and steps > 1:
            twins[tag]["at_rank_masters"] = twin_at_rank_masters(
                plan, tag, cfg, run, steps, seq, accum, coords, device)


def tp_twins(plan, device: str = "cuda") -> dict:
    """The one-process twins of ``part=tp`` and ``part=moe_dp``, alone on
    the card before the ranks."""
    import shutil

    shutil.rmtree(plan["tp_dir"], ignore_errors=True)
    return {tag: tp_twin(plan, tag, cfg, run, steps, seq, accum, device)
            for tag, cfg, run, steps, seq, accum in tp_cases(plan)}


def dist_child() -> None:
    """``--dist``: ``DIST_RANKS`` ranks on this machine's cards (gloo when
    they share one); ``part=zero1``'s one-process runs before them and the
    comparisons after; prints ``[dist]`` lines and one JSON line."""
    import shutil

    import torch

    from repro_torch.launch.mesh import choose_backend, spawn_ranks
    from repro_torch.models import RunConfig, count_params, model_init

    plan = dist_plan()
    ep_cfg, pipe_cfg = plan["ep_cfg"], plan["pipe_cfg"]
    run = RunConfig()
    n_ep = count_params(model_init(0, ep_cfg, run, device="meta")[0])
    m = ep_cfg.moe
    experts = 3 * m.n_experts * ep_cfg.d_model * m.d_expert * ep_cfg.n_layers
    per_rank = n_ep - experts + experts // DIST_RANKS
    n_pipe = count_params(model_init(0, pipe_cfg, run, device="meta")[0])
    n_zero1 = count_params(model_init(0, plan["zero1_cfg"], run,
                                      device="meta")[0])
    say("dist", part="plan", ranks=DIST_RANKS,
        backend=choose_backend(DIST_RANKS, "cuda"),
        cards=torch.cuda.device_count(),
        ep_arch=ep_cfg.name, ep_layers=f"{ep_cfg.n_layers}_of_48",
        cut=f"moonshot_layers_48_to_{DIST_EP_LAYERS}",
        ep_bf16_gib_per_rank=f"{2 * per_rank / 2**30:.2f}",
        ep_bf16_gib_dense=f"{2 * n_ep / 2**30:.2f}",
        compress_gib_per_rank=f"{4 * math.prod(DIST_COMPRESS_SHAPE) / 2**30:.2f}",
        pipe_arch=pipe_cfg.name, pipe_layers=pipe_cfg.n_layers,
        pipe_f32_gib_per_rank=f"{4 * n_pipe / 2**30:.2f}",
        zero1_layers=f"{DIST_ZERO1_LAYERS}_of_24", zero1_params=n_zero1,
        zero1_f32_state_gib_whole=f"{12 * n_zero1 / 2**30:.2f}")
    # the ranks load the libraries this process builds
    from repro_torch.kernels.flash_attention import BWD_KERNEL, BWD_WGMMA_LIB
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL

    FLASH_KERNEL.build()
    BWD_WGMMA_LIB.build()
    BWD_KERNEL.build()
    # part=zero1's, part=tp's and part=moe_dp's one-process runs, alone on
    # the card before the ranks
    t0 = time.perf_counter()
    one = {accum: zero1_one_process(plan["zero1_cfg"], accum)
           for accum in (DIST_RANKS, 1)}
    t1 = time.perf_counter()
    twins = tp_twins(plan)
    say("dist", part="one_process_walls", zero1_s=f"{t1 - t0:.1f}",
        tp_and_moe_dp_s=f"{time.perf_counter() - t1:.1f}")
    out = ROOT / "build" / "dist"
    shutil.rmtree(plan["zero1_dir"], ignore_errors=True)
    try:
        res = spawn_ranks(dist_rank, DIST_RANKS, (plan,), out_dir=out,
                          device_type="cuda", timeout_s=DIST_TIMEOUT_S)
        result = {k: res[0][k] for k in ("ep", "pipeline")}
        result["zero1"], final = zero1_report(
            plan, [r["zero1"] for r in res], one)
        del one
        plan["ranks_losses"] = res[0]["zero1"]["losses"]
        result["elastic"] = elastic_report(
            plan, [r["elastic"] for r in res], final)
        t0 = time.perf_counter()
        tp_twins_after(plan, twins, res)
        result["tp"] = tp_report(plan, [r["tp"] for r in res], twins)
        say("dist", part="one_process_walls",
            tp_and_moe_dp_after_s=f"{time.perf_counter() - t0:.1f}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(plan["zero1_dir"], ignore_errors=True)
        shutil.rmtree(plan["tp_dir"], ignore_errors=True)
    print(json.dumps(result), flush=True)


def phase_dist_child(entries: list) -> None:
    """The ``--dist`` child; its flash launches (the EP prefills' forward at
    moonshot's head dim, the pipeline's forward and backward at
    stablelm's) join the kernels line's entries."""
    import torch

    say("dist", part="parent",
        allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    res = run_child("--dist", DIST_CHILD_TIMEOUT_S)
    flash = next(e for e in entries if e["name"] == "flash_attention")
    bwd = next(e for e in entries if e["name"] == "flash_attention_bwd")
    # the child's models are GQA: v as wide as q and k
    for part, n in ((res["ep"], res["ep"]["flash_launches"]),
                    (res["pipeline"], res["pipeline"]["fwd"]),
                    (res["zero1"], res["zero1"]["fwd"]),
                    (res["elastic"], res["elastic"]["fwd"])):
        add_launches(flash, pair_key(part["head_dim"]), n)
    for part in ("pipeline", "zero1", "elastic"):
        add_launches(bwd, pair_key(res[part]["head_dim"]), res[part]["bwd"],
                     "wgmma_bf16")
    for run in res["tp"].values():  # part=tp (bf16, f32), part=moe_dp
        add_launches(flash, pair_key(run["head_dim"]), run["fwd"])
        add_launches(bwd, pair_key(run["head_dim"]), run["bwd"],
                     run["bwd_route"])


# ---------------------------------------------------------------------------
# serving on a mesh: prefill and decode on each rank's blocks ([dist]
# part=serve_tp), and the dry run's fake worlds ([dryrun])
# ---------------------------------------------------------------------------
def serve_tp_plan() -> dict:
    """``part=serve_tp``'s configurations: full width, cut in depth."""
    from repro_torch.configs import ARCHS

    return {"models": {
        "moonshot": cut_depth(ARCHS[MOE_ARCH], (("attn_moe", 2),)),
        "deepseek": cut_depth(ARCHS[MLA_ARCH], (("mla_dense", 1),
                                                 ("mla_moe", 1))),
        "hymba": cut_depth(ARCHS["hymba-1.5b"], (("hymba_g", 1),
                                                ("hymba_w", 2),
                                                ("hymba_g", 1)))},
        "dir": str(ROOT / "build" / "serve_tp")}


def serve_tp_run(dtype: str):
    """The run of ``dtype``: parameters, activations and KV cache in it."""
    from repro_torch.models import RunConfig

    return RunConfig(params_dtype=dtype, activations_dtype=dtype,
                     kv_cache_dtype=dtype)


def serve_tp_tokens(cfg):
    """The prompt and the decode steps' tokens, seeded, on the host."""
    import torch

    g = torch.Generator().manual_seed(13)
    return torch.randint(0, cfg.vocab, (SERVE_TP_B,
                                        SERVE_TP_PROMPT + SERVE_TP_STEPS),
                         generator=g)


def serve_tp_serve(params, cfg, run, toks, dev):
    """A prefill of the prompt and the teacher-forced decode steps:
    ``(logits of each on the host, caches, prefill ms, decode ms a
    step)``."""
    import torch

    from repro_torch.models import decode_step, prefill

    seq, P = toks.to(dev), SERVE_TP_PROMPT
    timed_here = timed if dev.type == "cuda" else timed_host
    (logits, caches), pre_ms = timed_here(lambda: prefill(
        params, {"tokens": seq[:, :P]}, cfg, run,
        cache_len=P + SERVE_TP_STEPS))
    out, dec_ms = [logits.float().cpu()], 0.0
    for i in range(SERVE_TP_STEPS):
        (logits, caches), ms = timed_here(lambda: decode_step(
            params, caches, {"tokens": seq[:, P + i:P + i + 1],
                             "pos": P + i}, cfg, run))
        out.append(logits.float().cpu())
        dec_ms += ms
    return torch.stack(out), caches, pre_ms, dec_ms / SERVE_TP_STEPS


def timed_host(fn):
    """``fn()`` and its wall time in ms (the ranks' CPU rehearsal)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def serve_tp_flat(caches) -> dict:
    from repro_torch.models.layers import tree_flatten

    return {f"{g}/{i}/{path}": t for g, layers in caches.items()
            for i, layer in enumerate(layers)
            for path, t in tree_flatten(layer)}


def serve_tp_stream() -> None:
    """``[dist] part=stream_bf16``: the two stream options on the card, each
    wrapper on f32 inputs at hymba's shapes (a global layer's attention,
    its SSD scan) against the plain version with the same option on the
    same inputs, the counts set to 0 just before: the bf16 kernels must
    run (``wgmma_bf16``, ``mma_bf16``), within the bf16 kernels' own
    tolerances (``ATTN_ATOL``/``ATTN_ROW_RTOL``, ``SSD_ATOL``)."""
    import torch

    from repro_torch.kernels.flash_attention import (
        KERNEL as FLASH_KERNEL, flash_attention, flash_attention_ref,
    )
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL, ssd_scan_kernel
    from repro_torch.models.ssm import ssd_scan

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(17)
    rand = lambda *shape: torch.randn(shape, device=dev, generator=g)  # noqa
    B, S = 4, SERVE_TP_PROMPT
    q, k, v = rand(B, S, 25, 64), rand(B, S, 5, 64), rand(B, S, 5, 64)
    reset_flash_counts()
    got = flash_attention(q, k, v, stream_bf16=True, device=dev)
    launches = dict(FLASH_KERNEL.variant_launches)
    want = flash_attention_ref(q, k, v, stream_bf16=True)
    err = float((got - want).abs().max())
    rows = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    bf16 = "torch.bfloat16"
    say("dist", part="stream_bf16", kernel="flash_attention",
        shape=tuple(q.shape), kv=tuple(k.shape), out_dtype=got.dtype,
        launches=",".join(f"{a}:{n}" for a, n in launches.items()),
        max_abs_err=f"{err:.3e}", atol=ATTN_ATOL[bf16],
        max_row_rel_err=f"{rows:.3e}", row_rtol=ATTN_ROW_RTOL[bf16])
    if (launches != {"wgmma_bf16": 1, "cuda_core_f32": 0}
            or not err <= ATTN_ATOL[bf16] or not rows <= ATTN_ROW_RTOL[bf16]):
        fail(f"attn_stream_bf16 on the card: {launches}, {err}, {rows}")
    H, P, N, L = 50, 64, 16, 256
    x, Bm, Cm = rand(B, S, H, P), rand(B, S, 1, N), rand(B, S, 1, N)
    dt = torch.rand((B, S, H), device=dev, generator=g) * 0.1
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    SSD_KERNEL.variant_launches = dict.fromkeys(SSD_KERNEL.variant_launches,
                                                0)
    # ssd_block_apply's stream option: x, B and C in bf16 to the kernel
    y, h = ssd_scan_kernel(x.bfloat16(), dt, A, Bm.bfloat16(),
                           Cm.bfloat16(), L, device=dev)
    launches = dict(SSD_KERNEL.variant_launches)
    y_w, h_w = ssd_scan(x, dt, A, Bm, Cm, L, return_state=True,
                        stream_bf16=True)
    err = max(float((y - y_w).abs().max()), float((h - h_w).abs().max()))
    say("dist", part="stream_bf16", kernel="ssd_intra_chunk",
        x=tuple(x.shape), chunk=L,
        launches=",".join(f"{a}:{n}" for a, n in launches.items()),
        max_abs_err_y_state=f"{err:.3e}", atol=SSD_ATOL[bf16],
        plain_rms=f"{float(y_w.square().mean().sqrt()):.4f}")
    if (launches != {"mma_bf16": 1, "cuda_core_f32": 0}
            or not err <= SSD_ATOL[bf16]):
        fail(f"ssd_stream_bf16 on the card: {launches}, {err}")


def serve_tp_twins(plan, device_type: str = "cuda") -> dict:
    """The one-process runs, alone on the card: their logits and caches
    saved on the host for the ranks; their times."""
    import torch

    from repro_torch.models import model_init

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    Path(plan["dir"]).mkdir(parents=True, exist_ok=True)
    out = {}
    for tag, cfg in plan["models"].items():
        toks = serve_tp_tokens(cfg)
        for dt in ("bfloat16", "float32"):
            run = serve_tp_run(dt)
            params, _ = model_init(0, cfg, run, device=dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            logits, caches, pre_ms, dec_ms = serve_tp_serve(
                params, cfg, run, toks, dev)
            torch.save({"logits": logits[..., :cfg.vocab],
                        "caches": {k: t.cpu() for k, t in
                                   serve_tp_flat(caches).items()}},
                       Path(plan["dir"]) / f"{tag}_{dt}.pt")
            out[f"{tag}/{dt}"] = {
                "prefill_ms": pre_ms, "decode_ms": dec_ms,
                "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                             if dev.type == "cuda" else 0.0)}
            del params, caches
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def serve_tp_against(plan, tag: str, dt: str, logits, caches, cfg, run,
                     mesh, coords) -> dict:
    """A rank's logits and cache blocks against the twins' (module
    constants' rules): the worst ratio to its bound, logits and caches."""
    import torch

    from repro_torch.dist.sharding import (CACHE_RULES, shard_slices,
                                           spec_for_shape)
    from repro_torch.models.layers import tree_flatten
    from repro_torch.models.model import cache_axes

    load = lambda d: torch.load(Path(plan["dir"]) / f"{tag}_{d}.pt")  # noqa
    twin, f32 = load(dt), (load("float32") if dt == "bfloat16" else None)
    axes = {f"{g}/{path}": ax[1:] for g, tree in cache_axes(cfg, run).items()
            for path, ax in tree_flatten(tree)}

    def ratio(got, want, want32):
        err = float((got.float() - want.float()).abs().max())
        if want32 is None:  # f32: within the rtol of the largest
            bound = SERVE_TP_F32_RTOL * float(want.float().abs().max())
        else:
            bound = SERVE_TP_BF16_RATIO * float(
                (want.float() - want32.float()).abs().max())
        return err, bound, (err / bound if bound else float(err > 0) * 1e9)

    l_err, l_bound, l_ratio = ratio(logits[..., :cfg.vocab], twin["logits"],
                                    f32["logits"] if f32 else None)
    worst, shapes_ok, mine = (0.0, ""), True, serve_tp_flat(caches)
    for path, w in twin["caches"].items():
        g, _, leaf = path.split("/", 2)
        spec = spec_for_shape(axes[f"{g}/{leaf}"], w.shape, mesh,
                              CACHE_RULES)
        sl = shard_slices(spec, w.shape, mesh, coords)
        got = mine[path].cpu()
        shapes_ok &= tuple(got.shape) == tuple(w[sl].shape)
        r = ratio(got, w[sl], f32["caches"][path][sl] if f32 else None)[2]
        worst = max(worst, (r, path))
    return {"logit_err": l_err, "logit_bound": l_bound,
            "logit_ratio": l_ratio, "cache_ratio": worst[0],
            "cache_worst_leaf": worst[1], "cache_shapes_ok": shapes_ok}


def serve_tp_rank(rank: int, plan: dict, device_type: str = "cuda") -> dict:
    """One rank of ``part=serve_tp``: for each configuration and dtype its
    blocks of the seeded parameters (the ranks draw the whole tree one at
    a time and keep their blocks), then the prefill and decode steps on
    its blocks under ``shardctx.set_ctx(mesh, blocks=True)``, the flash
    and SSD counts set to 0 just before and read just after."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import (mesh_coords, shard_slices,
                                           tree_shardings)
    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_init
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.shardctx import clear_ctx, set_ctx

    on_card = device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    mesh = make_mesh(SERVE_TP_MESH, ("data", "model"), device_type)
    coords = mesh_coords(mesh)
    out = {"coords": coords}
    for tag, cfg in plan["models"].items():
        toks = serve_tp_tokens(cfg)
        for dt in ("bfloat16", "float32"):
            run = serve_tp_run(dt)
            # one rank at a time draws the whole tree on the card and keeps
            # its blocks on the host until every rank has drawn: the card
            # holds one whole tree (deepseek's f32 is 20 GiB) at a time
            mine = None
            free_before = torch.cuda.mem_get_info()[0] if on_card else 0
            for turn in range(DIST_RANKS):
                dist.barrier()
                if turn == rank:
                    whole, specs = model_init(0, cfg, run, device=dev)
                    mine = tree_map(
                        lambda t, sp: t[shard_slices(sp, t.shape, mesh,
                                                     coords)].cpu(),
                        whole, tree_shardings(specs, whole, mesh))
                    del whole
                    if on_card:
                        torch.cuda.empty_cache()
            dist.barrier()
            mine = tree_map(lambda t: t.to(dev), mine)
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_flash_counts()
            SSD_KERNEL.reset()
            set_ctx(mesh, blocks=True)
            try:
                logits, caches, pre_ms, dec_ms = serve_tp_serve(
                    mine, cfg, run, toks, dev)
            finally:
                clear_ctx()
            res = {"flash": dict(FLASH_KERNEL.variant_launches),
                   "flash_by_dim": {pair_key(d): n for d, n in
                                    FLASH_KERNEL.head_dim_launches.items()
                                    if n},
                   "ssd": dict(SSD_KERNEL.variant_launches),
                   "prefill_ms": pre_ms, "decode_ms": dec_ms,
                   "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                if on_card else 0.0),
                   "card_free_gib_before_draws": free_before / 2**30,
                   "param_bytes": sum(t.numel() * t.element_size() for t in
                                      tree_leaves(mine))}
            res.update(serve_tp_against(plan, tag, dt, logits, caches, cfg,
                                        run, mesh, coords))
            out[f"{tag}/{dt}"] = res
            del mine, caches
            if on_card:
                torch.cuda.empty_cache()
    return out


def serve_tp_child() -> None:
    """``--serve-tp``: the one-process twins, then ``DIST_RANKS`` ranks
    sharing the card over gloo; prints ``[dist] part=serve_tp`` lines and
    one JSON line (the launches for the kernels line)."""
    import shutil

    import torch

    from repro_torch.kernels.flash_attention import KERNEL as FLASH_KERNEL
    from repro_torch.kernels.ssd import KERNEL as SSD_KERNEL
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import count_params, model_init

    plan = serve_tp_plan()
    FLASH_KERNEL.build()  # the ranks load the libraries built here
    SSD_KERNEL.build()
    serve_tp_stream()
    t0 = time.perf_counter()
    twins = serve_tp_twins(plan)
    t1 = time.perf_counter()
    out = ROOT / "build" / "serve_tp_ranks"
    try:
        ranks = spawn_ranks(serve_tp_rank, DIST_RANKS, (plan,), out_dir=out,
                            device_type="cuda", timeout_s=SERVE_TP_TIMEOUT_S)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(plan["dir"], ignore_errors=True)
    t2 = time.perf_counter()
    totals = {"flash": {}, "flash_by_dim": {}, "ssd": {}}
    for tag, cfg in plan["models"].items():
        n_attn = sum(c for k, c in cfg.layout if k != "ssd")
        n_ssd = sum(c for k, c in cfg.layout if k.startswith("hymba")
                    or k == "ssd")
        params = count_params(model_init(0, cfg, serve_tp_run("float32"),
                                         device="meta")[0])
        for dt in ("bfloat16", "float32"):
            variant = "wgmma_bf16" if dt == "bfloat16" else "cuda_core_f32"
            ssd_variant = "mma_bf16" if dt == "bfloat16" else "cuda_core_f32"
            twin = twins[f"{tag}/{dt}"]
            for r, rank in enumerate(ranks):
                res = rank[f"{tag}/{dt}"]
                say("dist", part="serve_tp", arch=cfg.name,
                    layers=cfg.n_layers, dtype=dt, rank=r,
                    coords=",".join(f"{a}{c}" for a, c in
                                    rank["coords"].items()),
                    params_whole=params, param_bytes=res["param_bytes"],
                    batch=SERVE_TP_B, prompt=SERVE_TP_PROMPT,
                    decode_steps=SERVE_TP_STEPS,
                    logit_err=f"{res['logit_err']:.3e}",
                    logit_bound=f"{res['logit_bound']:.3e}",
                    logit_ratio=f"{res['logit_ratio']:.3f}",
                    cache_ratio=f"{res['cache_ratio']:.3f}",
                    cache_worst_leaf=res["cache_worst_leaf"],
                    cache_blocks_shapes_equal=res["cache_shapes_ok"],
                    flash=",".join(f"{k}:{v}" for k, v in
                                   res["flash"].items()),
                    head_dims=",".join(f"{k}:{v}" for k, v in
                                       res["flash_by_dim"].items()),
                    ssd=",".join(f"{k}:{v}" for k, v in res["ssd"].items()),
                    prefill_ms=f"{res['prefill_ms']:.1f}",
                    decode_ms_per_step=f"{res['decode_ms']:.1f}",
                    peak_gib=f"{res['peak_gib']:.2f}",
                    card_free_gib_before_draws=(
                        f"{res['card_free_gib_before_draws']:.2f}"),
                    twin_prefill_ms=f"{twin['prefill_ms']:.1f}",
                    twin_decode_ms_per_step=f"{twin['decode_ms']:.1f}",
                    twin_peak_gib=f"{twin['peak_gib']:.2f}")
                if not res["cache_shapes_ok"]:
                    fail(f"serve_tp {tag} {dt} rank {r}: a cache block's "
                         "shape is not its CACHE_RULES block's")
                if res["logit_ratio"] > 1 or res["cache_ratio"] > 1:
                    fail(f"serve_tp {tag} {dt} rank {r}: logits at "
                         f"{res['logit_ratio']:.3f} and caches at "
                         f"{res['cache_ratio']:.3f} of their bounds")
                if (res["flash"][variant] != n_attn
                        or sum(res["flash"].values()) != n_attn
                        or res["ssd"][ssd_variant] != n_ssd
                        or sum(res["ssd"].values()) != n_ssd):
                    fail(f"serve_tp {tag} {dt} rank {r}: flash "
                         f"{res['flash']} (want {variant}:{n_attn}), SSD "
                         f"{res['ssd']} (want {ssd_variant}:{n_ssd})")
                for kind in ("flash", "flash_by_dim", "ssd"):
                    for k, v in res[kind].items():
                        totals[kind][k] = totals[kind].get(k, 0) + v
    say("dist", part="serve_tp_walls", twins_s=f"{t1 - t0:.1f}",
        ranks_s=f"{t2 - t1:.1f}")
    print(json.dumps(totals), flush=True)


def phase_serve_tp_child(entries: list) -> None:
    """The ``--serve-tp`` child; its flash and SSD launches join the
    kernels line's entries."""
    res = run_child("--serve-tp", SERVE_TP_CHILD_TIMEOUT_S)
    flash = next(e for e in entries if e["name"] == "flash_attention")
    ssd = next(e for e in entries if e["name"] == "ssd_intra_chunk")
    for d, n in res["flash_by_dim"].items():
        by_dim = flash["launches_by_head_dim_pair"]
        by_dim[d] = by_dim.get(d, 0) + n
    flash["launches"] += sum(res["flash"].values())
    ssd["launches"] += sum(res["ssd"].values())


def dryrun_world(world: str) -> None:
    """``--dryrun-world pod|multipod``: rank 0 of the production mesh under
    a fake process group (``launch.dryrun.run_cell``), ``DRYRUN_CELLS``;
    prints ``[dryrun]`` lines and one JSON line."""
    from repro_torch.launch.dryrun import run_cell

    out = {}
    for arch, shape in DRYRUN_CELLS:
        res = run_cell(arch, shape, world)
        coll = res["collectives_per_chip"]
        by_axis: dict = {}
        for kind, axes in coll.items():
            if kind != "total":
                for a, b in axes.items():
                    by_axis[a] = by_axis.get(a, 0.0) + b
        r, mem = res["roofline"], res["memory"]
        say("dryrun", world=world, ranks=res["n_chips"], arch=arch,
            shape=shape, kind=res["kind"], trace_s=res["trace_s"],
            flops_per_chip=f"{res['flops_per_chip']:.6g}",
            bytes_per_chip=f"{res['bytes_per_chip']:.6g}",
            collective_bytes=f"{coll['total']:.6g}",
            by_axis=",".join(f"{a}:{b:.4g}" for a, b in by_axis.items()),
            by_kind=",".join(f"{k}:{sum(v.values()):.4g}"
                             for k, v in coll.items() if k != "total"),
            compute_s=f"{r['compute_s']:.4g}",
            memory_s=f"{r['memory_s']:.4g}",
            collective_s=f"{r['collective_s']:.4g}",
            dominant=r["dominant"],
            pod_collective_bytes=f"{r['pod_collective_bytes']:.4g}",
            useful_flops_ratio=f"{res['useful_flops_ratio']:.4f}",
            argument_bytes=mem["argument_size_in_bytes"],
            output_bytes=mem["output_size_in_bytes"],
            alias_bytes=mem["alias_size_in_bytes"],
            peak_live_bytes=mem["peak_live_bytes_beyond_arguments"])
        if not (res["flops_per_chip"] > 0 and coll["total"] > 0
                and 0 < res["useful_flops_ratio"] <= 1):
            fail(f"dryrun {world} {arch} {shape}: {res}")
        out[f"{arch}/{shape}"] = res["trace_s"]
    print(json.dumps(out), flush=True)


def start_dryrun() -> dict:
    """Start ``[dryrun]``'s children, a fake world each (the pod's 256
    ranks and the multi-pod mesh's 512): host work on meta tensors, run
    beside the card phases that follow; a child still running when the
    script exits is killed."""
    procs = {world: start_child(f"--dryrun-world={world}")
             for world in ("pod", "multipod")}
    atexit.register(stop_children, list(procs.values()))
    return procs


def stop_children(procs) -> None:
    """Kill the children of ``procs`` that are still running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phases_child(names: list) -> None:
    """``--phases=a,b``: the phases ``names`` of the card's host-heavy
    tail, in order, in a child that runs beside the parent's card phases
    (``start_phases``); one JSON line, each phase's wall."""
    run = {"trace": phase_trace, "topo3d": phase_topo3d,
           "calibration": phase_calibration}
    card = card_line()
    walls = {}
    for name in names:
        t0 = time.perf_counter()
        run[name](card)
        walls[name] = time.perf_counter() - t0
    print(json.dumps(walls), flush=True)


def start_phases(names: tuple) -> tuple:
    """Start ``phases_child`` on ``names``; killed at exit if still
    running."""
    proc = start_child("--phases=" + ",".join(names))
    atexit.register(stop_children, [proc])
    return proc, names


def join_phases(started: tuple, walls: dict) -> None:
    """Wait for a ``start_phases`` child and print its lines; ``walls``
    gets each phase's wall in the child and the seconds waited here."""
    proc, names = started
    t0 = time.perf_counter()
    res = finish_child(proc, "--phases=" + ",".join(names),
                       BACKGROUND_TIMEOUT_S)
    walls.update(res)
    walls["_".join(names) + "_waited"] = time.perf_counter() - t0


def phase_dryrun(procs: dict) -> None:
    """``[dryrun]``: wait for ``start_dryrun``'s children and print their
    lines, with the seconds this phase waited for each."""
    t0 = time.perf_counter()
    try:
        for world, proc in procs.items():
            finish_child(proc, f"--dryrun-world={world}",
                         DRYRUN_CHILD_TIMEOUT_S)
            say("dryrun", world=world,
                waited_s=f"{time.perf_counter() - t0:.1f}")
    finally:
        stop_children(procs.values())


# ---------------------------------------------------------------------------
# xsim's batch split over cards: the main path's batch, the card listed 4 times
# ---------------------------------------------------------------------------
def phase_xsim_sharded(tr, geom, kw, one_launch: dict) -> int:
    """``[xsim_sharded]``: ``noc.xsim.run._run_sharded`` (the reference's
    ``pmap`` over its devices) on the 16x16 sweep's inputs over the card
    listed ``XSIM_SPLIT_DEVICES`` times: one ``cluster_smem`` launch a
    part, the launch counts set to 0 just before and read just after, the
    outputs and final planes bit-equal to the main path's one launch.
    Returns the launches."""
    import torch

    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc.xsim.run import _run_sharded, _shard_count

    B = tr["link"].shape[0]
    devices = [torch.device("cuda", torch.cuda.current_device())
               ] * XSIM_SPLIT_DEVICES
    D = _shard_count(B, len(devices))
    KERNEL.reset()
    split, ms = timed(lambda: _run_sharded(tr, geom, devices, **kw))
    launches, routes = KERNEL.launches, dict(KERNEL.variants)
    bad, err = compare(split, one_launch)
    say("xsim_sharded", grid="mesh16x16", instances=B, devices=len(devices),
        shards=D, instances_per_launch=B // D, launches=launches,
        variants=",".join(f"{k}:{n}" for k, n in routes.items()),
        equal_to_one_launch=not bad, max_abs_err=err, ms=f"{ms:.3f}")
    if bad:
        fail(f"the split batch differs from one launch: {', '.join(bad)}")
    if routes != {"cluster_smem": D, "block": 0}:
        fail(f"the split batch launched {routes}, expected {D} cluster_smem")
    return launches


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
        ms = profiled_ms(lambda: [fn() for _ in range(SEGMIN_ALONE_REPS)],
                         match)[0]
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


# ---------------------------------------------------------------------------
# 3-D and chiplet fabrics: the committed JAX artifact, full size, host sim
# ---------------------------------------------------------------------------
TOPO3D_ARTIFACT = ROOT / "benchmarks" / "results" / "topo3d_sweep.json"
# topo3d_sweep.json's latency grid: (artifact name, NoCConfig fabric, rate)
TOPO3D_GRID = (
    ("mesh3d-4x4x4", dict(n=4, m=4, topology="mesh3d",
                          topology_params=(4,)), 0.02),
    ("torus3d-4x4x4", dict(n=4, m=4, topology="torus3d",
                           topology_params=(4,)), 0.02),
    ("chiplet-2x2x4x4", dict(n=8, m=8, topology="chiplet",
                             topology_params=(2, 2)), 0.012),
)
TOPO3D_GRID_CYCLES = 160
# full size: a 3-D torus of 512 six-port routers and a package of 16 dies
# of 4x4 routers (default boundary routers and NoI weight), each with its
# drain grace; both take clusters of 8 ranks. The package drains for
# 1,600 cycles, the artifact's grace: its interposer crossings back MP's
# long label chains up, so at rate 0.01 MP still had worms in flight 400
# cycles after the last injection (all had landed by 1,600; the engine
# has no early exit, so the grace is paid in every run)
TOPO3D_FULL = (
    ("torus3d8x8x8", dict(n=8, m=8, topology="torus3d",
                          topology_params=(8,), drain_grace=400)),
    ("chiplet16x16", dict(n=16, m=16, topology="chiplet",
                          topology_params=(4, 4), drain_grace=1600)),
)
TOPO3D_FULL_K = 8
TOPO3D_RATES = (0.01, 0.03)
TOPO3D_CYCLES = 300
# the host cross-check: (name, NoCConfig fabric), DPM at rate 0.02
TOPO3D_HOST = (
    ("mesh3d4x4x4", dict(n=4, m=4, topology="mesh3d", topology_params=(4,))),
    ("chiplet8x8", dict(n=8, m=8, topology="chiplet",
                        topology_params=(2, 2))),
)


def hotspot_workload(cfg, rate, cycles, seed, hot_frac=0.35, region_size=8):
    """``benchmarks/topo3d_sweep.py``'s hotspot generator, copied as a
    fixture: uniform sources, but ``hot_frac`` of the multicasts draw their
    whole destination set from the ``region_size`` nodes around the fabric
    centre."""
    import random

    from repro_torch.noc.traffic import Request, Workload

    g = cfg.make_topology()
    nodes = g.nodes()
    rng = random.Random(seed)
    hot = g.from_idx(g.num_nodes // 2)
    region = sorted(nodes, key=lambda c: (g.distance(hot, c), g.idx(c)))
    region = region[:region_size]
    lo, hi = cfg.dest_range
    reqs = []
    for t in range(cycles):
        for src in nodes:
            if rng.random() >= rate:
                continue
            pool = region if rng.random() < hot_frac else nodes
            cand = [d for d in pool if d != src]
            k = min(rng.randint(lo, hi), len(cand))
            reqs.append(Request(t, src, rng.sample(cand, k)))
    return Workload(f"hotspot-{rate:.4f}", reqs, cycles)


def expect_cluster_only(where: str, K: int | None = None) -> dict:
    """Fail unless the cycle kernel launched since the last reset, on the
    cluster route only (with ``K`` ranks where given); return the counts
    and the launch's layout."""
    from repro_torch.kernels.noc_cycle import KERNEL

    launches, routes = KERNEL.launches, dict(KERNEL.variants)
    if launches <= 0:
        fail(f"{where}: the noc_cycle kernel never launched")
    if routes != {"cluster_smem": launches, "block": 0}:
        fail(f"{where}: took another route than cluster_smem: {routes}")
    if K is not None and KERNEL.cluster["K"] != K:
        fail(f"{where}: cluster of {KERNEL.cluster['K']} ranks, not {K}")
    return dict(launches=launches, **routes, cluster_k=KERNEL.cluster["K"])


def phase_topo3d(card: str) -> None:
    """The 3-D mesh/torus and chiplet fabrics through the port's planner,
    batched planning and xsim on the card:

    1. ``topo3d_sweep.json``'s latency grid (mesh3d and torus3d 4x4x4 at
       rate 0.02, the 2x2-die package at 0.012; 160 cycles, uniform seed
       1 and hotspot seed 2), MU/MP/NMP/DPM in one batched launch per
       fabric: every ``avg_latency`` (3 decimals), ``flit_traversals`` and
       ``drained`` equal to the artifact;
    2. full size, ``torus3d`` 8x8x8 (512 routers, six ports) and the
       16-die package (256 routers): MU/MP/NMP/DPM at rates 0.01 and 0.03,
       300 injection cycles, seed 13 (drain grace 400, the package 1,600),
       DPM through ``bulk_plan`` on the card
       (batched where ``batch_support`` admits the fabric: the 3-D torus;
       the package's cost bound is past f32's exact range, so its misses
       plan on the host) and every plan equal to host ``plan()``; the
       lowest rate drains; the launch counts (set to 0 just before) show the cluster
       route alone, with 8 ranks; both routes equal the plain cycle; the
       layout's shared memory equals the mirror; both routes timed in
       turns beside their bound;
    3. ``WormholeSim`` (``add_requests(device="cuda")``) against
       ``xsimulate`` on mesh3d 4x4x4 and the 2x2-die package: the same
       delivery sets, conserved counts and per-link flits."""
    import numpy as np
    import torch

    from repro_torch.core import (
        arena_clear, bulk_plan, plan, plan_cache_clear, planner_for,
    )
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc import (
        NoCConfig, WormholeSim, synthetic_workload, xsimulate,
    )

    t_phase = time.monotonic()
    want = {(r["fabric"], r["workload"]): r
            for r in json.loads(TOPO3D_ARTIFACT.read_text())["latency_grid"]}

    # ---- 1. the committed JAX artifact --------------------------------
    for name, fabric, rate in TOPO3D_GRID:
        cfg = NoCConfig(warmup=0, drain_grace=1600, multicast_fraction=0.5,
                        dest_range=(3, 6), **fabric)
        wls = [synthetic_workload(cfg, rate, TOPO3D_GRID_CYCLES, seed=1),
               hotspot_workload(cfg, rate, TOPO3D_GRID_CYCLES, seed=2)]
        arena_clear()
        plan_cache_clear()
        KERNEL.reset()
        t0 = time.monotonic()
        res = xsimulate(cfg, wls, MAIN_ALGOS, device="cuda")
        wall = time.monotonic() - t0
        counts = expect_cluster_only(name)
        if counts["launches"] != 1:
            fail(f"{name}: {counts['launches']} launches, not one batch")
        for w, shape in enumerate(("uniform", "hotspot")):
            row = want[name, shape]
            for a, algo in enumerate(res.algos):
                got = {
                    "avg_latency": round(float(res.avg_latency(w, a)), 3),
                    "flit_traversals": int(res.stats(w, a)
                                           .flit_link_traversals),
                    "drained": bool(res.all_drained(w, a)),
                }
                say("topo3d", part="artifact", fabric=name, workload=shape,
                    rate=rate, algo=algo,
                    requests=len(wls[w].requests),
                    **got, equal_to_artifact=got == row[algo])
                if got != row[algo]:
                    fail(f"{name} {shape} {algo}: {got}, the artifact "
                         f"has {row[algo]}")
        say("topo3d", part="artifact_run", fabric=name, instances=len(wls)
            * len(MAIN_ALGOS), cycles=res.cycles, wall_s=f"{wall:.3f}",
            device_s=f"{res.device_s:.6f}", **counts)

    # ---- 2. full size -------------------------------------------------
    for name, fabric in TOPO3D_FULL:
        cfg = NoCConfig(warmup=100, **fabric)
        g = cfg.make_topology()
        wls = [synthetic_workload(cfg, r, TOPO3D_CYCLES, seed=13)
               for r in TOPO3D_RATES]
        arena_clear()
        plan_cache_clear()
        KERNEL.reset()
        t0 = time.monotonic()
        res = xsimulate(cfg, wls, MAIN_ALGOS, device="cuda")
        wall = time.monotonic() - t0
        counts = expect_cluster_only(name, TOPO3D_FULL_K)
        cluster = dict(KERNEL.cluster)
        # DPM plans in batches on the card wherever ``batch_support``
        # admits the fabric (the reference's gate); where it does not,
        # ``bulk_plan`` plans every miss on the host into the same arena
        dpm = planner_for(g, "DPM", device="cuda")
        info = dpm.info()
        on_card = (info.batched_plans, info.host_plans)
        if (min(on_card) != 0 or max(on_card) <= 0
                or (info.batched_plans > 0) != dpm.support.ok):
            fail(f"{name}: DPM planned {info} with support {dpm.support}")
        support = "ok" if dpm.support.ok else repr(dpm.support.reason)
        for w, rate in enumerate(TOPO3D_RATES):
            for a, algo in enumerate(res.algos):
                st = res.stats(w, a)
                say("topo3d", part="full", fabric=name, rate=rate, algo=algo,
                    requests=len(wls[w].requests),
                    avg_latency=f"{st.avg_latency:.4f}",
                    dyn_energy_pj=f"{st.dyn_energy_pj(cfg.energy):.1f}",
                    flit_hops=st.flit_link_traversals,
                    drained=res.all_drained(w, a))
        for a, algo in enumerate(res.algos):
            if not res.all_drained(0, a):
                fail(f"{name}: {algo} did not drain at rate "
                     f"{TOPO3D_RATES[0]}")
        flit = int(res.ctr[:, 0].astype("int64").sum())
        say("topo3d", part="full_run", fabric=name, nodes=g.num_nodes,
            ports=g.ports, instances=len(wls) * len(MAIN_ALGOS),
            cycles=res.cycles, host_compile_s=f"{res.compile_s:.3f}",
            device_s=f"{res.device_s:.6f}", wall_s=f"{wall:.3f}",
            flit_hops=flit, threads=cluster["threads"],
            resident_clusters=cluster["resident_clusters"],
            dpm_batched_plans=info.batched_plans,
            dpm_host_plans=info.host_plans, dpm_batch_support=support,
            **counts)

        # every batched DPM plan against host plan() on the same requests
        reqs = [(r.src, r.dests) for wl in wls for r in wl.requests]
        plans = bulk_plan(g, reqs, "DPM", device="cuda")
        plan_cache_clear()
        t0 = time.monotonic()
        host = [plan("DPM", g, src, dests) for src, dests in reqs]
        host_s = time.monotonic() - t0
        bad = [i for i, (p, h) in enumerate(zip(plans, host)) if p != h]
        if bad:
            fail(f"{name}: bulk_plan != plan() on {len(bad)} of "
                 f"{len(reqs)} requests, first {reqs[bad[0]]}")
        say("topo3d", part="bulk_plan", fabric=name, requests=len(reqs),
            batched_plans=info.batched_plans, host_plans=info.host_plans,
            dispatches=info.dispatches, dpm_batch_support=support,
            equal_to_plan=True, host_plan_s=f"{host_s:.3f}")

        # both routes against the plain cycle on the run's own inputs
        tr, geom, kw = engine_inputs(res, cfg, "cuda")
        kerns, plain, p_ms = check_routes(name, tr, geom, kw,
                                          flit_hops=flit)
        if (KERNEL.cluster["K"] != TOPO3D_FULL_K
                or KERNEL.cluster["D"] != g.ports):
            fail(f"{name}: layout {KERNEL.cluster}")
        for variant, k in kerns.items():
            if not (k["ctr"].cpu().numpy() == res.ctr).all():
                fail(f"{name}: a {variant} run differs from xsimulate's")
        err = max(compare(k, plain)[1] for k in kerns.values())
        routes = time_routes(tr, geom, kw)
        b_ms, b_by, nbytes, ops = bound_ms(tr, kerns["cluster_smem"], kw)
        blk, cl = routes["block"][0], routes["cluster_smem"][0]
        say("topo3d", part="routes", fabric=name, ports=kw["L"] // kw["NN"],
            instances=tr["link"].shape[0], cycles=kw["T"],
            block_ms=f"{blk:.3f}", cluster_ms=f"{cl:.3f}",
            block_ms_runs=",".join(f"{t:.3f}" for t in routes["block"][1]),
            cluster_ms_runs=",".join(
                f"{t:.3f}" for t in routes["cluster_smem"][1]),
            block_over_cluster=f"{blk / cl:.2f}", max_abs_err=err,
            plain_ms=f"{p_ms:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bytes=nbytes, ops=ops, cluster_times_bound=f"{cl / b_ms:.1f}",
            card=repr(card))

    # ---- 3. the host simulator against xsim ---------------------------
    for name, fabric in TOPO3D_HOST:
        cfg = NoCConfig(**fabric)
        wl = synthetic_workload(cfg, HOST_SIM_RATE, HOST_SIM_CYCLES, seed=0)
        arena_clear()
        plan_cache_clear()
        res = xsimulate(cfg, [wl], ("DPM",), device="cuda")
        arena_clear()
        plan_cache_clear()
        t0 = time.monotonic()
        sim = WormholeSim(cfg, measure_window=(cfg.warmup, wl.horizon))
        sim.add_requests("DPM", wl.requests, device="cuda")
        torch.cuda.synchronize()
        info = planner_for(sim.g, "DPM", device="cuda").info()
        host = sim.run(wl.horizon + cfg.drain_grace, drain=True)
        host_s = time.monotonic() - t0
        if info.batched_plans <= 0:
            fail(f"{name}: add_requests planned nothing on the card")
        xst = res.stats(0, 0)
        checks = {
            "delivered_sets": res.delivered_sets(0, 0)
            == host_delivered_sets(sim),
            "flit_link_traversals": xst.flit_link_traversals
            == host.flit_link_traversals,
            "packets_created": xst.packets_created == host.packets_created,
            "packets_finished": xst.packets_finished
            == host.packets_finished,
            "link_flits": bool(np.array_equal(res.link_utilization(0, 0),
                                              host.telemetry.link_flits)),
            "drained": host.packets_finished == host.packets_created
            and res.all_drained(0, 0),
        }
        say("topo3d", part="host_sim", fabric=name, algo="DPM",
            requests=len(wl.requests), packets=host.packets_created,
            ports=sim.g.ports, avg_latency=f"{host.avg_latency:.4f}",
            xsim_latency=f"{xst.avg_latency:.4f}",
            batched_plans=info.batched_plans, host_s=f"{host_s:.3f}",
            **{f"xsim_{k}": v for k, v in checks.items()})
        failed = [k for k, v in checks.items() if not v]
        if failed:
            fail(f"{name}: host and xsim differ in {failed}")
    say("topo3d", part="phase", wall_s=f"{time.monotonic() - t_phase:.1f}")


# the trace phase: benchmarks/trace_replay.py's suite on its 4x4 mesh (its
# fault rungs: 1 then 2 broken links), topo3d_sweep.json's EP traces, then
# a 256-rank EP all-to-all on the 16x16 mesh (one expert per router, as in
# a 256-expert MoE layer), DPM run once more with two interior links dying
# at the start of the combine half
TRACE_ARTIFACT = ROOT / "benchmarks" / "results" / "trace_replay.json"
TRACE_FAULTS_4X4 = ((((1, 1), (1, 2)),),
                    (((1, 1), (1, 2)), ((3, 0), (3, 1))))
TRACE_FULL_RANKS = 256
TRACE_FULL_CHUNK = 256  # bytes: 16-flit worms
TRACE_FULL_GRACE = 400
TRACE_FULL_FAULTS = {"combine.r0": (((7, 7), (7, 8)), ((8, 3), (9, 3)))}
TRACE_HOST_EVERY = 32  # the host cross-check replays every 32nd phase
# the calibration phase: benchmarks/telemetry_calibration.py at full size
CALIBRATION_ARTIFACT = (ROOT / "benchmarks" / "results"
                        / "telemetry_calibration.json")
CALIBRATION_MODEL = "calibrated-bench"


def first_difference(got, want, path: str = "") -> str | None:
    """Where two JSON-like values first differ (None if equal)."""
    if isinstance(want, dict) and isinstance(got, dict):
        for k in want:
            if k not in got:
                return f"{path}.{k} missing"
            d = first_difference(got[k], want[k], f"{path}.{k}")
            if d:
                return d
        extra = sorted(set(got) - set(want))
        return f"{path}: extra keys {extra}" if extra else None
    if isinstance(want, list) and isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: {len(got)} entries, want {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = first_difference(a, b, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if got == want else f"{path}: {got!r}, want {want!r}"


def phase_trace(card: str) -> None:
    """ML-workload trace replay through the port's host simulator and its
    xsim on the card (``noc.trace``), collectives scheduled by DPM
    (``dist.multicast``):

    1. ``benchmarks/results/trace_replay.json`` on its 4x4 mesh with the
       suite's producers and arguments: every trace through
       ``cross_validate(device="cuda")`` under MU/MP/NMP/DPM, the ring
       all-to-all against DPM's schedule, the fault ladder (1 and 2 broken
       links); every number of the file must come out equal;
    2. ``topo3d_sweep.json``'s ``ep_dispatch_traces``: the 64-rank EP
       all-to-all through ``replay_xsim`` under MU and DPM on torus3d
       4x4x4 and the 2x2-die package (drain grace 1,600): 126 phases and
       the file's total cycles (JAX xsim alone made them);
    3. full size: ``ep_dispatch_trace(256, chunk_bytes=256)`` on the 16x16
       mesh (510 phases, 130,560 events), through ``replay_xsim`` under MU,
       DPM and DPM with two links failing at the first combine round: one
       cycle-kernel launch each with B = 510, the counts set to 0 just
       before (the cluster route alone), every phase drained; both routes
       equal to the plain cycle on the DPM run's inputs and timed in turns
       beside the bound; every 32nd phase cross-validated on the host."""
    import torch

    from repro_torch.core import (
        arena_clear, faulty, plan_cache_clear, planner_for, torus,
    )
    from repro_torch.dist import alltoall_schedule, ring_alltoall_schedule
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc import NoCConfig
    from repro_torch.noc.trace import (
        Trace, coherence_trace, compressed_allreduce_trace, cross_validate,
        ep_dispatch_trace, from_schedule, model_collective_mix, replay_xsim,
        serving_trace, zero1_gather_trace,
    )

    t_phase = time.monotonic()
    want = json.loads(TRACE_ARTIFACT.read_text())

    # ---- 1. trace_replay.json ------------------------------------------
    cfg = NoCConfig(n=4, topology="mesh")
    KERNEL.reset()
    traces = [
        ep_dispatch_trace(16, chunk_bytes=96),
        zero1_gather_trace(16, param_bytes=4096),
        compressed_allreduce_trace(16, grad_bytes=65536),
        coherence_trace(16, num_bursts=4, lines_per_burst=3, sharers=3,
                        seed=1),
        serving_trace(16, num_requests=16, rate=0.02, seed=2),
        model_collective_mix("smollm-135m", 16, scale_to=256),
    ]
    xsim_runs = 0
    replays = {}
    for tr in traces:
        t0 = time.monotonic()
        per_algo = {}
        for algo in want["algos"]:
            h, x = cross_validate(tr, cfg, algo, device="cuda")
            xsim_runs += 1
            per_algo[algo] = {
                "total_cycles_host": h.total_cycles,
                "total_cycles_xsim": x.total_cycles,
                "phase_cycles": h.phase_cycles,
            }
        if Trace.from_json(tr.to_json()) != tr:
            fail(f"{tr.name}: the JSON round trip changed the trace")
        replays[tr.name] = {
            "kind": tr.meta.get("kind", "?"), "phases": len(tr.phases),
            "events": tr.num_events, "algos": per_algo,
            "json_bytes": len(tr.to_json()),
        }
        diff = first_difference(replays[tr.name],
                                want["replays"].get(tr.name))
        say("trace", part="artifact", trace=tr.name,
            phases=len(tr.phases), events=tr.num_events,
            json_bytes=len(tr.to_json()),
            cycles=",".join(f"{a}:{v['total_cycles_host']}/"
                            f"{v['total_cycles_xsim']}"
                            for a, v in per_algo.items()),
            wall_s=f"{time.monotonic() - t0:.2f}",
            equal_to_artifact=diff is None)
        if diff:
            fail(f"trace_replay.json differs at {tr.name}{diff}")
    ep = traces[0]
    ring = from_schedule(ring_alltoall_schedule(16), "ep_alltoall.n16.ring",
                         ep.meta["chunk_bytes"], phase_prefix="shift.r")
    ring2 = Trace(ring.name, ring.num_ranks, ring.phases + ring.phases,
                  {"kind": "ep_alltoall_ring"})
    hr, xr = cross_validate(ring2, cfg, "DPM", device="cuda")
    xsim_runs += 1
    sched_cmp = {
        "dpm_schedule_cycles": replays[ep.name]["algos"]["DPM"][
            "total_cycles_host"],
        "ring_schedule_cycles": hr.total_cycles,
        "ring_schedule_cycles_xsim": xr.total_cycles,
        "dpm_rounds": len(ep.phases), "ring_rounds": len(ring2.phases),
    }
    fault_rows = {}
    for tr in traces[:2]:
        ladder = []
        for links in TRACE_FAULTS_4X4:
            dcfg = NoCConfig(n=4, topology="mesh", broken_links=links)
            h, x = cross_validate(tr, dcfg, "DPM", device="cuda")
            xsim_runs += 1
            ladder.append({"broken_links": len(links),
                           "total_cycles_host": h.total_cycles,
                           "total_cycles_xsim": x.total_cycles})
        fault_rows[tr.name] = ladder
    for key, got in (("schedule_comparison", sched_cmp),
                     ("fault_ladder", fault_rows)):
        diff = first_difference(got, want[key])
        say("trace", part="artifact", row=key,
            values=json.dumps(got, separators=(",", ":")),
            equal_to_artifact=diff is None)
        if diff:
            fail(f"trace_replay.json differs at {key}{diff}")
    counts = expect_cluster_only("trace artifact")
    if counts["launches"] != xsim_runs:
        fail(f"trace artifact: {counts['launches']} launches for "
             f"{xsim_runs} xsim replays")
    say("trace", part="artifact_runs", xsim_replays=xsim_runs,
        wall_s=f"{time.monotonic() - t_phase:.1f}", **counts)

    # ---- 2. topo3d_sweep.json's EP traces ------------------------------
    rows = {(r["fabric"], r["algo"]): r
            for r in json.loads(TOPO3D_ARTIFACT.read_text())[
                "ep_dispatch_traces"]}
    for name, fabric, _rate in TOPO3D_GRID[1:]:
        tcfg = NoCConfig(warmup=0, drain_grace=1600, **fabric)
        nn = tcfg.make_topology().num_nodes
        tr = ep_dispatch_trace(nn, chunk_bytes=256, algo="DPM")
        for algo in ("MU", "DPM"):
            KERNEL.reset()
            rr = replay_xsim(tr, tcfg, algo, device="cuda")
            counts = expect_cluster_only(f"{name} EP trace")
            got = {"fabric": name, "trace": tr.name, "algo": algo,
                   "phases": len(rr.phase_cycles),
                   "total_cycles": int(sum(rr.phase_cycles))}
            res = rr.xsim_results
            say("trace", part="topo3d_artifact", fabric=name, algo=algo,
                trace=tr.name, phases=got["phases"],
                total_cycles=got["total_cycles"], instances=len(tr.phases),
                cycles=res.cycles, device_s=f"{res.device_s:.6f}",
                wall_s=f"{res.wall_s:.3f}",
                equal_to_artifact=got == rows.get((name, algo)), **counts)
            if got != rows.get((name, algo)):
                fail(f"topo3d_sweep.json ep_dispatch_traces: {got}, the "
                     f"artifact has {rows.get((name, algo))}")

    # ---- 3. full size: 256-rank EP all-to-all on the 16x16 mesh --------
    fcfg = NoCConfig(n=16, warmup=0, drain_grace=TRACE_FULL_GRACE)
    g = fcfg.make_topology()
    alltoall_schedule.cache_clear()
    t0 = time.monotonic()
    # the producer's call below hits this one in alltoall_schedule's cache
    sched = alltoall_schedule(TRACE_FULL_RANKS, "DPM", device="cuda")
    sched_s = time.monotonic() - t0
    ring_info = planner_for(torus(TRACE_FULL_RANKS, 1), "DPM",
                            device="cuda").info()
    t0 = time.monotonic()
    tr = ep_dispatch_trace(TRACE_FULL_RANKS, chunk_bytes=TRACE_FULL_CHUNK)
    lower_s = time.monotonic() - t0
    if (len(tr.phases), tr.num_events) != (2 * (TRACE_FULL_RANKS - 1),
                                           TRACE_FULL_RANKS
                                           * (TRACE_FULL_RANKS - 1) * 2):
        fail(f"{tr.name}: {len(tr.phases)} phases, {tr.num_events} events")
    say("trace", part="full_schedule", ranks=TRACE_FULL_RANKS,
        rounds=sched.num_rounds, transfers=sum(map(len, sched.rounds)),
        hops=sched.total_hops, schedule_s=f"{sched_s:.3f}",
        batched_plans=ring_info.batched_plans,
        host_plans=ring_info.host_plans, lower_trace_s=f"{lower_s:.3f}",
        phases=len(tr.phases), events=tr.num_events)
    totals = {}
    dpm = None
    for label, algo, faults in (("MU", "MU", None), ("DPM", "DPM", None),
                                ("DPM+2links", "DPM", TRACE_FULL_FAULTS)):
        arena_clear()
        plan_cache_clear()
        KERNEL.reset()
        t0 = time.monotonic()
        rr = replay_xsim(tr, fcfg, algo, phase_broken_links=faults,
                         device="cuda")
        wall = time.monotonic() - t0
        counts = expect_cluster_only(f"{tr.name} {label}")
        if counts["launches"] != 1:
            fail(f"{tr.name} {label}: {counts['launches']} launches")
        cluster = dict(KERNEL.cluster)
        res = rr.xsim_results
        info = planner_for(g, "DPM", device="cuda").info()
        degraded = (planner_for(faulty(g, faults["combine.r0"]), "DPM",
                                device="cuda").info()
                    if faults else None)
        totals[label] = rr.total_cycles
        faulted = sum(f is not None for f in rr.phase_faults)
        say("trace", part="full", trace=tr.name, run=label,
            phases=len(rr.phase_cycles), total_cycles=rr.total_cycles,
            max_phase_cycles=max(rr.phase_cycles),
            phases_with_faults=faulted, drained=True,
            instances=res.dtime.shape[0], cycles=res.cycles,
            compile_s=f"{res.compile_s:.3f}", device_s=f"{res.device_s:.6f}",
            xsim_wall_s=f"{res.wall_s:.3f}", wall_s=f"{wall:.3f}",
            dpm_batched_plans=info.batched_plans,
            dpm_host_plans=info.host_plans,
            degraded_dpm_batched_plans=(degraded.batched_plans
                                        if degraded else 0),
            degraded_dpm_host_plans=degraded.host_plans if degraded else 0,
            threads=cluster["threads"],
            resident_clusters=cluster["resident_clusters"], **counts)
        if label == "DPM":
            dpm = (rr, res)
    say("trace", part="full_totals", trace=tr.name,
        **{k.replace("+", "_"): v for k, v in totals.items()},
        drain_grace=TRACE_FULL_GRACE)

    rr, res = dpm
    tr_in, geom, kw = engine_inputs(res, fcfg, "cuda")
    kerns, plain, p_ms = check_routes("ep256_mesh16x16", tr_in, geom, kw)
    for variant, k in kerns.items():
        if not (k["ctr"].cpu().numpy() == res.ctr).all():
            fail(f"ep256: a {variant} run differs from replay_xsim's")
    err = max(compare(k, plain)[1] for k in kerns.values())
    routes = time_routes(tr_in, geom, kw)
    b_ms, b_by, nbytes, ops = bound_ms(tr_in, kerns["cluster_smem"], kw)
    blk, cl = routes["block"][0], routes["cluster_smem"][0]
    say("trace", part="routes", grid="ep256_mesh16x16",
        instances=tr_in["link"].shape[0], cycles=kw["T"],
        block_ms=f"{blk:.3f}", cluster_ms=f"{cl:.3f}",
        block_ms_runs=",".join(f"{t:.3f}" for t in routes["block"][1]),
        cluster_ms_runs=",".join(
            f"{t:.3f}" for t in routes["cluster_smem"][1]),
        block_over_cluster=f"{blk / cl:.2f}", max_abs_err=err,
        plain_ms=f"{p_ms:.1f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
        bytes=nbytes, ops=ops, cluster_times_bound=f"{cl / b_ms:.1f}",
        card=repr(card))

    # the host simulator on every 32nd phase of the DPM run
    sub = Trace(tr.name, TRACE_FULL_RANKS, tr.phases[::TRACE_HOST_EVERY],
                tr.meta)
    t0 = time.monotonic()
    h, x = cross_validate(sub, fcfg, "DPM", device="cuda")
    host_s = time.monotonic() - t0
    picked = {ph.name: c for ph, c in zip(tr.phases, rr.phase_cycles)}
    same = all(picked[n] == c for n, c in zip(x.phase_names,
                                             x.phase_cycles))
    if not same:
        fail("ep256: the sub-trace's xsim phases differ from the full run")
    say("trace", part="host_cross_check", phases=len(sub.phases),
        delivery_sets_equal=True, host_cycles=h.total_cycles,
        xsim_cycles=x.total_cycles,
        rel_diff=f"{abs(h.total_cycles - x.total_cycles) / x.total_cycles:.4f}",
        xsim_equal_to_full_run=same, wall_s=f"{host_s:.2f}")
    torch.cuda.synchronize()
    say("trace", part="phase", wall_s=f"{time.monotonic() - t_phase:.1f}")


def phase_calibration(card: str) -> None:
    """``benchmarks/results/telemetry_calibration.json`` on the card: the
    closed calibration loop at its 16x16 size (warmup 0, drain grace 4,000,
    40% multicast of 3-6 destinations, rate 0.03, 200 cycles, seed 5, up to
    8 iterations), every iteration's latency, peak link load and plan
    changes equal to the file, then the three-rate sweep under hop
    counting, the analytic contention model and the calibrated model, and
    the measured energy constants. Each xsim run launches the cycle kernel
    once (the counts set to 0 just before the loop, the cluster route
    alone); the model is unregistered in a ``finally``."""
    from repro_torch.core import EnergyCost, unregister_cost_model
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc import (
        NoCConfig, calibrate_cost_model, synthetic_workload, xsimulate,
    )

    want = json.loads(CALIBRATION_ARTIFACT.read_text())
    n = int(want["mesh"].split("x")[0])
    cycles, rate = want["cycles"], want["calibration_rate"]
    cfg = NoCConfig(n=n, warmup=0, drain_grace=4000,
                    multicast_fraction=0.4, dest_range=(3, 6))
    wl = synthetic_workload(cfg, rate, cycles, seed=5)
    try:
        KERNEL.reset()
        res = calibrate_cost_model(cfg, wl, "DPM", name=CALIBRATION_MODEL,
                                   max_iters=8, device="cuda")
        counts = expect_cluster_only("calibration loop")
        if counts["launches"] != len(res.iterations):
            fail(f"calibration: {counts['launches']} launches for "
                 f"{len(res.iterations)} iterations")

        def measure(r, cost_model):
            w = synthetic_workload(cfg, r, cycles, seed=5)
            x = xsimulate(cfg, [w], ("DPM",), cost_model=cost_model,
                          device="cuda")
            return {
                "avg_latency": round(float(x.avg_latency(0, 0)), 3),
                "max_link_flits": int(x.link_utilization(0, 0).max(
                    initial=0)),
            }

        t0 = time.monotonic()
        sweep = [{"rate": pt["rate"],
                  "hops": measure(pt["rate"], None),
                  "contention": measure(pt["rate"], "contention"),
                  "calibrated": measure(pt["rate"], CALIBRATION_MODEL)}
                 for pt in want["sweep"]]
        sweep_s = time.monotonic() - t0
    finally:
        unregister_cost_model(CALIBRATION_MODEL)
    got = res.to_dict()
    for it in got["iterations"]:
        say("calibration", iter=it["iter"], model=it["model"],
            avg_latency=repr(it["avg_latency"]),
            max_link_flits=it["max_link_flits"],
            plans_changed_vs_baseline=it["plans_changed_vs_baseline"],
            plans_changed_vs_prev=it["plans_changed_vs_prev"])
    diff = first_difference(got, want["calibration"])
    analytic = EnergyCost(cfg.energy, cfg.flits_per_packet)
    energy = {
        "analytic_per_worm_hop": round(analytic._per_hop, 3),
        "measured_per_worm_hop": round(res.energy._per_hop, 3),
        "analytic_per_worm": round(analytic._per_packet, 3),
        "measured_per_worm": round(res.energy._per_packet, 3),
    }
    t = res.timing
    say("calibration", part="loop", converged=res.converged,
        best_iter=res.best_iter,
        baseline_latency=repr(res.baseline_latency),
        calibrated_latency=repr(res.calibrated_latency),
        plans_changed=res.plans_changed, requests=len(wl.requests),
        wall_s=f"{t['wall_s']:.2f}",
        host_signature_s=f"{t['signature_s']:.2f}",
        host_planner_tables_s=f"{t['planner_s']:.2f}",
        host_compile_s=f"{t['compile_s']:.2f}",
        device_s=f"{t['device_s']:.4f}",
        dpm_misses_on_card=t["batched_plans"],
        dpm_misses_on_host=t["host_plans"], equal_to_artifact=diff is None,
        **counts)
    if diff:
        fail(f"telemetry_calibration.json differs at calibration{diff}")
    for pt in sweep:
        say("calibration", part="sweep", rate=pt["rate"],
            **{f"{k}_latency": pt[k]["avg_latency"]
               for k in ("hops", "contention", "calibrated")},
            **{f"{k}_max_link_flits": pt[k]["max_link_flits"]
               for k in ("hops", "contention", "calibrated")})
    for key, got_v in (("sweep", sweep), ("energy_constants_pj", energy)):
        diff = first_difference(got_v, want[key])
        say("calibration", part=key, equal_to_artifact=diff is None,
            **({"sweep_s": f"{sweep_s:.2f}"} if key == "sweep" else energy))
        if diff:
            fail(f"telemetry_calibration.json differs at {key}{diff}")
    say("calibration", part="phase", card=repr(card))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    t_start, walls = time.perf_counter(), {}
    os.environ.setdefault("CHIP_SMOKE_T0", repr(time.time()))
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    go = os.environ.pop("CHIP_SMOKE_GO", None)
    if go is not None:
        warm_wait(Path(go))
    if sys.argv[1:2] and sys.argv[1].startswith("--phases="):
        phases_child(sys.argv[1].split("=", 1)[1].split(","))
        return
    if sys.argv[1:] == ["--serve-kernel-alone"]:
        serve_kernel_alone()
        return
    if sys.argv[1:] == ["--prefill-profile"]:
        prefill_profile()
        return
    if sys.argv[1:] == ["--serve-moe"]:
        serve_moe()
        return
    if sys.argv[1:] == ["--serve-mla"]:
        serve_mla()
        return
    if sys.argv[1:] == ["--serve-frames"]:
        serve_frames()
        return
    if sys.argv[1:] == ["--train"]:
        train_child()
        return
    if sys.argv[1:] == ["--train-mla"]:
        train_mla_child()
        return
    if sys.argv[1:] == ["--train-ssd"]:
        train_ssd_child()
        return
    if sys.argv[1:] == ["--dist"]:
        dist_child()
        return
    if sys.argv[1:] == ["--serve-tp"]:
        serve_tp_child()
        return
    if sys.argv[1:2] and sys.argv[1].startswith("--dryrun-world="):
        dryrun_world(sys.argv[1].split("=", 1)[1])
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
    card = card_line()
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    print(card, flush=True)

    import repro_torch.noc as noc
    from repro_torch.kernels.noc_cycle import KERNEL
    from repro_torch.noc import NoCConfig, synthetic_workload, xsimulate

    if "jax" in sys.modules or "repro" in sys.modules:
        fail("the port imported jax or the reference package")

    # ---- 2. build: phases 3-4 start once their libraries are built; the
    # attention and SSD builds end beside them --------------------------
    warm(WARM_NEXT[None])
    build = start_build()
    for name in ("noc_cycle", "dpm_cost", "noc_step"):
        build[1][name].result()

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

    finish_build(build)
    walls["phases_1_to_4"] = time.perf_counter() - t_start

    def walled(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    # ---- 4b. the main path's batch split over the card listed 4 times ----
    split_launches = walled("xsim_sharded", phase_xsim_sharded, tr, geom, kw,
                            kern)
    launches += split_launches

    # ---- 5. cost-table kernels and the planning path ---------------------
    dpm_entries = walled("cost_tables", phase_cost_tables, cfg)

    # ---- 6. batched planning and the plan server -------------------------
    walled("bulk_plan", phase_bulk_plan, cfg)

    # ---- 7. the ML serving path: hymba-1.5b, flash attention, SSD --------
    serve_entries, alone_ms = walled("serve", phase_serve)

    # ---- 7b. MoE serving: moonshot-v1-16b-a3b, flash attention at D = 128
    walled("serve_moe", phase_serve_child, "--serve-moe", "moonshot",
           serve_entries, alone_ms)

    # ---- 7c. MLA serving: deepseek-v2-236b, flash attention at D = 192
    walled("serve_mla", phase_serve_child, "--serve-mla", "mla",
           serve_entries, alone_ms)

    # [trace] (11) in a child beside 7d-7e', the card's room left by them
    trace_child = start_phases(("trace",))

    # ---- 7d. frame models: musicgen-medium, qwen2-vl-72b; the int8 cache
    walled("serve_frames", phase_serve_child, "--serve-frames", "frames",
           serve_entries, alone_ms)

    # the dry run's children (7h) work on the host beside 7e-7g
    dryrun_procs = start_dryrun()

    # ---- 7e. training: stablelm-1.6b, the flash backward kernel ----------
    walled("train", phase_train_child, serve_entries)

    # ---- 7e'. MLA training: deepseek-v2-236b's dense layer, the flash
    # forward and backward at the head-dim pair (192, 128) -----------------
    walled("train_mla", phase_train_mla_child, serve_entries)

    # [train_ssd] times the SSD backward with the card its own
    join_phases(trace_child, walls)

    # ---- 7e''. SSD training: hymba-1.5b and mamba2-1.3b, the SSD backward
    # kernel --------------------------------------------------------------
    walled("train_ssd", phase_train_ssd_child, serve_entries)

    # ---- 7f. dist: four ranks, DPM executors, compress, EP, pipeline,
    # ZeRO-1, elastic restore, tensor parallelism, MoE over data ranks ----
    walled("dist", phase_dist_child, serve_entries)

    # [topo3d] and [calibration] (10, 12) in a child beside 7g
    tail_child = start_phases(("topo3d", "calibration"))

    # ---- 7g. serving on a (2, 2) mesh: four ranks' blocks, CACHE_RULES --
    walled("serve_tp", phase_serve_tp_child, serve_entries)

    # ---- 7h. the dry run: rank 0 of each production mesh, fake group ----
    walled("dryrun", phase_dryrun, dryrun_procs)
    join_phases(tail_child, walls)

    # ---- 8. the segmented-min kernel through segmin / arbitrate ----------
    segmin_entries = walled("segmin", phase_segmin)

    # ---- 9. the host NoC: WormholeSim, simulate, against xsim -------------
    walled("host_sim", phase_host_sim)

    # 10. 3-D and chiplet fabrics, 11. ML-workload traces and DPM-scheduled
    # collectives, 12. the telemetry calibration loop: in the children
    # above
    say("walls", total_s=f"{time.perf_counter() - t_start:.1f}",
        **{f"{k}_s": f"{v:.1f}" for k, v in walls.items()})

    # ---- 13. kernels line and result --------------------------------------
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
