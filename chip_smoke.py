#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it computes.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

``python3 chip_smoke.py --sp-control`` builds the kernels and runs phase
22's checks alone, then its gradient check with a fault planted: one step
of each train run a fault concerns, at two ranks, against one process.
The faults: the halo's gradients dropped (the UNets); the ring's last hop
home skipped (the UNets and the ViT); every rank adding rank 0's share of
the ViT's position embedding; the ViT's dropout masks drawn per rank
instead of cut from the global draw. It exits 0 when the run as is stays
within the limits and each fault goes beyond in every run it concerns.

Phases, each ending with one line that carries its elapsed seconds:

0. card: the device name and the power limit ``nvidia-smi`` reports;
1. build: the port's kernels, compiled from ``itsd_tpu_torch/csrc`` by one
   nvcc per source, all started together, and a link (its time and the
   ``-Xptxas -v`` registers and spills; a spill fails the run); the
   ``HGMMA`` and ``UTMALDG`` instructions of each Hopper kernel (the mma
   route's forward, dq and dk/dv) in ``cuobjdump -sass`` of the library,
   none of either failing the run;
2. forward kernels: GroupNorm+swish and flash attention against their
   plain PyTorch versions at every shape the eval path (batch 8) and the
   train path (batch 128) give them, and the CFG model's guided eval
   (batch 16 inside the guidance interval, 8 outside) and train path
   (batch 256), in bf16 and f32, timed beside the plain version, one
   PyTorch library call and the least time the card could take. The flash
   forward has three kernels: two on the tensor cores ("mma", the route of
   bf16 at C <= 256, and "wide", of bf16 at 256 < C <= 1024: the CFG
   model's C=512 and C=1024) and the CUDA-core one ("simt", the route of
   f32); the simt kernel is checked and timed on the same bf16 inputs as
   the tensor-core one at every shape, and where bf16 takes mma, the
   mma.sync forward that the Hopper kernel replaced (forced calls, timed
   in turns with it). Also at Picard's folded batches
   (phase 13's time grid of 50 points in the batch: 400 rows for the
   unconditional UNet, 800 for the guided CFG UNet) and at phase 15's
   search folds (32 rows for the unconditional UNet: 4 chunked candidates,
   pruned survivors, paths or neighbours of batch 8; 64 and 32 for the CFG
   UNet: 4 candidates and 2 survivors of the dual batch 16) and phase
   17's tracked batches (64 rows; the CFG UNet's dual 128); phase 15
   fails on an attention batch that this phase did not hold. The flash
   forward also at the 256x256 flagship's attention, [1, 4096, 384] (bf16: wide).
   GroupNorm also at the 256x256 flagship's largest spans (batch 1, spans
   of up to 786,432 elements, split over a thread-block cluster): forward
   and backward in f32 and bf16, two launches equal bit for bit, timed.
   Then at phase 19's fine-tune shapes (the flagship at batch 48: every
   GroupNorm of its forward, attention at [48, 4096, 384] and
   [48, 1024, 512], wide in bf16) and phase 20's ViT (12 heads of 64
   folded into the batch: [192, 256, 64] at train batch 16, [96, 256, 64]
   at eval batch 8; mma in bf16) and phase 22's ViT on the rows of one of
   2 ranks (each call's two ring hops at [24, 128, 64], with lse; phase 5
   checks and times its dq and dk/dv there too). Then GroupNorm over row
   shards (phase
   22): the stats kernel (each span's f32 sum, and its sum of squared
   deviations around a given mean) and the apply kernel against their
   plain versions at every GroupNorm call of the flagship's forward at
   batch 2 and the CIFAR UNet's at batch 8, each call's rows cut over 2 and
   4 seq ranks, in bf16 and f32, two launches equal bit for bit, with the
   earlier stats kernel it replaced (a forced call) held to the same
   limits, timed beside the plain versions, ``torch.sum`` over the span
   (beside the sum's launches), the bound, the earlier stats kernel in
   turns with it, and an empty kernel on its grid (a launch's own cost);
   and each call cut into 2 and 4 row slices, whose stats, summed, must
   equal the stats kernel's on the whole and whose outputs, normalized with
   the global statistics, the fused kernel's;
3. eval path: ``runner.evaluate`` at the full width of the CIFAR-10 UNet
   (ch 128, ch_mult 1,2,2,2, attention at 16x16, batch 8, 32x32, bf16,
   T=1000) on seeded weights; the kernels' launch counts must be exactly
   51 and 6 per step, all 6 flash forwards on the mma route, and the
   images finite;
4. eval path parity: kernel path against plain path, in f32 (the simt
   route) and in bf16 (the mma route): one full-width UNet forward (eps)
   at timesteps across the chain, and 20 denoising steps from one x_T with
   one fed noise sequence;
5. backward: the dq and dk/dv kernels (each on its bf16 route and on
   simt, as in phase 2; both on the wide route at C=512 and C=1024 and at
   the flagship's C=384; where bf16 takes mma, the mma.sync dq and dk/dv
   that the Hopper kernels replaced too, each timed in turns with its
   Hopper kernel) against their
   plain versions at both train
   paths' shapes, gradient search's (the unconditional eval batch 8 and
   the CFG dual batch 16), one more C and the flagship's [1, 4096, 384],
   in bf16 and f32, with a nonzero dlse once, timed beside the plain
   versions, the
   backward of ``F.scaled_dot_product_attention`` and their bound; every
   dq and dk/dv must take the route ``route`` names; the GroupNorm
   backward (autograd through the plain recompute) checked and timed;
6. train-step parity: 3 steps of the kernel path against the plain path at
   full width and batch 128 (dropout 0, the same params, batches, t and
   noise), in f32 (simt) and bf16 (mma): loss, pre-clip gradient norm, max
   |dparam|;
7. train path: ``runner.train`` at the configuration of
   ``configs/cifar10_uncond.yaml`` on the shapes dataset (batch 128, lr
   2e-4, dropout 0.1, bf16) for 64 steps; exactly 6/6/6/51 launches a step
   of flash forward / dq / dk-dv / GroupNorm, the forwards, dq and dk/dv all
   on the mma route; a finite, falling loss; the checkpoint restored for one
   more step and for an eval; ms per step, images/s, peak memory and the
   device's busy share (``torch.profiler``); ``train.profile_steps=2``
   writes a Chrome trace of the first two steps (regions step_0 and
   step_1, with the card's kernels);
8. CUDA tests: ``python -m pytest --noconftest -m cuda -q
   tests/test_torch_cuda.py`` in a subprocess, against the library built in
   phase 1; its pass count is printed and a failure fails the run (it runs
   after phase 12);
9. guided eval path: ``runner.evaluate`` of the conditional UNet at the
   full width of ``configs/cifar10_cfg.yaml`` (ch 128, ch_mult
   1,4,8,8,4,2, 548 M parameters, bf16) on seeded weights, batch 8: CFG
   w=1.8 over the config's T=3000 chain cut to its first 125 steps'
   table rows (T=125), CFG on 30 <= t < 70 and autoguidance (a second
   seeded weight file) over a chain cut to T=100;
   exact launches a step (78 GroupNorm and 13 flash forwards, 5 on mma
   and 8 on wide, at batch 16 inside the interval and 8 outside;
   autoguidance twice that at batch 8), no synchronizing CUDA operation
   in the sampler (PyTorch's sync debug mode), finite images, ms a step
   and images/s;
10. guided path parity: kernel path against plain path in f32 and bf16:
    one conditional forward and one guided eps at timesteps across the
    chain, then 20 guided steps (an interval inside them) from one x_T
    with one fed noise sequence;
11. conditional train-step parity: 3 steps of the kernel path against the
    plain path at full width and batch 128, with the same labels, t, noise
    and label-dropout masks, in f32 and bf16;
12. conditional train path: ``runner.train`` at the configuration of
    ``configs/cifar10_cfg.yaml`` on the shapes dataset with 10 labels
    (batch 256, bf16, no tracked metrics, the config's representation
    extraction every 50 batches) for 64 steps; exactly 78/13/13/13
    launches a step (the forward, dq and dk/dv each 5 on mma, 8 on wide
    and none on simt) besides the extraction's forwards; a finite, falling
    loss; the representations' .npz files, one an epoch, and the
    statistics of ``python -m itsd_tpu_torch.cli.analyze`` on them; the
    checkpoint restored
    for one more step and, through the eval loader, for 25 guided steps
    of its T=3000 chain; ms per step, images/s, peak memory and the
    device's busy share (it runs after phase 16);
13. fast and composite samplers: ``runner.evaluate`` at full width, bf16,
    batch 8: the unconditional UNet (T=1000) through DDIM 50 at eta 0 and
    1, DPM-Solver++ 20, restart sampling on (600, 300, 2) over DDIM 50,
    Picard 50 (its grid folded into a batch of 400; sweeps, and its wall
    time against sequential DDIM 50); the CFG UNet
    (T=3000, w=1.8) through DDIM 50, DPM-Solver++ 20 guided on
    30 <= t < 70, DDIM 50 with autoguidance and Picard 50 (batch 800);
    exact launches per model forward, the attention batch of every call,
    no synchronizing CUDA operation (Picard: exactly one a sweep, the read
    of its stopping test), finite images; NFE, ms per NFE, ms per image,
    images/s;
14. fast sampler parity: kernel path against plain path in f32 and bf16:
    the unconditional DDIM over its whole 50-step chain, DPM-Solver++ 20,
    Picard (max_iters = n = 20) against sequential DDIM at a (T, n) where
    the two grids agree, and 20 guided DDIM steps of the CFG UNet; each
    limit the sampler's rms chain gain times the eps limit of phases 4
    and 10;
15. search: a SmallCNN classifier trained here on shapes (32x32) with the
    port's ``train_classifier``, then ``runner.run_search`` at full width,
    bf16, batch 8, scored by it (``search.verifier=classifier``): the
    unconditional UNet through random N=16 over the ancestral chain cut
    to T=125 (128 rows; BASELINE.md workload 3 runs T=1000), random N=16
    in chunks of 4 over DDIM 50 with the verifier-hacking guard, pruned
    16 -> 4 at t=62 and path 4/2 at t=50 (ancestral, T=125), zero-order
    4 x 2 over DDIM 50, SMC with 16
    particles over DDIM 50 segments, gradient search through DPM-Solver++
    20 (2 iterations) and through the remat'd ancestral chain cut to T=50
    (1 iteration); the CFG UNet (w=1.8, dual batch) through random N=4 and
    pruned 4 -> 2 over DDIM 50 and gradient search through DPM-Solver++ 20
    (the wide dq and dk/dv at batch 16). Exact launches (forwards, the
    remat'd chain's recomputed forwards, one dq and one dk/dv per
    attention call of a differentiated forward), the attention batch of
    every call, no synchronizing CUDA operation inside an algorithm
    (random search: one read between chunks), JAX's NFE accounting; wall
    s, NFE, ms per NFE and per forward, peak memory, the best and the
    median candidate score;
16. search parity: random and pruned search over DDIM 50 and gradient
    search's gradient through DPM-Solver++ (both UNets), kernel path
    against plain path on the same seeds, in f32 and bf16; then
    ``gradient_search`` itself over the remat'd ancestral chain cut to
    T=20 (3 iterations of Adam and best tracking; its scores and gradient
    norms, kernels against plain) and the remat'd chain's gradient against
    the gradient of the chain that holds every step, on the same draws,
    bit for bit under cuDNN's deterministic algorithms; each reading
    printed beside its limit, and for gradient_search the worst element:
    its iteration, the noise's and the sampler's pre-clip images' largest
    difference at each iteration, and the pixels whose two values lie on
    either side of the sampler's clip at +-1;
17. FID / IS / CLIP tracking at full width, bf16, with a random-weight
    Inception-V3 at 299, CLIP at the published ViT-B/32 shape (seeded
    weights written in HuggingFace's layout, read through
    ``$ITSD_CLIP_WEIGHTS``) and IS logits from phase 15's classifier
    (found by ``train.is_logit_source=auto``): ``inference-metrics`` on
    the unconditional UNet (``configs/cifar10_uncond.yaml`` on shapes,
    T cut to 125, eval batch 64, a point every 25 steps) from phase 7's
    last checkpoint; ``runner.train`` with tracked metrics every epoch for
    1 epoch of phase 7's configuration (its eval at inference_T=125,
    points every 63 steps); guided
    ``inference-metrics`` on the CFG UNet (w=1.8, T cut to 100 as phase 9
    cuts it, dual batch 128, a point every 20 steps); random N=4 search
    over DDIM 50 with the ensemble and the clip verifiers. Exact launches
    (125 x 51 GroupNorm and 125 x 6 mma forwards for the first), the
    attention batch of every call, no synchronizing CUDA operation inside
    a snapshot chain, finite FID, IS and CLIP at every point; the chain's
    ms per step, ms per metric point, Inception's and CLIP's ms per image,
    peak memory, wall seconds;
18. tracked parity, f32: the tracked unconditional run at T=50 (batch 64),
    kernel path against plain path, FID, IS and CLIP at every point; the
    Inception-V3 and CLIP features on the card against the same modules
    on the CPU;
19. the T-extension fine-tune at the 256x256 flagship's full width:
    ``finetune-t --config configs/fine_tune_config.yaml`` (ch 128, ch_mult
    1,2,3,4, T=1000 -> 2000 by interpolation, lr 1e-5; batch 48, the
    largest that fits: the config's 64 does not) with a table time
    embedding, bf16, the shapes dataset at 256x256 and remat,
    from a weights-only T=1000 checkpoint of seeded weights, for 3 steps:
    every parameter outside the time embedding bit for bit the loaded one,
    2000 rows whose first and last are the old rows 0 and 999, the time
    embedding moved, a finite loss, exact launches a step (the forward,
    remat's recompute, dq and dk/dv; every attention call on wide), the
    checkpoint restored; DDIM 20 at batch 8 from the fine-tuned checkpoint
    (T=2000) and from the T=1000 checkpoint at inference_T=2000 (the
    surgery at load); ms a step, images/s, peak memory (and at batch 8
    with and without remat), busy share;
20. the ViT backbone at full width (``configs/imagenet256_uncond.yaml``
    with model.backbone=vit: ViT-B/16 at 256x256, bf16): 4 train steps at
    batch 16 (exactly 12 flash forwards, 12 dq and 12 dk/dv a step, on mma
    at C=64), DDIM 50 at batch 8 from its checkpoint (12 forwards a model
    evaluation), finite loss and images, and one f32 (simt) and one bf16
    forward of the kernel path against the plain path ("xla");
21. the data-parallel path (torchrun, world size 1, NCCL), after phase 7:
    the CLI's ``train`` at phase 7's configuration (batch 128, bf16) for
    2 epochs of 8 steps with a grid and a checkpoint, then ``search``
    (random N=8 in chunks of 4 over DDIM 50) from that checkpoint, run
    twice: in this process, and under ``python -m torch.distributed.run
    --standalone --nproc_per_node=1`` through this script's ``--cli``
    mode (each command through ``itsd_tpu_torch.cli.main.main``, what
    ``python -m itsd_tpu_torch.cli.main`` runs), both with cuDNN's
    deterministic algorithms. The torchrun run starts an NCCL process
    group of one (its world size, backend and start-up seconds printed)
    and runs the data-parallel train step (global draws, the all-reduce)
    and the sharding-aware search; its per-step losses and gradient norms,
    checkpoint, grid and search outputs must equal the one-process run's
    bit for bit, with exact launches, every attention call on mma; the
    step time of each run from its ``train_metrics.jsonl``. Under torchrun
    the train runs a third time with ``model.attention_impl=ring`` (JAX's
    note: a seq axis of one, the single-device call), which must write
    what the kernel path wrote, bit for bit;
22. spatial sharding (``train.spatial_shard=2``), after phase 21: two
    processes on cuda:0 (NCCL refuses two ranks on one device), each
    starting one gloo group through this script's ``--spatial`` mode, run
    ``runner.train`` from seeded weights on the 256x256 flagship
    (``configs/imagenet256_uncond.yaml``, bf16) at batch 2 for 3 steps
    and on the CIFAR-10 UNet at batch 8 for 3 steps, the ViT-B/16 of
    phase 20 at batch 2 for 3 steps, and ``runner.evaluate`` of the
    flagship's and the ViT's seeded weights, DDIM 10 at batch 2, in bf16
    and in f32; then this process runs the same without the ranks. Each
    rank holds its half of every image's rows: halo exchanges, GroupNorm's
    statistics all-reduced (the stats and apply kernels) and ring
    attention (the wide kernels at [2, 2048, 384] and [2, 512, 512], the
    mma ones at CIFAR's [8, 128, 256] and the ViT's [24, 128, 64]: its
    patch rows, its share of the position embedding, its dropout masks
    cut along the tokens), every exchange staged through host memory
    (gloo cannot send a CUDA tensor). Exact launches on both ranks, the
    ranks' losses, first gradients and images equal, and against one
    process: the losses, the first step's gradient (before the clip and
    Adam; for the ViT also its position embedding's share), the bf16
    images' mean error and the f32 images' largest (the bf16 chain from
    seeded weights amplifies its roundings to whole pixels), each reading
    printed beside its limit; each run's step ms, its share in the
    exchanges and in the gradients' all-reduce, and the peak memory of
    each rank and of one process.

Then it prints the ``nvidia-smi`` line, one JSON line describing the
kernels, and last ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result. It also exits non-zero
when there is no CUDA device or no ``itsd_tpu_torch`` beside it.

Launch counts: every count is set to 0 just before a path is driven and
read just after. The bf16 eval, train, search and tracked paths of the
unconditional UNet (phases 3, 7, 13, 15 and 17) run the mma kernels and
GroupNorm; those of the CFG UNet (phases 9, 12, 13, 15 and 17) the mma
and wide kernels; the fine-tune (phase 19) the wide kernels and
GroupNorm; the ViT (phase 20) the mma kernels at C=64; the torchrun train
(phase 21, twice: the second through attention_impl=ring) the mma
kernels and GroupNorm; the two-rank runs of phase 22 (both ranks' launches
summed) the stats and apply kernels and the ring's hops, wide for the
flagship and mma for the CIFAR UNet and the ViT. The kernels' JSON line
carries each
kernel's launches summed over these paths, and per path; the simt
forward, dq and dk/dv, which no bf16 path runs, carry their launches on
the f32 kernel paths of phases 4, 6, 10, 11, 14, 16, 18, 20 and 22 (its
f32 DDIM).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (NVIDIA data sheet; dense rates at 700 W).
HBM_BYTES_PER_S = 3.35e12
# Kernels built from csrc/flash_attention_hopper.cu (4 padded widths, with
# and without lse), csrc/flash_attention_bwd_dq_hopper.cu (4 widths, each
# also packing several samples a tile for N <= 64 past 132 samples) and
# csrc/flash_attention_bwd_dkv_hopper.cu (4 widths).
HOPPER_INSTANTIATIONS = 20
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
CFG_YAML = os.path.join(ROOT, "configs", "cifar10_cfg.yaml")
WIDTH = 128
T_STEPS = 1000
BATCH = 8
PARITY_STEPS = 20
TRAIN_BATCH = 128
TRAIN_EPOCHS = 4            # 16 steps an epoch on the 2048 shapes images
                            # (10 until the fine-tune and the ViT came, 8
                            # until the data-parallel phase came)
TRAIN_SAVE_FREQ = 3
TRAIN_GRID_BATCH = 8        # the epoch grid at batch 8, over GRID_T steps
# (inference_T; the whole T=1000 chain until the fine-tune and the ViT came,
# 250 until the data-parallel phase came)
GRID_T = 125
TRAIN_PARITY_STEPS = 3
# The guided path (configs/cifar10_cfg.yaml). One forward of its UNet makes
# 78 GroupNorm calls and 13 attention calls, all on the tensor cores in
# bf16: 5 on the mma route (C=128 at 32x32, C=256 at 1x1) and 8 on the wide
# route (C=512 at 16x16 and 2x2, C=1024 at 8x8 and 4x4). A train step's dq
# and dk/dv take the same routes.
CFG_PER_FORWARD = (78, 13, 5, 8)
CFG_BATCH = 8               # train.eval_batch_size of the guided evals
CFG_SHORT_T = 100           # the interval-CFG and autoguidance chains
# The CFG chain of phase 9, cut from the config's T=3000 to keep the
# script inside its time limit: on a slow host (45.9 ms a guided step on
# an H100, NVIDIA H100 80GB HBM3, 700 W) the whole chain took 138 s; T=500
# until the fine-tune and the ViT came, 250 until the data-parallel phase
# came.
CFG_LONG_T = 125
CFG_INTERVAL = (30, 70)     # 40 of their 100 steps guided
COND_TRAIN_EPOCHS = 8       # 8 steps an epoch: 2048 shapes images, batch 256
COND_PARITY_BATCH = 128
COND_LOSS_FALL = 0.5        # the last epoch's mean loss below this share
                            # of the first epoch's (measured: 0.04)
RESTORED_EVAL_STEPS = 25    # guided steps from the restored checkpoint
                            # (100 until the data-parallel phase came)
# Phases 13 and 14: the fast and composite samplers.
FAST_STEPS = 50             # diffusion.ddim_steps of DDIM, restart, Picard
DPM_STEPS = 20              # DPM-Solver++'s steps
RESTARTS = ((600, 300, 2),)  # restart_intervals over DDIM 50
PICARD_PARITY_STEPS = 20    # Picard against sequential DDIM (grids agree)
PICARD_PARITY_BATCH = 8
CFG_DDIM_FROM = 200         # the guided DDIM parity runs state 200 -> 0
# Phases 15 and 16: search.
CLF_IMAGES = 2048           # shapes images the classifier verifier trains on
CLF_EPOCHS = 20           # 16 steps an epoch at batch 128
CLF_MIN_ACC = 0.9
# The class the unconditional searches reward. The seeded UNet's samples
# are noise-like, and the classifier gives them class 3 with probability
# ~1 (phase 15's first run on an H100: every score -0.0000), which leaves
# nothing to search for; class 0 is far from saturated.
TARGET = 0
SMC_STEPS = (700, 400, 150)
PRUNE_AT = 500              # phase 16: pruned 16 -> 4 at this timestep
CFG_PRUNE_AT = 1500         # pruned 4 -> 2 (CFG UNet, T=3000)
# Candidates folded into the batch: 4 of batch 8 (the unconditional
# UNet's chunks, pruned survivors, paths and neighbours: 32 rows); the CFG
# UNet's 4 candidates and 2 survivors of its dual batch 16 (64 and 32 rows).
SEARCH_FOLD = 4
CFG_SEARCH_N = 4
CFG_SEARCH_KEEP = 2
# The remat'd ancestral gradient's chain, cut from T=1000: one iteration
# at T=1000 took 122.3 s on an H100 (NVIDIA H100 80GB HBM3, 700 W; 40.8
# ms a forward, recompute and backward included), at T=250 up to 46.2 s,
# at T=100 18.5 s (until the data-parallel phase came).
REMAT_T = 50
# Random N=16, pruned 16 -> 4 and path 4/2 over the ancestral chain cut
# from T=1000 to SEARCH_T (random N=16 took 16.8-21.7 s at T=1000 on an
# H100, NVIDIA H100 80GB HBM3, 700 W), pruned at SEARCH_PRUNE_AT and the
# paths injected at SEARCH_INJECT_AT (500 and 400 of 1000 until the
# fine-tune and the ViT came; T=250, 125 and 100 until the data-parallel
# phase came).
SEARCH_T = 125
SEARCH_PRUNE_AT = 62
SEARCH_INJECT_AT = 50
CFG_GRAD_STEPS = 10         # DPM-Solver++ steps of the CFG gradient parity
# Phases 17 and 18: FID / IS / CLIP tracking. The tracked runs sample at
# train.eval_batch_size unset: min(train.batch_size, 64) = 64 (the CFG
# UNet's dual batch 128). Each metric point of a 2048-d feature space
# costs a float64 Frechet distance on the host (~1 s), so the runs thin
# their points: the T=1000 run every TRACKED_INTERVAL steps.
UNCOND_YAML = os.path.join(ROOT, "configs", "cifar10_uncond.yaml")
TRACKED_BATCH = 64
# The unconditional tracked chains, cut from the config's T=1000 (the
# script ran 894 s of its 1200 s before the fine-tune and the ViT came):
# inference-metrics over diffusion.T=TRACKED_T, the tracked train's evals
# over inference_T=TRACKED_T (250 until the data-parallel phase came).
TRACKED_T = 125
TRACKED_INTERVAL = 25       # train.eval_metric_interval: 5 points
TRACKED_TRAIN_EPOCHS = 1    # 2 until the data-parallel phase came
TRACKED_TRAIN_INTERVAL = 63   # train.metric_interval of its evals: 2
CFG_TRACKED_INTERVAL = 20   # the guided T=CFG_SHORT_T run: 5 points
TRACKED_SEARCH_N = 4        # random search over DDIM 50, ensemble and clip
TRACKED_PARITY_T = 50
TRACKED_PARITY_INTERVAL = 10
# Phase 19: the T-extension fine-tune at the 256x256 flagship's width
# (configs/fine_tune_config.yaml: ch 128, ch_mult 1,2,3,4, attention at
# 64x64 = 4096 tokens of C=384 and at the middle's 32x32 = 1024 of C=512,
# T=1000 -> 2000, "interpolate", lr 1e-5, batch 64). FT_STEPS steps on
# FT_STEPS batches of the shapes dataset at 256x256. The config's batch 64
# does not fit in the card's 80 GB, even with remat (a step ran out of
# memory in the GroupNorm backward's float32 recompute); 48 does (60.4 GB
# peak), and 32 (40.4 GB): NVIDIA H100 80GB HBM3, 700 W.
FT_YAML = os.path.join(ROOT, "configs", "fine_tune_config.yaml")
FT_OLD_T = 1000
FT_BATCH = 48
FT_STEPS = 3
FT_REMAT = True             # per-ResBlock recompute, which batch 48 needs
FT_MEM_BATCH = 8            # peak memory with and without remat
FT_TIMED_STEPS = 2
FT_EVAL_STEPS = 20          # DDIM 20 at batch 8 from both checkpoints
FT_EVAL_BATCH = 8
# Phase 20: the ViT backbone (configs/imagenet256_uncond.yaml with
# model.backbone=vit: ModelCfg's ViT-B/16 defaults, patch 16, embed 768,
# depth 12, 12 heads of 64, 256 tokens at 256x256), bf16.
# Phase 21: the data-parallel path at world size 1. Phase 7's
# configuration for DP_EPOCHS epochs of DP_STEPS steps (the shapes images
# cut to DP_STEPS batches of 128), the grid at the end over DP_GRID_T
# steps, one checkpoint; then random search over DDIM 50 from it, in
# chunks of DP_SEARCH_CHUNK candidates.
DP_EPOCHS = 2
DP_STEPS = 8
DP_SUBSET = DP_STEPS * TRAIN_BATCH / 2048
DP_GRID_T = 20
DP_SEARCH_N = 8
DP_SEARCH_CHUNK = 4
DP_TIMEOUT = 600            # seconds for the torchrun command
IMAGENET_YAML = os.path.join(ROOT, "configs", "imagenet256_uncond.yaml")
VIT_BATCH = 16
VIT_STEPS = 4
VIT_EVAL_BATCH = 8
VIT_EVAL_STEPS = 50         # DDIM 50
# Phase 20 limits, a ViT forward (|eps| up to ~1.7) of the kernel path
# against the plain path ("xla") on the same weights, about 5x the first
# readings on an H100 (NVIDIA H100 80GB HBM3, 700 W): f32 sums in another
# order (3.1e-6); bf16 rounds each attention output, which the later
# blocks carry (0.0234).
VIT_EPS_TOL = {"float32": 1.5e-5, "bfloat16": 0.1}
# Phase 22: train.spatial_shard=2 at two ranks of one gloo group, both on
# cuda:0 (one H100; NCCL refuses two ranks on one device): the flagship
# (configs/imagenet256_uncond.yaml) at batch 2 for 3 steps and DDIM 10,
# and the CIFAR-10 UNet at batch 8 for 3 steps, each against the same run
# in one process.
SP_RANKS = 2
SP_FLAG_BATCH = 2
SP_FLAG_STEPS = 3
SP_FLAG_DDIM = 10
SP_CIFAR_BATCH = 8
SP_CIFAR_STEPS = 3
SP_VIT_STEPS = 3            # the ViT at the flagship's batch and DDIM
SP_TIMEOUT = 600            # seconds for the two ranks
# Phase 22 limits, two ranks against one process, about 3-4x the
# readings on an H100 (NVIDIA H100 80GB HBM3, 700 W): the rows' GroupNorm
# sums, the ring's merge of its bf16 partials and the halo convolutions'
# algorithms round otherwise. The train runs start from the seeded
# weights (every branch live), where 3 bf16 steps carry those roundings
# into the losses: 2.96e-3 (flagship), 1.03e-3 (CIFAR) and 1.22e-4 (ViT)
# relative, the largest over the steps. The first step's gradient,
# all-reduced to the global batch's and taken before the clip and Adam
# (which would saturate a difference at ~lr a step), as ||g2 - g1|| /
# ||g1||: 4.48e-3 (flagship), 4.29e-3 (CIFAR), 4.33e-3 (ViT; its position
# embedding's share alone 6.55e-3). ``--sp-control`` plants a dropped halo
# gradient (2.99e-2 and 0.151), a ring backward without its hop home
# (4.24e-2, 8.62e-2 and 0.174), rank 0's share of the ViT's position
# embedding on every rank (5.32e-2; its own gradient 0.996) and the ViT's
# dropout drawn per rank (0.125): each goes beyond SP_GRAD_RTOL. The DDIM
# images: from seeded weights the bf16 chain's first step divides by
# sqrt(abar) = 0.006 and turns roundings into whole pixels at the clip
# (max |err| 2), so the bf16 images are held by their mean |err| (0.0039
# flagship, 0.0026 ViT) and the f32 images, which differ by summation
# order, by their max (1.1e-3, 2.8e-4).
SP_LOSS_RTOL = {"flagship_train": 1.2e-2, "cifar_train": 4e-3,
                "vit_train": 5e-4}
SP_GRAD_RTOL = {"flagship_train": 1.5e-2, "cifar_train": 1.5e-2,
                "vit_train": 1.5e-2}
SP_POS_GRAD_RTOL = 2.5e-2
SP_IMAGE_MEAN_TOL = {"flagship_ddim": 0.016, "vit_ddim": 0.01}
SP_IMAGE_TOL = {"flagship_ddim_f32": 5e-3, "vit_ddim_f32": 1e-3}
# Phase 2, GroupNorm over row shards: the flagship's forward at batch 2
# and the CIFAR-10 UNet's at batch 8, each call's rows cut over K seq
# ranks. The stats kernel's f32 sums in another order than the plain
# version's: within 1e-6 of the sum of the terms' magnitudes (about 4x the
# largest reading, 2.4e-7 relative, on an H100: NVIDIA H100 80GB HBM3,
# 700 W). At that limit a sum that drops one element fails wherever the
# element's magnitude exceeds 1e-6 of the span's: ``STATS_CATCH_MIN`` is
# the least share of a span's elements whose loss each check must catch.
ROWS_K = (2, 4)
STATS_TOL_SUM = 1e-6
STATS_TOL_SQ = 1e-6
STATS_CATCH_MIN = 0.5
# Phase 18 limits, about 5x the first readings on an H100 (NVIDIA H100
# 80GB HBM3, 700 W). FID, IS and CLIP of the f32 kernel path against the
# plain path, relative: the f32 paths differ by summation order, which
# the T=50 chain carries to the snapshots as ~1e-7 (measured FID 1.4e-8,
# IS 1.8e-7, CLIP 0). Inception-V3 and CLIP on the card against the same
# modules on the CPU, relative to the largest CPU value: f32 with TF32
# off, sums in another order (measured 1.2e-6 to 2.0e-6).
METRIC_REL_TOL = 1e-6
EXTRACTOR_REL_TOL = 1e-5
# Phase 16 limits, kernels against plain on the same seeds, each 4-5x
# the largest error of the first run on an H100 (NVIDIA H100 80GB HBM3,
# 700 W). Scores: the classifier's mean log-probability of 8 images after
# DDIM 50, |score| 17-30 (f32: the paths differ by summation order,
# measured 3.1e-5 to 6.1e-5; bf16: by roundings at neighbouring bf16
# values, which DDIM's chain carries to the images (phase 14), measured
# 0.177 to 0.230). Gradient of the score with respect to the noise,
# relative L2 (f32: 2.5e-6 unconditional, 1.7e-6 under CFG; bf16: 0.0128
# and 0.0082).
SCORE_TOL = {"float32": 3e-4, "bfloat16": 1.0}
GRAD_REL_TOL = {"float32": 1.2e-5, "bfloat16": 0.06}
# gradient_search itself, kernels against plain: the unconditional UNet at
# batch 8 over the remat'd ancestral chain cut to diffusion.T=GS_T, for
# GS_ITERS iterations. The sampler clips its output to [-1, 1], and the
# seeded UNet leaves about half the pixels outside; a pixel whose value
# lies within the paths' difference of +-1 passes its gradient on one path
# and not on the other, so bf16 (whose paths differ by roundings) is held
# to a looser limit than f32. Limits about 5x the first readings on an
# H100 (NVIDIA H100 80GB HBM3, 700 W): scores f32 1.9e-6, bf16 0.0152;
# gradient norms, relative, f32 1.9e-7, bf16 1.6e-3.
GS_T = 20
GS_ITERS = 3
GS_SCORE_TOL = {"float32": 1e-5, "bfloat16": 0.08}
GS_NORM_REL_TOL = {"float32": 1e-6, "bfloat16": 8e-3}
# The gradient each iteration used (kernels) against the plain path's at
# the same iterate, relative L2, which a gradient of the right norm in the
# wrong direction fails: the limits of the DPM-Solver++ gradient parity
# above (same model and batch), set before the first readings.
GS_GRAD_REL_TOL = GRAD_REL_TOL
# GroupNorm: f32 sums in another order (~1e-6 on values O(1)); bf16: the
# same f32 value may round to a neighbouring bf16 value (one step, 2^-7).
GN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}
# Attention, f32: online softmax vs explicit softmax, ~1e-6. bf16: the kernel
# rounds p to bf16 before p.v (as the Pallas kernel), the plain version the
# normalised weights; each is off by <= 2^-9 relative, so the sums differ by
# <= 2^-8 * max|v|, and each side then rounds its output (one step, 2^-7
# relative). Tolerance: atol 2^-7 * max|v| (twice that), rtol 2^-7. The lse
# comes from the same f32 scores on both sides.
ATTN_F32_TOL = 2e-5
ATTN_BF16_RTOL = 2.0 ** -7
LSE_TOL = 2e-5
# Backward kernels against their plain versions (the same formula and
# roundings). f32: sums in another order, measured <= 3.8e-6 on values up
# to 3.4 (H100, the first run of these kernels). bf16: both sides round ds
# (and p) to bf16 from f32 values that may differ in their last bits, so a
# term can land on the neighbouring bf16 value, and each side rounds its
# output (one step, 2^-7 relative): atol 2^-7 * max|plain|, rtol 2^-7
# (measured <= 2^-8 * max|plain|).
BWD_F32_TOL = 2e-5
BWD_BF16_RTOL = 2.0 ** -7
# GroupNorm backward: the kernel path recomputes through the plain version
# on the same inputs, so its gradients equal autograd of the plain version.
GN_BWD_TOL = 0.0
# Phase 4 holds the kernel path against the plain path at full width; the
# two differ only where the kernels round or sum in another order. Each
# limit is 3-5x the error this seed gave on an H100 (NVIDIA H100 80GB HBM3,
# 700 W): the kernels and the inputs are deterministic, so a rerun lands
# near it, and a fault that moves the output by more fails.
# EPS_TOL: one UNet forward (eps, |eps| up to ~3.6) at timesteps across the
# chain. In f32 the paths differ by summation order alone (measured
# 1.06e-5); in bf16 a GroupNorm or attention output that rounds to the
# neighbouring bf16 value moves every later layer (measured 0.055).
EPS_TOL = {torch.float32: 5e-5, torch.bfloat16: 0.2}
# PATH_TOL: 20 steps at the end of the chain (t = 19..0), where an eps
# difference enters x with weight coeff2 = beta_t / sqrt(1 - abar_t), about
# 0.0063-0.01 a step: the 20 weights sum to 0.135, so an eps off by e in
# the same direction at every step moves x by ~0.135e. Measured 9.5e-7
# (f32) and 0.0021 (bf16). In bf16 this limit thus catches an eps bias of
# ~0.06, which the eps limit above lets through.
PATH_TOL = {torch.float32: 4e-6, torch.bfloat16: 7e-3}
# Phase 10 holds the CFG UNet's guided path, kernel path against plain
# path, to phase 4's limits: one conditional forward (eps) at timesteps
# across its T=3000 chain to EPS_TOL (measured on an H100, NVIDIA H100
# 80GB HBM3, 700 W: 1.41e-5 in f32, 0.0441 in bf16, as phase 4's model
# gives). The guided eps (1+w)*eps_c - w*eps_u scales an eps error by up to
# 1 + 2w = 4.6 at w=1.8, and so do the guided steps: their limits are 4.6
# times EPS_TOL and 4.6 times PATH_TOL (measured: guided eps 4.94e-5 and
# 0.147, 20 guided steps 1.67e-6 and 0.00268).
# Phase 11 holds 3 conditional train steps to phase 6's limits (measured:
# loss, gradient norm, max |dparam| 1.7e-7, 9.0e-8, 8.9e-6 in f32; 9.9e-5,
# 2.8e-4, 2.0e-4 in bf16; lr 5e-5, batch 128).
# Phase 6: 3 train steps of the kernel path against the plain path, batch
# 128, lr 2e-4 (the first epoch of the warmup). Limits: 3-5x the errors
# measured on an H100 (NVIDIA H100 80GB HBM3, 700 W) with this seed.
# Loss and gradient norm, relative: the kernels sum in another order (f32;
# in three runs of the same inputs, loss 1.7e-7, 1.7e-7, 4.4e-7 and
# gradient norm 4.5e-7, 7.1e-7, 6.2e-7: a spread not traced to its cause)
# or round at neighbouring bf16 values (bf16; 5.7e-4 and 9.1e-4 in every
# run; the plain path's attention backward runs in f32 throughout, the
# kernels round ds and p to bf16 as on the TPU). max |dparam| (f32
# 1.8e-5 to 2.0e-5, bf16 7.7e-4): Adam's update is ~lr per element
# whatever the gradient's size, so an element whose gradient is at its own
# noise level (attention's k bias, whose exact gradient is 0) takes an
# update of up to ~lr that differs between the paths.
TRAIN_LOSS_RTOL = {torch.float32: 2e-6, torch.bfloat16: 2.5e-3}
TRAIN_GNORM_RTOL = {torch.float32: 3e-6, torch.bfloat16: 4e-3}
TRAIN_PARAM_TOL = {torch.float32: 8e-5, torch.bfloat16: 3e-3}

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_done(n: int, name: str, t0: float, extra: str = "") -> None:
    now = time.perf_counter()
    log(f"[phase {n}] {name}: done in {now - t0:.2f} s "
        f"(total {now - _T0:.2f} s){' ' + extra if extra else ''}")


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# timing


class DeviceTimer:
    """Per-call device time of a function that enqueues work.

    A sleep kernel holds the device while the host enqueues all the calls,
    so CUDA events bracket only their back-to-back execution on the device,
    not the host's cost of launching them (reported beside it). A host stall
    longer than the sleep can only add time, so the least of ``reps``
    repetitions is kept."""

    def __init__(self):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        cycles = 20_000_000
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        self.cycles_per_ms = cycles / start.elapsed_time(end)

    def __call__(self, fn, n: int = 50, warmup=None, reps: int = 2):
        """(device ms per call, host us to launch one call: median). Two
        repetitions (three until the seq axis's phase came); ``warmup``
        calls first, by default 3 but no more than ``n`` (the fine-tune's
        shapes, timed one call at a time, take up to ~1 s a call on the
        CUDA cores: 3 until the ViT's rows came)."""
        for _ in range(min(3, n) if warmup is None else warmup):
            fn()
        torch.cuda.synchronize()
        dev, host = [], []
        for _ in range(reps):
            h0 = time.perf_counter()
            for _ in range(n):
                fn()
            host_ms = (time.perf_counter() - h0) * 1e3
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(int(self.cycles_per_ms * (4 * host_ms + 10)))
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            dev.append(start.elapsed_time(end) / n)
            host.append(host_ms * 1e3 / n)
        return min(dev), float(np.median(host))

    def pair(self, fn_a, fn_b, n: int = 50):
        """(device ms of fn_a, of fn_b, host us of fn_a, of fn_b): the two
        timed in turns, a repetition of one, then of the other, so that a
        redesigned kernel and the kernel it replaced meet the same card
        state."""
        a, b = [], []
        for _ in range(2):
            a.append(self(fn_a, n=n, reps=1))
            b.append(self(fn_b, n=n, reps=1, warmup=1))
        return (min(x[0] for x in a), min(x[0] for x in b),
                float(np.median([x[1] for x in a])),
                float(np.median([x[1] for x in b])))


# ---------------------------------------------------------------------------
# phases


def card():
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"card: {name} | nvidia-smi: {smi_line} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]} | "
        f"devices {torch.cuda.device_count()}")
    phase_done(0, "card", t0)
    return name, smi_line


def build():
    from itsd_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    kernels = _build.load()
    if kernels.built:
        log(f"nvcc: {kernels.nvcc_seconds:.2f} s for "
            f"{len(_build.sources())} sources compiled side by side and "
            f"linked -> {kernels.path}")
    else:
        log(f"loaded an earlier build: {kernels.path}")
    spills = []
    for fn, regs, spill_st, spill_ld in kernels.ptxas:
        log(f"  ptxas {fn}: {regs} registers, spill stores {spill_st} B, "
            f"spill loads {spill_ld} B")
        if spill_st or spill_ld:
            spills.append(fn)
    if spills:
        fail(f"ptxas reports spills in {spills}")
    # the Hopper kernels must be built from wgmma and TMA loads
    hopper = [fn for fn, *_ in kernels.ptxas if "hopper_kernel" in fn]
    counts = {fn: c for fn, c in _build.sass_counts(
        kernels.path, functions=hopper or None).items()
        if "hopper_kernel" in fn}
    if len(counts) != HOPPER_INSTANTIATIONS:
        fail(f"cuobjdump lists {len(counts)} Hopper kernels, want "
             f"{HOPPER_INSTANTIATIONS}: {sorted(counts)}")
    for fn, c in sorted(counts.items()):
        log(f"  sass {fn}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}")
        if not c["HGMMA"] or not c["UTMALDG"]:
            fail(f"{fn}: {c['HGMMA']} HGMMA and {c['UTMALDG']} UTMALDG "
                 "instructions; a Hopper kernel needs both")
    phase_done(1, "build", t0, "(no spills)" if kernels.built else "")


def eval_config(tmpdir: str, dtype: str = "bfloat16", *extra):
    from itsd_tpu_torch.utils import load_config

    return load_config(None, [
        f"channel={WIDTH}", "channel_mult=[1,2,2,2]", "attn=[1]",
        "num_res_blocks=2", "dropout=0.1", f"T={T_STEPS}", "img_size=32",
        f"model.dtype={dtype}", f"train.eval_batch_size={BATCH}", "seed=0",
        f"sampled_dir={tmpdir}", *extra])


def train_config(tmpdir: str, dtype: str = "bfloat16", *extra):
    """configs/cifar10_uncond.yaml's model and train settings on the shapes
    dataset (the repository's stand-in for CIFAR-10)."""
    from itsd_tpu_torch.utils import load_config

    return load_config(None, train_overrides(tmpdir, dtype, *extra))


def train_overrides(tmpdir: str, dtype: str = "bfloat16", *extra):
    """The command-line overrides of ``train_config``."""
    return [
        f"channel={WIDTH}", "channel_mult=[1,2,2,2]", "attn=[1]",
        "num_res_blocks=2", "dropout=0.1", f"T={T_STEPS}", "img_size=32",
        f"model.dtype={dtype}", f"batch_size={TRAIN_BATCH}", "lr=2e-4",
        "data.dataset=shapes", "train.track_metrics=false", "seed=0",
        f"train.epoch={TRAIN_EPOCHS}",
        f"train.model_save_freq={TRAIN_SAVE_FREQ}",
        f"train.eval_freq={TRAIN_EPOCHS}",
        f"train.eval_batch_size={TRAIN_GRID_BATCH}",
        f"save_weight_dir={tmpdir}/ckpt", f"sampled_dir={tmpdir}/sampled",
        f"metrics_save_dir={tmpdir}/metrics", *extra]


def seeded_params(cfg):
    """Seeded weights with the near-zero output layers (residual conv2,
    attention proj, tail conv) scaled up to Xavier size, so that every
    branch moves the output (and gets a gradient)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models.embeddings import TINY_GAIN

    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    for k, v in params.items():
        if k.endswith(("conv2.weight", "attn.proj.weight",
                       "tail_conv.weight")):
            v.mul_(1.0 / TINY_GAIN)
    return params


def path_shapes(cfg, params, dev, batches):
    """For each batch of ``batches``: the (shape, act) of every GroupNorm
    call and the [B, N, C] of every attention call in one UNet forward (a
    conditional one with labels 1..10), in order."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models.unet import AttnBlock, GNAct

    model, conditional = runner.build_model(cfg)
    model.load_state_dict(params)
    model.to(dev).eval()
    gn, attn = [], []
    for mod in model.modules():
        if isinstance(mod, GNAct):
            mod.register_forward_pre_hook(
                lambda m, a: gn.append((tuple(a[0].shape), m.act)))
        elif isinstance(mod, AttnBlock):
            mod.register_forward_pre_hook(
                lambda m, a: attn.append((a[0].shape[0],
                                          a[0].shape[2] * a[0].shape[3],
                                          a[0].shape[1])))
    out = []
    size = cfg.data.img_size
    for batch in batches:
        x = torch.randn((batch, size, size, 3), device=dev)
        t = torch.full((batch,), cfg.diffusion.T // 2, device=dev,
                       dtype=torch.int64)
        labels = (torch.arange(batch, device=dev) % 10 + 1
                  if conditional else None)
        with torch.inference_mode():
            model(x, t, labels)
        torch.cuda.synchronize()
        out.append((gn[:], attn[:]))
        gn.clear()
        attn.clear()
    return out


def _rand(shape, gen, dev, dtype, mean=0.0, std=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * std + mean
            ).to(dtype)


def gn_bound_ms(shape, itemsize, act):
    numel = int(np.prod(shape))
    bytes_ = 2 * numel * itemsize + 2 * shape[1] * 4
    flops = numel * (10 if act else 6)
    return (bytes_ / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3)


def attn_bound_ms(B, N, C, itemsize, tensors=4, products=2):
    """Least ms of an attention kernel: ``tensors`` [B, N, C] read or
    written once (plus two f32 [B, N] rows for the backward) against
    ``products`` products of 2*B*N^2*C operations."""
    bytes_ = tensors * B * N * C * itemsize
    if products > 2:
        bytes_ += 2 * B * N * 4  # lse and dd
    flops = products * 2 * B * N * N * C
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else F32_FLOPS
    return (bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3)


def rows_entry(rows):
    """Times summed over one step: ``rows`` holds (calls a step, kernel ms,
    plain ms, library ms, bytes-bound ms, operations-bound ms) per
    shape."""
    def total(i):
        return sum(r[0] * r[i] for r in rows)

    return dict(ms=total(1), plain_ms=total(2), library_ms=total(3),
                bound_ms=sum(r[0] * max(r[4], r[5]) for r in rows),
                bound_by="bytes" if total(4) >= total(5) else "operations")


def check_close(what, got, want, atol, rtol, extra=None):
    """|got - want| <= atol + rtol*|want| (+ ``extra``, elementwise)."""
    err = (got.float() - want.float()).abs()
    over = err - atol - rtol * want.float().abs()
    if extra is not None:
        over = over - extra
    over = over.max().item()
    worst = err.max().item()
    if not np.isfinite(worst) or over > 0:
        fail(f"{what}: max err {worst:.3g} beyond atol {atol:.3g} "
             f"rtol {rtol:.3g}")
    return worst


def check_groupnorm(gn_calls, dev, timer, n):
    """GroupNorm kernel against its plain version at every (shape, act) of
    ``gn_calls``; times at bf16. Returns (max error, rows)."""
    from itsd_tpu_torch.kernels import groupnorm
    from itsd_tpu_torch.models.unet import _groups

    gen = torch.Generator(device=dev).manual_seed(0)
    worst, rows = 0.0, []
    log("groupnorm_swish: shape [B,C,H,W] act x calls/step | max_abs_err "
        "bf16 f32 | kernel plain library bound ms (bf16) | host us/call")
    for (shape, act), calls in collections.Counter(gn_calls).items():
        C = shape[1]
        G = _groups(C)
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        b = 0.1 * torch.randn(C, generator=gen, device=dev)
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            x = _rand(shape, gen, dev, dtype, 0.5, 2.0)
            got = groupnorm.groupnorm_swish(x, w, b, G, act=act)
            want = groupnorm.groupnorm_swish_plain(x, w, b, G, act=act)
            torch.cuda.synchronize()
            errs[dtype] = check_close(
                f"groupnorm_swish {shape} act={act} {dtype}", got, want,
                *GN_TOL[dtype])
            worst = max(worst, errs[dtype])
        x = _rand(shape, gen, dev, torch.bfloat16, 0.5, 2.0)
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        lib = ((lambda: F.silu(F.group_norm(x, G, wl, bl, 1e-5))) if act
               else (lambda: F.group_norm(x, G, wl, bl, 1e-5)))
        k_ms, host_us = timer(
            lambda: groupnorm.groupnorm_swish(x, w, b, G, act=act), n=n)
        p_ms, _ = timer(
            lambda: groupnorm.groupnorm_swish_plain(x, w, b, G, act=act),
            n=n)
        l_ms, _ = timer(lib, n=n)
        by_bytes, by_ops = gn_bound_ms(shape, 2, act)
        log(f"  {list(shape)} act={int(act)} x{calls} | "
            f"{errs[torch.bfloat16]:.3g} {errs[torch.float32]:.3g} | "
            f"{k_ms:.5f} {p_ms:.5f} {l_ms:.5f} {max(by_bytes, by_ops):.5f} "
            f"| {host_us:.1f}")
        rows.append((calls, k_ms, p_ms, l_ms, by_bytes, by_ops))
    return worst, rows


def stats_bound_ms(shape, itemsize):
    """Least ms of one stats launch: x read once (the [B, G] sums are
    negligible), against one f32 add (three for a squared deviation) an
    element."""
    numel = int(np.prod(shape))
    return (numel * itemsize / HBM_BYTES_PER_S * 1e3,
            2 * numel / F32_FLOPS * 1e3)


def check_stats(what, got, want, x, G, squares):
    """A span's f32 sum in another order (``STATS_TOL_SUM``,
    ``STATS_TOL_SQ``); returns (the largest absolute error, the largest
    relative to its limit's scale)."""
    from itsd_tpu_torch.kernels import groupnorm

    scale = (want.abs() if squares
             else groupnorm.groupnorm_partial_stats_plain(x.abs(), G))
    tol = (STATS_TOL_SQ if squares else STATS_TOL_SUM) * scale + 1e-6
    err = (got - want).abs()
    if not torch.isfinite(got).all() or (err > tol).any():
        fail(f"{what}: max err {err.max().item():.3g} beyond "
             f"{tol.min().item():.3g}..{tol.max().item():.3g}")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


def dropped_element_catch(x, G, mean):
    """The share of the first span's elements whose loss from the sum,
    and from the sum of squared deviations around ``mean``, the limits of
    ``check_stats`` catch: a kernel that skips one element (an off-by-one
    at a cluster part's boundary) errs by that element's term."""
    span = x.reshape(x.shape[0], G, -1)[0, 0].float()
    dev2 = (span - mean[0, 0]) ** 2
    sum_tol = STATS_TOL_SUM * span.abs().sum() + 1e-6
    sq_tol = STATS_TOL_SQ * dev2.sum() + 1e-6
    return ((span.abs() > sum_tol).float().mean().item(),
            (dev2 > sq_tol).float().mean().item())


def check_groupnorm_rows(gn_calls, batch, K, dev, timer, n):
    """Phase 2: the stats and apply kernels of GroupNorm over row shards at
    every GroupNorm call of ``gn_calls`` (one forward) at ``batch``, its
    rows cut over ``K`` seq ranks, in bf16 and f32 against their plain
    versions, and the earlier stats kernel (the new one's yardstick, a
    forced call) beside them; times at bf16 (the stats kernel twice a call:
    the sum, then the squared deviations, each in turns with the earlier
    kernel; an empty kernel on the new plan's grid, the launch's own cost;
    the library call ``torch.sum`` over the span, for the sum's launches).
    Returns {kernel: (max absolute error, rows)}, with rows of the sum's
    launches alone (``groupnorm_partial_stats_sum``), of the earlier
    kernel (``..._cluster``, ``..._cluster_sum``) and of the empty kernel
    (``..._empty``) beside the kernels'."""
    from itsd_tpu_torch.kernels import groupnorm
    from itsd_tpu_torch.models.unet import _groups

    gen = torch.Generator(device=dev).manual_seed(K)
    worst = {"stats": 0.0, "stats_cluster": 0.0, "apply": 0.0}
    rows = {k: [] for k in ("stats", "stats_sum", "stats_cluster",
                            "stats_cluster_sum", "stats_empty", "apply")}
    caught = [1.0, 1.0]
    log(f"groupnorm over row shards, batch {batch}, K={K}: shape [B,C,h,W] "
        f"act x calls | stats err (relative) bf16 f32, earlier stats "
        f"kernel's, apply err bf16 f32 | stats sum / squares / plain / "
        f"library / bound / empty kernel ms, earlier kernel sum / squares "
        f"ms, apply / plain / bound ms (bf16)")
    calls = collections.Counter(((batch, C, H // K, W), act)
                                for (_, C, H, W), act in gn_calls)
    for (shape, act), count in calls.items():
        C = shape[1]
        G = _groups(C)
        span = shape[1] * shape[2] * shape[3] // G
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        b = 0.1 * torch.randn(C, generator=gen, device=dev)
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            what = f"groupnorm rows {shape} K={K} {dtype}"
            x = _rand(shape, gen, dev, dtype, 0.5, 2.0)
            s1 = groupnorm.groupnorm_partial_stats(x, G)
            mean = s1 / span
            s2 = groupnorm.groupnorm_partial_stats(x, G, mean)
            again = groupnorm.groupnorm_partial_stats(x, G, mean)
            rstd = torch.rsqrt(s2 / span + 1e-5)
            y = groupnorm.groupnorm_apply(x, mean, rstd, w, b, G, act)
            y2 = groupnorm.groupnorm_apply(x, mean, rstd, w, b, G, act)
            torch.cuda.synchronize()
            if not (torch.equal(s2, again) and torch.equal(y, y2)):
                fail(f"{what}: two launches on the same input differ")
            a_sum, e_sum = check_stats(
                f"{what} stats", s1,
                groupnorm.groupnorm_partial_stats_plain(x, G), x, G, False)
            a_sq, e_sq = check_stats(
                f"{what} squares", s2,
                groupnorm.groupnorm_partial_stats_plain(x, G, mean), x, G,
                True)
            n0 = read_launches()
            c1 = groupnorm._groupnorm_partial_stats_cluster(x, G)
            c2 = groupnorm._groupnorm_partial_stats_cluster(x, G, mean)
            if (read_launches()["groupnorm_partial_stats_cluster"]
                    - n0["groupnorm_partial_stats_cluster"] != 2):
                fail(f"{what}: the earlier stats kernel not launched")
            c_sum, ce_sum = check_stats(
                f"{what} earlier stats", c1,
                groupnorm.groupnorm_partial_stats_plain(x, G), x, G, False)
            c_sq, ce_sq = check_stats(
                f"{what} earlier squares", c2,
                groupnorm.groupnorm_partial_stats_plain(x, G, mean), x, G,
                True)
            worst["stats_cluster"] = max(worst["stats_cluster"], c_sum,
                                         c_sq)
            catch = dropped_element_catch(x, G, mean)
            if min(catch) < STATS_CATCH_MIN:
                fail(f"{what}: the stats limits catch a dropped element at "
                     f"only {catch[0]:.3f} (sum) and {catch[1]:.3f} "
                     f"(squares) of a span's places, under "
                     f"{STATS_CATCH_MIN}")
            caught = [min(c, d) for c, d in zip(caught, catch)]
            e_ap = check_close(
                f"{what} apply", y,
                groupnorm.groupnorm_apply_plain(x, mean, rstd, w, b, G, act),
                *GN_TOL[dtype])
            errs.append((max(e_sum, e_sq), e_ap, max(ce_sum, ce_sq)))
            worst["stats"] = max(worst["stats"], a_sum, a_sq)
            worst["apply"] = max(worst["apply"], e_ap)
        x = _rand(shape, gen, dev, torch.bfloat16, 0.5, 2.0)
        s1 = groupnorm.groupnorm_partial_stats(x, G)
        mean = s1 / span
        rstd = torch.rsqrt(groupnorm.groupnorm_partial_stats(x, G, mean)
                           / span + 1e-5)
        view = x.view(shape[0], G, -1)
        k_sum, c_sum, _, _ = timer.pair(
            lambda: groupnorm.groupnorm_partial_stats(x, G),
            lambda: groupnorm._groupnorm_partial_stats_cluster(x, G), n=n)
        k_sq, c_sq, _, _ = timer.pair(
            lambda: groupnorm.groupnorm_partial_stats(x, G, mean),
            lambda: groupnorm._groupnorm_partial_stats_cluster(x, G, mean),
            n=n)
        empty, _ = timer(lambda: groupnorm._groupnorm_stats_floor(x, G), n=n)
        p_sum, _ = timer(
            lambda: groupnorm.groupnorm_partial_stats_plain(x, G), n=n)
        p_sq, _ = timer(
            lambda: groupnorm.groupnorm_partial_stats_plain(x, G, mean), n=n)
        l_sum, _ = timer(lambda: torch.sum(view, 2, dtype=torch.float32),
                         n=n)
        k_ap, _ = timer(
            lambda: groupnorm.groupnorm_apply(x, mean, rstd, w, b, G, act),
            n=n)
        p_ap, _ = timer(lambda: groupnorm.groupnorm_apply_plain(
            x, mean, rstd, w, b, G, act), n=n)
        sb, so = stats_bound_ms(shape, 2)
        ab, ao = gn_bound_ms(shape, 2, act)
        log(f"  {list(shape)} act={int(act)} x{count} | {errs[0][0]:.3g} "
            f"{errs[1][0]:.3g}, {errs[0][2]:.3g} {errs[1][2]:.3g}, "
            f"{errs[0][1]:.3g} {errs[1][1]:.3g} | "
            f"{k_sum:.5f} / {k_sq:.5f} / {p_sum + p_sq:.5f} / {l_sum:.5f} / "
            f"{max(sb, so):.5f} / {empty:.5f}, {c_sum:.5f} / {c_sq:.5f}, "
            f"{k_ap:.5f} / {p_ap:.5f} / {max(ab, ao):.5f}")
        sum_row = (count, k_sum, p_sum, l_sum, sb, so)
        sq_row = (count, k_sq, p_sq, 0.0, sb, 1.5 * so)
        rows["stats"] += [sum_row, sq_row]
        rows["stats_sum"].append(sum_row)
        rows["stats_cluster"] += [(count, c_sum, *sum_row[2:]),
                                  (count, c_sq, *sq_row[2:])]
        rows["stats_cluster_sum"].append((count, c_sum, *sum_row[2:]))
        rows["stats_empty"] += [(count, empty, *sum_row[2:]),
                                (count, empty, *sq_row[2:])]
        rows["apply"].append((count, k_ap, p_ap, 0.0, ab, ao))
    log(f"  a dropped element beyond the stats limits at >= "
        f"{caught[0]:.3f} (sum) and {caught[1]:.3f} (squares) of each "
        f"checked span's places")
    return {"groupnorm_partial_stats": (worst["stats"], rows["stats"]),
            "groupnorm_partial_stats_sum": (worst["stats"],
                                            rows["stats_sum"]),
            "groupnorm_partial_stats_cluster": (worst["stats_cluster"],
                                                rows["stats_cluster"]),
            "groupnorm_partial_stats_cluster_sum": (
                worst["stats_cluster"], rows["stats_cluster_sum"]),
            "groupnorm_partial_stats_empty": (0.0, rows["stats_empty"]),
            "groupnorm_apply": (worst["apply"], rows["apply"])}


def check_rows_make_the_whole(gn_calls, batch, K, dev):
    """Phase 2: each GroupNorm of ``gn_calls`` at ``batch`` cut into K row
    slices: the slices' stats, summed, against the stats kernel on the
    whole tensor, and the slices normalized with the global statistics
    against the fused kernel on the whole (bf16)."""
    from itsd_tpu_torch.kernels import groupnorm
    from itsd_tpu_torch.models.unet import _groups

    gen = torch.Generator(device=dev).manual_seed(10 + K)
    worst = 0.0
    for (_, C, H, W), act in set(gn_calls):
        shape = (batch, C, H, W)
        G = _groups(C)
        span = C * H * W // G
        what = f"groupnorm rows of {K} slices of {shape}"
        x = _rand(shape, gen, dev, torch.bfloat16, 0.5, 2.0)
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        b = 0.1 * torch.randn(C, generator=gen, device=dev)
        parts = [p.contiguous() for p in x.chunk(K, dim=2)]
        s1 = sum(groupnorm.groupnorm_partial_stats(p, G) for p in parts)
        _, e1 = check_stats(f"{what}: sums", s1,
                            groupnorm.groupnorm_partial_stats(x, G), x, G,
                            False)
        mean = s1 / span
        s2 = sum(groupnorm.groupnorm_partial_stats(p, G, mean)
                 for p in parts)
        _, e2 = check_stats(f"{what}: squares", s2,
                            groupnorm.groupnorm_partial_stats(x, G, mean), x,
                            G, True)
        rstd = torch.rsqrt(s2 / span + 1e-5)
        y = torch.cat([groupnorm.groupnorm_apply(p, mean, rstd, w, b, G,
                                                 act) for p in parts], 2)
        check_close(f"{what}: outputs", y,
                    groupnorm.groupnorm_swish(x, w, b, G, act=act),
                    *GN_TOL[torch.bfloat16])
        worst = max(worst, e1, e2)
    log(f"groupnorm rows, batch {batch}, {K} slices of each call: the "
        f"slices' stats summed against the whole's, largest relative error "
        f"{worst:.3g}; the slices normalized against the fused kernel on "
        f"the whole: within tolerance")
    return worst


def check_flash_forward(attn_calls, dev, timer, n, with_lse):
    """The flash forward kernels (with and without lse) against their plain
    version at every [B, N, C] of ``attn_calls``: the route's kernel in
    bf16 (mma or wide) and in f32 (simt), and the simt kernel on the bf16
    inputs too; where bf16 takes mma, also the mma.sync kernel that the
    Hopper kernel replaced (forced calls). Times at bf16 of the route's
    kernel and of the simt kernel on the same inputs (the variant with lse
    when ``with_lse``, as on a train path), and of the mma.sync kernel in
    turns with the Hopper one. Rows: the route's kernel at each shape, the
    simt kernel's forced calls where bf16 takes wide (the calls bf16 sent
    to simt before the wide kernels), the mma.sync kernel's where bf16
    takes mma. Returns {kernel: (max error, rows)}."""
    from itsd_tpu_torch.kernels import attention

    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("flash_attention_mma", "flash_attention_wide",
             "flash_attention_simt", "flash_attention_mma_sync")
    worst = dict.fromkeys(names, 0.0)
    rows = {k: [] for k in names}
    log("flash_attention: [B,N,C] x calls/step route | max_abs_err o: route "
        "bf16, simt bf16 f32, mma.sync bf16; lse | ms (bf16): route simt "
        "plain sdpa bound mma.sync | host us/call route simt")

    def forward(fn_lse, fn, q, k, v, scale, what):
        o, lse = fn_lse(q, k, v, scale)
        o2 = fn(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            fail(f"{what}: the lse variant and the plain forward disagree")
        return o, lse

    nan = float("nan")
    for (B, N, C), calls in collections.Counter(attn_calls).items():
        scale = C ** -0.5
        bf16_route = attention.route(torch.bfloat16, C, "forward")
        errs, lse_err = {(bf16_route, torch.bfloat16): nan}, 0.0
        cases = ([(torch.bfloat16, bf16_route)] if bf16_route != "simt"
                 else [])
        if bf16_route == "mma":
            cases.append((torch.bfloat16, "mma_sync"))
        for dtype, which in cases + [(torch.bfloat16, "simt"),
                                     (torch.float32, "simt")]:
            what = f"flash_attention {which} {(B, N, C)} {dtype}"
            q, k, v = (_rand((B, N, C), gen, dev, dtype) for _ in range(3))
            n0 = read_launches()
            if which == attention.route(dtype, C, "forward"):
                o, lse = forward(
                    attention.attention_with_lse,
                    lambda q, k, v, s: attention.spatial_attention(q, k, v),
                    q, k, v, scale, what)
            else:
                forced = (attention._flash_mma_sync if which == "mma_sync"
                          else attention._flash_simt)
                o, lse = forward(
                    lambda *a: forced(*a, emit_lse=True),
                    lambda *a: forced(*a, emit_lse=False),
                    q, k, v, scale, what)
            n1 = read_launches()
            if (n1[f"flash_attention_{which}"]
                    - n0[f"flash_attention_{which}"] != 2
                    or n1["flash_attention"] - n0["flash_attention"] != 2):
                fail(f"{what}: not launched on the {which} route")
            want_o, want_lse = attention.attention_plain_stats(q, k, v,
                                                               scale)
            if dtype == torch.float32:
                atol, rtol = ATTN_F32_TOL, 0.0
            else:
                atol = ATTN_BF16_RTOL * v.float().abs().max().item()
                rtol = ATTN_BF16_RTOL
            errs[which, dtype] = check_close(what, o, want_o, atol, rtol)
            lse_e = check_close(f"{what} lse", lse, want_lse, LSE_TOL, 0.0)
            lse_err = max(lse_err, lse_e)
            name = f"flash_attention_{which}"
            worst[name] = max(worst[name], errs[which, dtype], lse_e)
        q, k, v = (_rand((B, N, C), gen, dev, torch.bfloat16)
                   for _ in range(3))
        r_ms = r_host = y_ms = nan
        route_fn = ((lambda: attention.attention_with_lse(q, k, v, scale))
                    if with_lse else
                    (lambda: attention.spatial_attention(q, k, v)))
        if bf16_route == "mma":
            r_ms, y_ms, r_host, _ = timer.pair(
                route_fn, lambda: attention._flash_mma_sync(
                    q, k, v, scale, emit_lse=with_lse), n=n)
        elif bf16_route != "simt":
            r_ms, r_host = timer(route_fn, n=n)
        s_ms, s_host = timer(
            lambda: attention._flash_simt(q, k, v, scale, emit_lse=with_lse),
            n=n)
        p_ms, _ = timer(
            (lambda: attention.attention_plain_stats(q, k, v, scale))
            if with_lse else (lambda: attention.attention_plain(q, k, v,
                                                                scale)), n=n)
        l_ms, _ = timer(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None]), n=n)
        by_bytes, by_ops = attn_bound_ms(B, N, C, 2)
        log(f"  {[B, N, C]} x{calls} {bf16_route}"
            f"{' (with lse)' if with_lse else ''} | "
            f"{errs[bf16_route, torch.bfloat16]:.3g}, "
            f"{errs['simt', torch.bfloat16]:.3g} "
            f"{errs['simt', torch.float32]:.3g} "
            f"{errs.get(('mma_sync', torch.bfloat16), nan):.3g}; "
            f"{lse_err:.3g} | "
            f"{r_ms:.5f} {s_ms:.5f} {p_ms:.5f} {l_ms:.5f} "
            f"{max(by_bytes, by_ops):.5f} {y_ms:.5f} | {r_host:.1f} "
            f"{s_host:.1f}")
        rows[f"flash_attention_{bf16_route}"].append(
            (calls, r_ms if bf16_route != "simt" else s_ms, p_ms, l_ms,
             by_bytes, by_ops))
        if bf16_route == "mma":
            rows["flash_attention_mma_sync"].append(
                (calls, y_ms, p_ms, l_ms, by_bytes, by_ops))
        if bf16_route == "wide":
            rows["flash_attention_simt"].append(
                (calls, s_ms, p_ms, l_ms, by_bytes, by_ops))
    return {k: (worst[k], rows[k]) for k in rows}


# The 256x256 flagship's attention at its 64x64 stage (configs/
# imagenet256_uncond.yaml, batch 1): one call, no GroupNorm, in the layout
# of path_shapes.
FLAGSHIP_ATTENTION = ([], [(1, 4096, 384)])
# The 256x256 flagship's largest GroupNorm spans (configs/
# imagenet256_uncond.yaml: ch 128, ch_mult 1,2,3,4), at batch 1: 12, 8 and 4
# channels of 65,536 pixels a group, each span split over a cluster.
FLAGSHIP_GN_SHAPES = ((1, 384, 256, 256), (1, 256, 256, 256),
                      (1, 128, 256, 256))


def check_flagship_groupnorm(dev, timer):
    """GroupNorm+swish at FLAGSHIP_GN_SHAPES in bf16 and f32: the kernel
    against its plain version, two launches equal bit for bit, and the
    backward (the kernel path's autograd.Function) against autograd of the
    plain version; times at bf16 (rows) and of the kernel in f32, whose
    largest span is not held on chip. Returns (max error, rows)."""
    from itsd_tpu_torch.kernels import groupnorm
    from itsd_tpu_torch.models.unet import _groups

    gen = torch.Generator(device=dev).manual_seed(3)
    worst, rows = 0.0, []
    log("groupnorm_swish, the flagship's spans (batch 1, act): shape | "
        "max_abs_err bf16 f32; backward dx dw db bf16 f32 | kernel plain "
        "library bound ms (bf16) | kernel bound ms (f32)")
    for shape in FLAGSHIP_GN_SHAPES:
        C = shape[1]
        G = _groups(C)
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        b = 0.1 * torch.randn(C, generator=gen, device=dev)
        errs, bwd, k_ms = [], [], {}
        for dtype in (torch.bfloat16, torch.float32):
            what = f"groupnorm_swish {shape} {dtype}"
            x = _rand(shape, gen, dev, dtype, 0.5, 2.0)
            got = groupnorm.groupnorm_swish(x, w, b, G)
            again = groupnorm.groupnorm_swish(x, w, b, G)
            want = groupnorm.groupnorm_swish_plain(x, w, b, G)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{what}: two launches on the same input differ")
            errs.append(check_close(what, got, want, *GN_TOL[dtype]))
            xg, wg, bg = (t.detach().clone().requires_grad_()
                          for t in (x, w, b))
            gy = _rand(shape, gen, dev, dtype)
            got = torch.autograd.grad(
                groupnorm.groupnorm_swish(xg, wg, bg, G), (xg, wg, bg), gy)
            want = torch.autograd.grad(
                groupnorm.groupnorm_swish_plain(xg, wg, bg, G), (xg, wg, bg),
                gy)
            torch.cuda.synchronize()
            bwd += [check_close(f"{what} backward {name}", g, w_,
                                GN_BWD_TOL, 0.0)
                    for name, g, w_ in zip(("dx", "dw", "db"), got, want)]
            del xg, wg, bg, gy, got, want
            k_ms[dtype], _ = timer(
                lambda: groupnorm.groupnorm_swish(x, w, b, G), n=20)
            if dtype == torch.bfloat16:
                wl, bl = w.to(dtype), b.to(dtype)
                p_ms, _ = timer(
                    lambda: groupnorm.groupnorm_swish_plain(x, w, b, G), n=5)
                l_ms, _ = timer(
                    lambda: F.silu(F.group_norm(x, G, wl, bl, 1e-5)), n=20)
        worst = max(worst, *errs)
        by_bytes, by_ops = gn_bound_ms(shape, 2, True)
        log(f"  {list(shape)} | {errs[0]:.3g} {errs[1]:.3g}; "
            f"{' '.join(f'{e:.3g}' for e in bwd)} | "
            f"{k_ms[torch.bfloat16]:.5f} {p_ms:.5f} {l_ms:.5f} "
            f"{max(by_bytes, by_ops):.5f} | {k_ms[torch.float32]:.5f} "
            f"{max(gn_bound_ms(shape, 4, True)):.5f}")
        rows.append((1, k_ms[torch.bfloat16], p_ms, l_ms, by_bytes, by_ops))
    return worst, rows


def sum_order_bounds(q, k, v, do, lse, scale):
    """Elementwise bounds on how far two f32 evaluations of dq and dk may
    differ through the order of the sums in dp = dO.v^T alone (as
    tests/test_torch_cuda.py:_dq_order_bound): the products of bf16 values
    are exact in f32, so two orders of a C-term sum differ by at most
    C * 2^-23 * sum|terms|; p carries that into ds = p * (dp - dd), and
    scale * |ds|.|k| (|ds|^T.|q|) into dq (dk); dv has no such term. Where
    ds cancels to ~0 (N = 1 without dlse: p = 1 and dp = dd, so dq = dk = 0
    in exact arithmetic, the CFG UNet's 1x1 attention) the outputs are this
    rounding noise, which a tolerance scaled by max|plain| cannot judge;
    elsewhere the bound is a small part of the bf16 tolerance."""
    from itsd_tpu_torch.kernels import attention

    C = q.shape[-1]
    p = torch.exp(attention._scores(q, k, scale) - lse[..., None])
    e = p * torch.einsum("bqc,bkc->bqk", do.float().abs(), v.float().abs())
    e *= scale * C * 2.0 ** -23
    return (torch.einsum("bqk,bkc->bqc", e, k.float().abs()),
            torch.einsum("bqk,bqc->bkc", e, q.float().abs()), None)


def check_forward_kernels(paths, rows_paths, dev, timer):
    """Phase 2: both forward kernels at the shapes of each path of
    ``paths`` (tag -> ((gn_calls, attn_calls), timing reps, with lse)), and
    the stats and apply kernels of GroupNorm over row shards at each path
    of ``rows_paths`` (tag -> (gn_calls, batch)) cut over each K of
    ``ROWS_K`` (tag ``{tag}_k{K}``). Returns {kernel: {tag: (err,
    rows)}}."""
    t0 = time.perf_counter()
    log(f"  tolerance GroupNorm: |err| <= atol + rtol*|plain|, bf16 atol "
        f"{GN_TOL[torch.bfloat16][0]} rtol 2^-7, f32 atol "
        f"{GN_TOL[torch.float32][0]}; attention: o f32 {ATTN_F32_TOL}, o bf16 "
        f"2^-7*max|v| + 2^-7*|plain|, lse {LSE_TOL}")
    out = collections.defaultdict(dict)
    for tag, ((gn_calls, attn_calls), n, with_lse) in paths.items():
        log(f"-- shapes of one {tag} step")
        if gn_calls:
            out["groupnorm_swish"][tag] = check_groupnorm(gn_calls, dev,
                                                          timer, n)
        for name, res in check_flash_forward(attn_calls, dev, timer, n,
                                             with_lse).items():
            out[name][tag] = res
    out["groupnorm_swish"]["flagship"] = check_flagship_groupnorm(dev, timer)
    for tag, (gn_calls, batch) in rows_paths.items():
        for K in ROWS_K:
            for name, res in check_groupnorm_rows(gn_calls, batch, K, dev,
                                                  timer, 5).items():
                out[name][f"{tag}_k{K}"] = res
            check_rows_make_the_whole(gn_calls, batch, K, dev)
    phase_done(2, "forward kernels against their plain versions", t0,
               "(all within tolerance)")
    return out


def check_backward_kernels(paths, dev, timer):
    """Phase 5: the dq and dk/dv kernels against their plain versions at
    the attention shapes of each train path of ``paths`` (tag ->
    ((gn_calls, attn_calls), more shapes[, timing reps])), in bf16 and f32
    (with a random dO, and a nonzero dlse at a path's first shape), and,
    where bf16 routes either to a tensor-core kernel, the simt dq and dk/dv
    kernels on the bf16 inputs too, and where it routes to mma, the
    mma.sync dq and dk/dv the Hopper kernels replaced (forced calls);
    times at bf16 of the route's kernels and the simt
    ones, on the same inputs, the Hopper dq and dk/dv each in turns with
    its mma.sync kernel, beside the plain versions, the backward of
    SDPA and the bound (rows: the route's kernels, the mma.sync kernels
    where bf16 takes mma, and the simt dq's and dk/dv's forced calls where
    it takes wide). Then the GroupNorm backward at each path's shapes.
    Returns {kernel: {tag: (max error, rows)}}."""
    from itsd_tpu_torch.kernels import attention

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    kernels = ("flash_bwd_dq_mma", "flash_bwd_dq_wide", "flash_bwd_dq_simt",
               "flash_bwd_dkv_mma", "flash_bwd_dkv_wide",
               "flash_bwd_dkv_simt", "flash_bwd_dq_mma_sync",
               "flash_bwd_dkv_mma_sync")
    out = {k: {} for k in kernels}
    log("flash backward: [B,N,C] x calls/step routes | max_abs_err dq dk dv "
        "bf16 (routes), dq dk dv bf16 simt, dq dk dv f32 (simt), dq dk dv "
        "bf16 mma.sync | ms (bf16): dq route simt plain bound mma.sync, dkv "
        "route simt plain bound mma.sync | sdpa bwd ms | host us/call dq "
        "route simt, dkv route simt")
    log(f"  tolerance: f32 {BWD_F32_TOL}; bf16 2^-7*max|plain| + "
        f"2^-7*|plain| + the f32 summation-order bound of dq and dk")

    def check_grads(what, got, want, dtype, bounds, names=("dq", "dk", "dv")):
        e = []
        for name, g, w, bound in zip(names, got, want, bounds):
            if dtype == torch.float32:
                atol, rtol, bound = BWD_F32_TOL, 0.0, None
            else:
                atol = BWD_BF16_RTOL * w.float().abs().max().item()
                rtol = BWD_BF16_RTOL
            e.append(check_close(f"{what} {name}", g, w, atol, rtol, bound))
        return e

    def note(e, routes):
        worst[f"flash_bwd_dq_{routes[0]}"] = max(
            worst[f"flash_bwd_dq_{routes[0]}"], e[0])
        worst[f"flash_bwd_dkv_{routes[1]}"] = max(
            worst[f"flash_bwd_dkv_{routes[1]}"], *e[1:])

    nan = (float("nan"), float("nan"))
    for tag, ((gn_calls, attn_calls), more, *reps) in paths.items():
        log(f"-- shapes of one {tag} step")
        n = reps[0] if reps else 5  # 10 until the data-parallel phase
        worst = dict.fromkeys(kernels, 0.0)
        rows = {k: [] for k in kernels}
        counts = collections.Counter(attn_calls)
        for i, (B, N, C) in enumerate(list(counts) + list(more)):
            scale = C ** -0.5
            bf16_routes = (attention.route(torch.bfloat16, C, "dq"),
                           attention.route(torch.bfloat16, C, "dkv"))
            errs = {}
            for dtype in (torch.bfloat16, torch.float32):
                what = f"flash backward {(B, N, C)} {dtype}"
                q, k, v, do = (_rand((B, N, C), gen, dev, dtype)
                               for _ in range(4))
                o, lse = attention.attention_with_lse(q, k, v, scale)
                dlse = (torch.randn((B, N), generator=gen, device=dev)
                        if i == 0 else None)
                n0 = read_launches()
                got = attention.attention_bwd(q, k, v, o, lse, do, scale,
                                              dlse)
                n1 = read_launches()
                want = attention.attention_bwd_plain(q, k, v, o, lse, do,
                                                     scale, dlse)
                torch.cuda.synchronize()
                routes = (attention.route(dtype, C, "dq"),
                          attention.route(dtype, C, "dkv"))
                for fn, which in zip(("flash_bwd_dq", "flash_bwd_dkv"),
                                     routes):
                    if (n1[f"{fn}_{which}"] - n0[f"{fn}_{which}"] != 1
                            or n1[fn] - n0[fn] != 1):
                        fail(f"{what}: {fn} not on the {which} route")
                bounds = sum_order_bounds(q, k, v, do, lse, scale)
                e = check_grads(f"{what} dlse={dlse is not None}", got, want,
                                dtype, bounds)
                errs[dtype] = e
                note(e, routes)
                if routes != ("simt", "simt"):
                    # the simt kernels, same inputs
                    dd = attention.row_dd(o, do, dlse).contiguous()
                    got = (attention._flash_bwd_dq_simt(q, k, v, do, lse, dd,
                                                        scale),
                           *attention._flash_bwd_dkv_simt(q, k, v, do, lse,
                                                          dd, scale))
                    torch.cuda.synchronize()
                    errs["simt"] = check_grads(f"{what} simt", got, want,
                                               dtype, bounds)
                    note(errs["simt"], ("simt", "simt"))
                if routes == ("mma", "mma"):
                    # the mma.sync dq and dk/dv the Hopper kernels
                    # replaced, forced
                    n0 = read_launches()
                    got = (attention._flash_bwd_dq_mma_sync(q, k, v, do, lse,
                                                            dd, scale),
                           *attention._flash_bwd_dkv_mma_sync(q, k, v, do,
                                                              lse, dd,
                                                              scale))
                    n1 = read_launches()
                    torch.cuda.synchronize()
                    for fn in ("flash_bwd_dq_mma_sync",
                               "flash_bwd_dkv_mma_sync"):
                        if n1[fn] - n0[fn] != 1:
                            fail(f"{what}: {fn} not launched")
                    errs["mma_sync"] = check_grads(
                        f"{what} mma.sync", got, want, dtype, bounds)
                    note(errs["mma_sync"], ("mma_sync", "mma_sync"))
            if bf16_routes == ("simt", "simt"):
                errs["simt"] = errs[torch.bfloat16]
            q, k, v, do = (_rand((B, N, C), gen, dev, torch.bfloat16)
                           for _ in range(4))
            o, lse = attention.attention_with_lse(q, k, v, scale)
            dd = attention.row_dd(o, do).contiguous()
            args = (q, k, v, do, lse, dd, scale)
            dq_sync_ms = float("nan")
            if bf16_routes[0] == "mma":
                dq_ms, dq_sync_ms, dq_host, _ = timer.pair(
                    lambda: attention.flash_bwd_dq(*args),
                    lambda: attention._flash_bwd_dq_mma_sync(*args), n=n)
            elif bf16_routes[0] != "simt":
                dq_ms, dq_host = timer(lambda: attention.flash_bwd_dq(*args),
                                       n=n)
            else:
                dq_ms, dq_host = nan
            dq_simt_ms, dq_simt_host = timer(
                lambda: attention._flash_bwd_dq_simt(*args), n=n)
            sync_ms = float("nan")
            if bf16_routes[1] == "mma":
                dkv_ms, sync_ms, dkv_host, _ = timer.pair(
                    lambda: attention.flash_bwd_dkv(*args),
                    lambda: attention._flash_bwd_dkv_mma_sync(*args), n=n)
            elif bf16_routes[1] != "simt":
                dkv_ms, dkv_host = timer(
                    lambda: attention.flash_bwd_dkv(*args), n=n)
            else:
                dkv_ms, dkv_host = nan
            simt_ms, simt_host = timer(
                lambda: attention._flash_bwd_dkv_simt(*args), n=n)
            dq_plain, _ = timer(lambda: attention.flash_bwd_dq_plain(*args),
                                n=n)
            dkv_plain, _ = timer(
                lambda: attention.flash_bwd_dkv_plain(*args), n=n)
            qs, ks, vs = (t[:, None].detach().requires_grad_()
                          for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
            sdpa_ms, _ = timer(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), do[:, None], retain_graph=True), n=n)
            del qs, ks, vs, sdpa_out
            b_dq = attn_bound_ms(B, N, C, 2, tensors=5, products=3)
            b_dkv = attn_bound_ms(B, N, C, 2, tensors=6, products=4)
            calls = counts.get((B, N, C), 0)
            log(f"  {[B, N, C]} x{calls} dq {bf16_routes[0]} dkv "
                f"{bf16_routes[1]} | "
                f"{' '.join(f'{x:.3g}' for x in errs[torch.bfloat16])}, "
                f"{' '.join(f'{x:.3g}' for x in errs['simt'])}, "
                f"{' '.join(f'{x:.3g}' for x in errs[torch.float32])}, "
                f"{' '.join(f'{x:.3g}' for x in errs.get('mma_sync', ()))}"
                f" | dq {dq_ms:.5f} {dq_simt_ms:.5f} {dq_plain:.5f} "
                f"{max(b_dq):.5f} {dq_sync_ms:.5f}, dkv {dkv_ms:.5f} "
                f"{simt_ms:.5f} "
                f"{dkv_plain:.5f} {max(b_dkv):.5f} {sync_ms:.5f} | "
                f"{sdpa_ms:.5f} | "
                f"{dq_host:.1f} {dq_simt_host:.1f}, {dkv_host:.1f} "
                f"{simt_host:.1f}")
            if not calls:
                continue
            dq_route, dkv_route = bf16_routes
            rows[f"flash_bwd_dq_{dq_route}"].append(
                (calls, dq_ms if dq_route != "simt" else dq_simt_ms,
                 dq_plain, sdpa_ms, *b_dq))
            rows[f"flash_bwd_dkv_{dkv_route}"].append(
                (calls, dkv_ms if dkv_route != "simt" else simt_ms,
                 dkv_plain, sdpa_ms, *b_dkv))
            if dq_route == "mma":
                rows["flash_bwd_dq_mma_sync"].append(
                    (calls, dq_sync_ms, dq_plain, sdpa_ms, *b_dq))
            if dkv_route == "mma":
                rows["flash_bwd_dkv_mma_sync"].append(
                    (calls, sync_ms, dkv_plain, sdpa_ms, *b_dkv))
            if dq_route == "wide":
                rows["flash_bwd_dq_simt"].append(
                    (calls, dq_simt_ms, dq_plain, sdpa_ms, *b_dq))
            if dkv_route == "wide":
                rows["flash_bwd_dkv_simt"].append(
                    (calls, simt_ms, dkv_plain, sdpa_ms, *b_dkv))
        for k in kernels:
            out[k][tag] = (worst[k], rows[k])
        if gn_calls:
            check_groupnorm_backward(tag, gn_calls, gen, dev, timer,
                                     min(n, 5))
    phase_done(5, "backward kernels against their plain versions", t0,
               "(all within tolerance)")
    return out


def check_groupnorm_backward(tag, gn_calls, gen, dev, timer, n=5):
    """The GroupNorm backward: the kernel path's autograd.Function (kernel
    forward, plain recompute in the backward) against autograd of the
    plain version, and its time beside F.group_norm's autograd."""
    from itsd_tpu_torch.kernels import groupnorm
    from itsd_tpu_torch.models.unet import _groups

    log("groupnorm backward (autograd through the plain recompute): shape "
        "act x calls/step | max_abs_err dx dw db bf16 | fwd+bwd ms: kernel "
        "path, F.group_norm(+silu)")
    gn_ms = gn_lib_ms = 0.0
    for (shape, act), calls in collections.Counter(gn_calls).items():
        C = shape[1]
        G = _groups(C)
        x = _rand(shape, gen, dev, torch.bfloat16, 0.5, 2.0).requires_grad_()
        w = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)
             ).requires_grad_()
        b = (0.1 * torch.randn(C, generator=gen, device=dev)).requires_grad_()
        gy = _rand(shape, gen, dev, torch.bfloat16)
        got = torch.autograd.grad(
            groupnorm.groupnorm_swish(x, w, b, G, act=act), (x, w, b), gy)
        want = torch.autograd.grad(
            groupnorm.groupnorm_swish_plain(x, w, b, G, act=act), (x, w, b),
            gy)
        torch.cuda.synchronize()
        errs = [check_close(f"groupnorm backward {name} {shape} act={act}",
                            g, w_, GN_BWD_TOL, 0.0)
                for name, g, w_ in zip(("dx", "dw", "db"), got, want)]
        ms, _ = timer(lambda: torch.autograd.grad(
            groupnorm.groupnorm_swish(x, w, b, G, act=act), (x, w, b), gy),
            n=n)

        def lib():
            y = F.group_norm(x, G, w.to(x.dtype), b.to(x.dtype), 1e-5)
            return torch.autograd.grad(F.silu(y) if act else y, (x, w, b),
                                       gy)

        l_ms, _ = timer(lib, n=n)
        gn_ms += calls * ms
        gn_lib_ms += calls * l_ms
        log(f"  {list(shape)} act={int(act)} x{calls} | "
            f"{' '.join(f'{e:.3g}' for e in errs)} | {ms:.5f} {l_ms:.5f}")
    log(f"groupnorm fwd+bwd, one {tag} step ({len(gn_calls)} calls): kernel "
        f"path {gn_ms:.3f} ms, F.group_norm(+silu) autograd {gn_lib_ms:.3f} "
        "ms")


def forward_split(params, tmpdir, timer, reps: int = 5):
    """Device time (least of ``reps``) and host launch time (median) of one
    UNet forward at the main path's shapes, to set against the wall time of
    a step."""
    from itsd_tpu_torch.cli import runner

    cfg = eval_config(tmpdir)
    model, _ = runner.build_model(cfg)
    model.load_state_dict(params)
    model.to(DEVICE).eval()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x = torch.randn((BATCH, 32, 32, 3), generator=gen, device=DEVICE)
    t = torch.full((BATCH,), 500, device=DEVICE, dtype=torch.int64)
    with torch.inference_mode():
        dev_ms, host_us = timer(lambda: model(x, t), n=1, warmup=2,
                                reps=reps)
    return dev_ms, host_us / 1e3


def reset_launches():
    from itsd_tpu_torch.kernels import attention, groupnorm

    groupnorm.launches = 0
    groupnorm.stats_launches = groupnorm.apply_launches = 0
    groupnorm.stats_cluster_launches = 0
    attention.launches = attention.mma_launches = 0
    attention.wide_launches = attention.mma_sync_launches = 0
    attention.dq_launches = attention.dq_mma_launches = 0
    attention.dq_wide_launches = attention.dq_mma_sync_launches = 0
    attention.dkv_launches = attention.dkv_mma_launches = 0
    attention.dkv_wide_launches = attention.dkv_mma_sync_launches = 0


def read_launches() -> dict:
    """Launches so far: the totals of each function (every route) and, for
    the flash forward, dq and dk/dv, of each route's kernel (and of the
    forced calls of the mma.sync forward, dq and dk/dv, and of the earlier
    stats kernel)."""
    from itsd_tpu_torch.kernels import attention, groupnorm

    a = attention
    return route_counts(
        gn=groupnorm.launches, gn_stats=groupnorm.stats_launches,
        gn_apply=groupnorm.apply_launches, fwd=a.launches,
        fwd_mma=a.mma_launches,
        fwd_wide=a.wide_launches, dq=a.dq_launches,
        dq_mma=a.dq_mma_launches, dq_wide=a.dq_wide_launches,
        dkv=a.dkv_launches, dkv_mma=a.dkv_mma_launches,
        dkv_wide=a.dkv_wide_launches, fwd_mma_sync=a.mma_sync_launches,
        dq_mma_sync=a.dq_mma_sync_launches,
        dkv_mma_sync=a.dkv_mma_sync_launches,
        gn_stats_cluster=groupnorm.stats_cluster_launches)


def route_counts(gn=0, fwd=0, fwd_mma=0, fwd_wide=0, dq=0, dq_mma=0,
                 dq_wide=0, dkv=0, dkv_mma=0, dkv_wide=0, gn_stats=0,
                 gn_apply=0, fwd_mma_sync=0, dq_mma_sync=0, dkv_mma_sync=0,
                 gn_stats_cluster=0):
    """Launch counts in the layout of ``read_launches``: each function's
    total and each route's kernel (simt: what the others leave), and the
    forced calls of the mma.sync forward, dq and dk/dv and of the earlier
    stats kernel (no path makes one)."""
    return {"groupnorm_swish": gn, "groupnorm_partial_stats": gn_stats,
            "groupnorm_partial_stats_cluster": gn_stats_cluster,
            "groupnorm_apply": gn_apply, "flash_attention": fwd,
            "flash_attention_mma": fwd_mma,
            "flash_attention_wide": fwd_wide,
            "flash_attention_mma_sync": fwd_mma_sync,
            "flash_attention_simt": fwd - fwd_mma - fwd_wide - fwd_mma_sync,
            "flash_bwd_dq": dq, "flash_bwd_dq_mma": dq_mma,
            "flash_bwd_dq_wide": dq_wide,
            "flash_bwd_dq_mma_sync": dq_mma_sync,
            "flash_bwd_dq_simt": dq - dq_mma - dq_wide - dq_mma_sync,
            "flash_bwd_dkv": dkv,
            "flash_bwd_dkv_mma": dkv_mma, "flash_bwd_dkv_wide": dkv_wide,
            "flash_bwd_dkv_mma_sync": dkv_mma_sync,
            "flash_bwd_dkv_simt": dkv - dkv_mma - dkv_wide - dkv_mma_sync}


def step_counts(gn, attn, mma=0, wide=0):
    """Launches of one train step whose forward makes ``gn`` GroupNorm and
    ``attn`` attention calls: as many dq and dk/dv as forwards, ``mma`` of
    each on the mma route and ``wide`` of each on the wide route."""
    return route_counts(gn=gn, fwd=attn, fwd_mma=mma, fwd_wide=wide,
                        dq=attn, dq_mma=mma, dq_wide=wide, dkv=attn,
                        dkv_mma=mma, dkv_wide=wide)


def scaled(counts: dict, k: float) -> dict:
    return {name: n * k for name, n in counts.items()}


def eval_path(params, tmpdir, card_line, gn_per_step, attn_per_step, timer):
    """Phase 3: runner.evaluate at full width; returns the launch counts."""
    from itsd_tpu_torch.cli import runner

    t0 = time.perf_counter()
    cfg = eval_config(tmpdir)
    reset_launches()
    out = runner.evaluate(cfg, params, device=DEVICE)
    launches = read_launches()
    seconds = time.perf_counter() - t0
    imgs = out["images"]
    n = attn_per_step * T_STEPS
    want = route_counts(gn=gn_per_step * T_STEPS, fwd=n, fwd_mma=n)
    if (gn_per_step, attn_per_step) != (51, 6) or launches != want:
        fail(f"launch counts {launches}, want 51 and 6 per step x {T_STEPS}, "
             f"every flash forward on the mma route (one forward made "
             f"{gn_per_step} and {attn_per_step})")
    if imgs.shape != (BATCH, 32, 32, 3) or not np.isfinite(imgs).all():
        fail(f"images of shape {imgs.shape}, finite: "
             f"{bool(np.isfinite(imgs).all())}")
    step_ms = seconds / T_STEPS * 1e3
    log(f"evaluate: T={T_STEPS} batch {BATCH} bf16 in {seconds:.3f} s = "
        f"{BATCH / seconds:.4f} images/s ({step_ms:.3f} ms/step) on "
        f"{card_line}; launches {launches}; images min {imgs.min():.3f} "
        f"max {imgs.max():.3f} std {imgs.std():.3f}")
    dev_ms, host_ms = forward_split(params, tmpdir, timer)
    log(f"one UNet forward: device {dev_ms:.3f} ms, host launch {host_ms:.3f} "
        f"ms; a step takes {step_ms:.3f} ms wall, so the device is busy "
        f"~{100 * dev_ms / step_ms:.1f}% of it (the model part)")
    phase_done(3, "eval path (runner.evaluate)", t0)
    return launches


def plain_path():
    """Patch the UNet's kernel calls with the plain versions (autograd
    then runs through plain PyTorch ops)."""
    from itsd_tpu_torch.kernels import attention, groupnorm
    from itsd_tpu_torch.models import unet

    def plain_attention(q, k, v, impl="auto"):
        return attention.attention_plain(q, k, v, q.shape[-1] ** -0.5)

    return (mock.patch.object(unet, "groupnorm_swish",
                              groupnorm.groupnorm_swish_plain),
            mock.patch.object(unet, "spatial_attention", plain_attention))


def eval_parity(params, tmpdir):
    """Phase 4: the kernel path against the plain path, in f32 and bf16:
    one full-width UNet forward (eps) at timesteps spread over the chain,
    then 20 denoising steps from one x_T with one fed noise sequence."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import denoise_segment

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    x_T = torch.randn((BATCH, 32, 32, 3), generator=gen, device=dev)
    noise = [torch.randn((BATCH, 32, 32, 3), generator=gen, device=dev)
             for _ in range(PARITY_STEPS)]
    t_eps = torch.linspace(0, T_STEPS - 1, BATCH, device=dev).round().long()
    f32_launches = {}

    def check(what, name, got, want, tol):
        err = (got - want).abs().max().item()
        ok = np.isfinite(err) and err <= tol
        log(f"path parity {name} {what}: max_abs_err {err:.3g} (tol {tol}), "
            f"max |plain| {want.abs().max().item():.3f} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path parity {name} {what}: {err:.3g} > {tol}")
        return err

    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = eval_config(tmpdir, dtype=name)
        model, _ = runner.build_model(cfg)
        model.load_state_dict(params)
        model.to(dev).eval()
        sched = runner.build_schedule(cfg, inference=True, device=dev)

        def run():
            with torch.inference_mode():
                eps = model(x_T, t_eps)
                x = denoise_segment(sched, model, x_T, PARITY_STEPS, 0,
                                    noise_fn=lambda i, t: noise[i])
            return eps, x

        reset_launches()
        got_eps, got = run()
        n1 = read_launches()
        n = 6 * (1 + PARITY_STEPS)
        want_n = route_counts(gn=51 * (1 + PARITY_STEPS), fwd=n,
                              fwd_mma=n if dtype == torch.bfloat16 else 0)
        if n1 != want_n:
            fail(f"the kernel path launched {n1}, want {want_n}")
        if dtype == torch.float32:
            f32_launches = n1
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            want_eps, want = run()
        if read_launches() != n1:
            fail("the plain path launched a kernel")
        check("eps (one forward)", name, got_eps, want_eps, EPS_TOL[dtype])
        check(f"x ({PARITY_STEPS} steps)", name, got, want, PATH_TOL[dtype])
    phase_done(4, "eval path parity", t0)
    return f32_launches


def train_parity(tmpdir):
    """Phase 6: TRAIN_PARITY_STEPS optimizer steps of the kernel path and
    the plain path from the same seeded params (output layers scaled up, so
    that the attention grads are not ~0), batches, t and noise, dropout 0,
    at full width and batch 128, in f32 and bf16."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                      make_optimizer, make_train_step)

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    images, _ = shapes_dataset(n=TRAIN_BATCH * TRAIN_PARITY_STEPS, seed=7)
    batches = torch.from_numpy(images).to(dev).split(TRAIN_BATCH)
    gen = torch.Generator(device=dev).manual_seed(8)
    ts = [torch.randint(0, T_STEPS, (TRAIN_BATCH,), generator=gen,
                        device=dev) for _ in batches]
    noises = [torch.randn(b.shape, generator=gen, device=dev)
              for b in batches]
    results, f32_launches = {}, {}
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = train_config(tmpdir, name, "dropout=0.0")
        params = seeded_params(cfg)
        sched = runner.build_schedule(cfg, device=dev)

        def run():
            model, _ = runner.build_model(cfg)
            model.load_state_dict(params)
            model.to(dev)
            tx = make_optimizer(OptimizerConfig(
                lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
                grad_clip=cfg.train.grad_clip,
                multiplier=cfg.train.multiplier, epochs=cfg.train.epoch,
                steps_per_epoch=16), model.parameters())
            state = create_train_state(model, tx)
            step = make_train_step(sched, ema_decay=cfg.train.ema_decay)
            metrics = [step(state, {"image": x}, None, t, nz)
                       for x, t, nz in zip(batches, ts, noises)]
            return ([(m["loss"].item(), m["grad_norm"].item())
                     for m in metrics], model.state_dict())

        reset_launches()
        got, got_params = run()
        n1 = read_launches()
        per = {k: n / TRAIN_PARITY_STEPS for k, n in n1.items()}
        mma = 6 if dtype == torch.bfloat16 else 0
        if per != step_counts(51, 6, mma):
            fail(f"train parity {name}: the kernel path launched {per} a "
                 "step")
        if dtype == torch.float32:
            f32_launches = n1
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            want, want_params = run()
        if read_launches() != n1:
            fail("train parity: the plain path launched a kernel")
        loss_err = max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, want))
        gnorm_err = max(abs(g[1] - w[1]) / abs(w[1])
                        for g, w in zip(got, want))
        param_err = max((got_params[k] - w).abs().max().item()
                        for k, w in want_params.items())
        ok = (loss_err <= TRAIN_LOSS_RTOL[dtype]
              and gnorm_err <= TRAIN_GNORM_RTOL[dtype]
              and param_err <= TRAIN_PARAM_TOL[dtype]
              and all(np.isfinite(x) for m in got for x in m))
        log(f"train parity {name}: {TRAIN_PARITY_STEPS} steps, batch "
            f"{TRAIN_BATCH}; losses {[round(g[0], 6) for g in got]} vs "
            f"{[round(w[0], 6) for w in want]}; grad norms "
            f"{[round(g[1], 5) for g in got]} vs "
            f"{[round(w[1], 5) for w in want]}; rel err loss {loss_err:.3g} "
            f"(tol {TRAIN_LOSS_RTOL[dtype]}), grad norm {gnorm_err:.3g} "
            f"(tol {TRAIN_GNORM_RTOL[dtype]}); max |dparam| {param_err:.3g} "
            f"(tol {TRAIN_PARAM_TOL[dtype]}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"train parity {name} beyond its limits")
        results[name] = (loss_err, gnorm_err, param_err)
    phase_done(6, "train-step parity", t0)
    return results, f32_launches


def profile_steps(step, state, batch, gen, n=3):
    """The device ms a step by kernel name over ``n`` steps, from
    torch.profiler (device-side events: kernels and copies; the optimizer's
    annotation range, which spans its kernels, is left out), and the wall
    ms a step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = collections.Counter()
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Optimizer.", "ProfilerStep"))):
            kernels[e.key] += e.self_device_time_total / 1e3 / n
    return kernels, wall_ms / n


def _category(name: str) -> str:
    n = name.lower()
    for cat, keys in (
            ("flash_fwd mma (ours)", ("flash_fwd_hopper_kernel",
                                      "flash_fwd_mma_kernel")),
            ("flash_fwd wide (ours)", ("flash_fwd_wide_kernel",)),
            ("flash_fwd simt (ours)", ("flash_fwd_kernel",)),
            ("flash_bwd_dq mma (ours)", ("flash_bwd_dq_hopper_kernel",
                                         "flash_bwd_dq_mma_kernel")),
            ("flash_bwd_dq wide (ours)", ("flash_bwd_dq_wide_kernel",)),
            ("flash_bwd_dq simt (ours)", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv mma (ours)", ("flash_bwd_dkv_hopper_kernel",
                                          "flash_bwd_dkv_mma_kernel")),
            ("flash_bwd_dkv wide (ours)", ("flash_bwd_dkv_wide_kernel",)),
            ("flash_bwd_dkv simt (ours)", ("flash_bwd_dkv_kernel",)),
            ("groupnorm (ours)", ("groupnorm_swish_kernel",
                                  "groupnorm_stats", "groupnorm_apply")),
            ("optimizer (foreach)", ("multi_tensor", "foreach")),
            ("conv/gemm", ("conv", "gemm", "xmma", "cutlass", "wgrad",
                           "dgrad", "fprop", "nchwtonhwc", "nhwctonchw",
                           "sm90", "sm80")),
            ("reduce", ("reduce",)),
            ("elementwise", ("elementwise", "copy", "fill",
                             "index", "cat"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def train_path(tmpdir, card_line):
    """Phase 7: runner.train at the full configuration; checks the launches
    a step, the loss and the checkpoint; measures the step."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                      make_optimizer, make_train_step)
    from itsd_tpu_torch.train.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = train_config(tmpdir, "bfloat16", "train.profile_steps=2",
                       f"diffusion.inference_T={GRID_T}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = runner.train(cfg, device=DEVICE)
    torch.cuda.synchronize()
    launches = read_launches()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = out["steps"]
    losses = np.asarray(out["losses"])
    grids = TRAIN_EPOCHS // cfg.train.eval_freq
    grid_steps = grids * GRID_T  # each grid: GRID_T sampler steps
    grid_launches = route_counts(gn=51 * grid_steps, fwd=6 * grid_steps,
                                 fwd_mma=6 * grid_steps)
    per_step = {k: (n - grid_launches[k]) / steps
                for k, n in launches.items()}
    log(f"train: {steps} steps of batch {TRAIN_BATCH} in {seconds:.2f} s "
        f"(dataset, checkpoints and {grids} sample grid(s) of T={GRID_T} at "
        f"batch {TRAIN_GRID_BATCH} included); launches {launches}; per train "
        f"step {per_step}")
    if per_step != step_counts(51, 6, 6):
        fail(f"launches per train step {per_step}, want 6/6/6/51, the flash "
             "forwards, dq and dk/dv on the mma route")
    first, last = losses[:16].mean(), losses[-16:].mean()
    log(f"loss: first {losses[0]:.5f}, mean of the first 16 steps "
        f"{first:.5f}, of the last 16 {last:.5f}, final {losses[-1]:.5f}")
    if (steps != TRAIN_EPOCHS * 16 or not np.isfinite(losses).all()
            or not last < 0.5 * first):
        fail("the train loss is not finite or did not fall to half of its "
             "first epoch's mean")
    trace = os.path.join(cfg.metrics_save_dir, "trace", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"train.profile_steps=2: {trace} ({os.path.getsize(trace) / 1e6:.2f} "
        f"MB, {len(events)} events, {n_kernels} kernels; regions step_0 "
        f"{names['step_0']}, step_1 {names['step_1']})")
    if (out["trace"] != trace or not n_kernels or not names["step_0"]
            or not names["step_1"] or names["step_2"]):
        fail(f"the trace of train.profile_steps=2: {out['trace']}, "
             f"{n_kernels} kernels, regions {names['step_0']} "
             f"{names['step_1']} {names['step_2']}")
    want_ckpts = [os.path.join(cfg.save_weight_dir, f"ckpt_{e}")
                  for e in (TRAIN_SAVE_FREQ - 1, TRAIN_EPOCHS - 1)]
    grid = os.path.join(cfg.sampled_dir, f"epoch_{TRAIN_EPOCHS - 1}"
                        "_sampled.png")
    metrics = os.path.join(cfg.metrics_save_dir, "train_metrics.jsonl")
    if (out["checkpoints"] != want_ckpts
            or not all(os.path.isfile(p) for p in want_ckpts + [grid,
                                                                metrics])):
        fail(f"missing outputs: checkpoints {out['checkpoints']}, grid "
             f"{os.path.isfile(grid)}, metrics {os.path.isfile(metrics)}")

    # restore the last checkpoint into a fresh state and take one more step
    model, _ = runner.build_model(cfg)
    model.to(dev)
    tx = make_optimizer(OptimizerConfig(
        lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
        grad_clip=cfg.train.grad_clip, multiplier=cfg.train.multiplier,
        epochs=cfg.train.epoch, steps_per_epoch=16), model.parameters())
    state = restore_checkpoint(want_ckpts[-1],
                               create_train_state(model, tx))
    for k, v in out["state"].model.state_dict().items():
        if not torch.equal(v, state.model.state_dict()[k]):
            fail(f"restored checkpoint differs from the trained state at {k}")
    step = make_train_step(runner.build_schedule(cfg, device=dev),
                           ema_decay=cfg.train.ema_decay)
    images, _ = shapes_dataset(n=TRAIN_BATCH, seed=11)
    batch = {"image": torch.from_numpy(images).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(12)
    m = step(state, batch, gen)
    resumed_loss = m["loss"].item()
    if state.step != steps + 1 or not np.isfinite(resumed_loss):
        fail(f"resumed step {state.step}, loss {resumed_loss}")
    log(f"restored {want_ckpts[-1]} (step {steps}) and took step "
        f"{state.step}: loss {resumed_loss:.5f}")
    ev_cfg = train_config(tmpdir, "bfloat16",
                          f"test_load_weight=ckpt_{TRAIN_EPOCHS - 1}",
                          "diffusion.inference_T=50",
                          f"sampled_dir={tmpdir}/eval")
    ev = runner.evaluate(ev_cfg, device=DEVICE)["images"]
    if not np.isfinite(ev).all():
        fail("eval from the checkpoint gave non-finite images")
    log(f"eval from ckpt_{TRAIN_EPOCHS - 1} (EMA weights, T=50): images "
        f"std {ev.std():.3f}")

    # steady-state step: wall time with a sync each (median), device busy
    # share and kernel breakdown from the profiler, peak memory
    walls = []
    for _ in range(12):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - s0) * 1e3)
    step_ms = float(np.median(walls[2:]))
    kernels, prof_ms = profile_steps(step, state, batch, gen)
    cats = collections.Counter()
    for k, v in kernels.items():
        cats[_category(k)] += v
    dev_ms = sum(kernels.values())
    busy = dev_ms / step_ms
    log(f"train step (batch {TRAIN_BATCH}, bf16) on {card_line}: median "
        f"{step_ms:.2f} ms wall (steps 3-12: "
        f"{[round(w, 1) for w in walls[2:]]}), {TRAIN_BATCH / step_ms * 1e3:.1f} "
        f"images/s; peak memory {peak_gb:.3f} GB "
        f"(torch.cuda.max_memory_allocated over runner.train)")
    log(f"profiler: {dev_ms:.2f} ms of kernels a step ({prof_ms:.2f} ms "
        f"wall a step under the profiler); against the median step's "
        f"{step_ms:.2f} ms wall the device is busy {100 * busy:.1f}%")
    log("  by category (ms a step): " + ", ".join(
        f"{c} {v:.2f}" for c, v in cats.most_common()))
    log("  top kernels (ms a step):")
    for k, v in kernels.most_common(12):
        log(f"    {v:8.3f}  {k[:110]}")
    phase_done(7, "train path (runner.train)", t0)
    return launches, per_step


# ---------------------------------------------------------------------------
# the data-parallel path (phase 21)

CLI_SEPARATOR = "::"


def cli_worker(argv) -> int:
    """``python chip_smoke.py --cli OUT.json ARGS [:: ARGS ...]`` under
    torchrun: starts the process group (the port's
    ``maybe_initialize_distributed``, timed), then runs each ARGS through
    the port's CLI entry point, ``itsd_tpu_torch.cli.main.main`` (what
    ``python -m itsd_tpu_torch.cli.main ARGS`` runs), one after the other
    in that group, with cuDNN's deterministic algorithms and this script's
    TF32 settings; rank 0 writes the group's world size, backend and
    start-up seconds and each command's exit code and kernel launches to
    OUT.json. (The CLI starts and ends a group of its own when it finds
    none; one process does not start a second group after the first.)"""
    import torch.distributed as dist
    from itsd_tpu_torch.cli import main as cli_main
    from itsd_tpu_torch.parallel import maybe_initialize_distributed

    out, commands = argv[0], [[]]
    for a in argv[1:]:
        if a == CLI_SEPARATOR:
            commands.append([])
        else:
            commands[-1].append(a)
    s0 = time.perf_counter()
    if not maybe_initialize_distributed(device=DEVICE):
        fail("the --cli mode runs under torchrun")
    group = {"world_size": dist.get_world_size(),
             "backend": dist.get_backend(),
             "start_s": time.perf_counter() - s0}
    torch.backends.cudnn.deterministic = True
    done = []
    try:
        for cmd in commands:
            reset_launches()
            rc = cli_main.main(cmd)
            torch.cuda.synchronize()
            done.append({"command": cmd[0], "rc": rc,
                         "launches": read_launches()})
            if rc:
                break
        if dist.get_rank() == 0:
            with open(out, "w") as f:
                json.dump({"group": group, "commands": done}, f)
    finally:
        dist.destroy_process_group()
    return max(d["rc"] for d in done)


def dp_commands(root: str, *extra):
    """The CLI arguments of phase 21's train and search, writing under
    ``root``; ``extra`` overrides of both."""
    train = ["train", "--device", DEVICE, *train_overrides(
        root, "bfloat16", f"train.epoch={DP_EPOCHS}",
        f"train.model_save_freq={DP_EPOCHS}",
        f"train.eval_freq={DP_EPOCHS}", f"diffusion.inference_T={DP_GRID_T}",
        "data.use_full_dataset=false",
        f"data.train_subset_ratio={DP_SUBSET}", *extra)]
    search = ["search", "--device", DEVICE, *train_overrides(
        root, "bfloat16", f"test_load_weight=ckpt_{DP_EPOCHS - 1}",
        f"sampled_dir={root}/search", "diffusion.sampler=ddim",
        f"diffusion.ddim_steps={FAST_STEPS}", "search.algorithm=random",
        f"search.n_candidates={DP_SEARCH_N}",
        f"search.candidate_chunk={DP_SEARCH_CHUNK}",
        "search.verifier=self_supervised", *extra)]
    return train, search


def same_tree(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit: tensors by ``torch.equal`` and
    dtype, containers item by item."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def read_train_run(root: str):
    """(per-step (step, loss, grad_norm) records, epoch records) of a run's
    ``train_metrics.jsonl``."""
    with open(os.path.join(root, "metrics", "train_metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [(r["step"], r["loss"], r["grad_norm"]) for r in records
             if "grad_norm" in r]
    return steps, [r for r in records if "epoch" in r and "elapsed_s" in r]


def dp_path(tmpdir, card_line):
    """Phase 21: the CLI's train and search in this process and under
    torchrun at world size 1 (NCCL), both with cuDNN's deterministic
    algorithms; the torchrun run must write what this process writes, bit
    for bit, with exact launches. Under torchrun the train runs again with
    attention_impl=ring and spatial_shard=1 (a seq axis of one: JAX's note,
    then the single-device call), which must write what the kernel path
    wrote, bit for bit. Returns the torchrun trains' launches (the kernel
    path's, the ring's)."""
    from itsd_tpu_torch.cli import main as cli_main

    t0 = time.perf_counter()
    one, dp = os.path.join(tmpdir, "dp_one"), os.path.join(tmpdir, "dp_run")
    steps = DP_EPOCHS * DP_STEPS
    want = {k: n * steps for k, n in step_counts(51, 6, 6).items()}
    grid = route_counts(gn=51 * DP_GRID_T, fwd=6 * DP_GRID_T,
                        fwd_mma=6 * DP_GRID_T)
    want = {k: n + grid[k] for k, n in want.items()}

    # one process: this one
    train_args, search_args = dp_commands(one)
    torch.backends.cudnn.deterministic = True
    try:
        reset_launches()
        s0 = time.perf_counter()
        rc = cli_main.main(train_args)
        torch.cuda.synchronize()
        one_launches = read_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = rc or cli_main.main(search_args)
        one_s = time.perf_counter() - s0
    finally:
        torch.backends.cudnn.deterministic = False
    one_best = [line for line in out.getvalue().splitlines()
                if line.startswith("best score:")]
    if rc or len(one_best) != 1:
        fail(f"the one-process CLI run: exit code {rc}, {one_best}")

    # torchrun: one process of an NCCL group, this script's --cli mode;
    # then the train again with attention_impl=ring (a seq axis of one)
    torch.cuda.empty_cache()
    counts = os.path.join(tmpdir, "dp_launches.json")
    train_args, search_args = dp_commands(dp)
    ring = os.path.join(tmpdir, "dp_ring")
    ring_args, _ = dp_commands(ring, "model.attention_impl=ring")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--cli", counts,
           *train_args, CLI_SEPARATOR, *search_args, CLI_SEPARATOR,
           *ring_args]
    s0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=DP_TIMEOUT, cwd=ROOT)
    dp_s = time.perf_counter() - s0
    if run.returncode:
        log(run.stdout[-4000:])
        log(run.stderr[-4000:])
        fail(f"torchrun exited {run.returncode}")
    dp_best = [line for line in run.stdout.splitlines()
               if line.startswith("best score:")]
    with open(counts) as f:
        ran = json.load(f)
    group = ran["group"]
    log(f"torchrun --nproc_per_node=1 (train, then search): {dp_s:.2f} s "
        f"wall; one process (this one): {one_s:.2f} s")
    log(f"world_size {group['world_size']}")
    log(f"backend {group['backend']}")
    log(f"process group start-up {group['start_s']:.3f} s "
        f"(maybe_initialize_distributed, {group['backend']})")
    if (group["world_size"], group["backend"]) != (1, "nccl") or [
            c["rc"] for c in ran["commands"]] != [0, 0, 0]:
        fail(f"the torchrun run: {ran}")
    dp_launches = ran["commands"][0]["launches"]
    ring_noted = ("[runner] attention_impl=ring with spatial_shard=1"
                  in run.stdout)

    # what rank 0 wrote against what this process wrote
    (one_steps, one_epochs), (dp_steps, dp_epochs) = (
        read_train_run(one), read_train_run(dp))
    ckpt = f"ckpt_{DP_EPOCHS - 1}"
    a, b = (torch.load(os.path.join(root, "ckpt", ckpt), map_location="cpu",
                       weights_only=True) for root in (one, dp))
    n_tensors = sum(1 for part in ("params", "ema_params")
                    for _ in a[part])

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    files = {name: [read(os.path.join(root, *name.split("/")))
                    for root in (one, dp)]
             for name in (f"sampled/epoch_{DP_EPOCHS - 1}_sampled.png",
                          "search/search_random_best.png")}
    # the ring's train (attention_impl=ring, a seq axis of one: the
    # single-device call) against the kernel path's under torchrun
    ring_steps, _ = read_train_run(ring)
    ring_ckpt = torch.load(os.path.join(ring, "ckpt", ckpt),
                           map_location="cpu", weights_only=True)
    grid = f"sampled/epoch_{DP_EPOCHS - 1}_sampled.png"
    vs = "torchrun vs one process"
    checks = {
        f"{vs}, per-step losses and gradient norms": (
            len(one_steps) == steps and one_steps == dp_steps),
        f"{vs}, checkpoint {ckpt} ({n_tensors} tensors, optimizer, "
        "schedule)": same_tree(a, b),
        **{f"{vs}, {name}": x == y for name, (x, y) in files.items()},
        f"{vs}, best score": one_best == dp_best,
        f"{vs}, launches": one_launches == dp_launches == want,
        "ring (a seq axis of one) vs kernel path, JAX's note printed":
            ring_noted,
        "ring vs kernel path, per-step losses and gradient norms":
            ring_steps == dp_steps,
        f"ring vs kernel path, checkpoint {ckpt}": same_tree(ring_ckpt, b),
        f"ring vs kernel path, {grid}": read(os.path.join(
            ring, *grid.split("/"))) == files[grid][1],
        "ring vs kernel path, launches":
            ran["commands"][2]["launches"] == dp_launches,
    }
    step_ms = [(e[1]["elapsed_s"] - e[0]["elapsed_s"]) / DP_STEPS * 1e3
               for e in (one_epochs, dp_epochs)]
    log(f"data-parallel train, {steps} steps of batch {TRAIN_BATCH} (bf16): "
        f"losses {[round(x[1], 6) for x in dp_steps]}; launches "
        f"{dp_launches} (want {want}); {dp_best[0] if dp_best else ''}")
    log(f"epoch {DP_EPOCHS - 1}'s step on {card_line}: "
        f"{step_ms[1]:.2f} ms under torchrun (world size 1), "
        f"{step_ms[0]:.2f} ms in one process (wall, host clock, "
        f"train_metrics.jsonl's epoch records)")
    for what, ok in checks.items():
        log(f"  (bit for bit) {what}: {'equal' if ok else 'DIFFERENT'}")
    if not all(checks.values()):
        fail("the torchrun run differs from the one-process run: "
             + ", ".join(k for k, ok in checks.items() if not ok))
    phase_done(21, "data-parallel path (torchrun, world size 1, NCCL)", t0)
    return dp_launches, ran["commands"][2]["launches"]


# ---------------------------------------------------------------------------
# phase 22: train.spatial_shard=2 at two ranks on one card


def sp_flagship_config(root: str, *extra):
    """configs/imagenet256_uncond.yaml (the 256x256 flagship: ch 128,
    ch_mult 1,2,3,4, attention at 64x64 and in the middle, bf16, dropout
    0.15) on the shapes dataset at 256x256: SP_FLAG_STEPS batches of
    SP_FLAG_BATCH, one epoch, no grid; DDIM SP_FLAG_DDIM at the same
    batch."""
    from itsd_tpu_torch.utils import load_config

    n_images = SP_FLAG_STEPS * SP_FLAG_BATCH
    return load_config(IMAGENET_YAML, [
        "data.use_full_dataset=false",
        f"data.train_subset_ratio={n_images / 2048}",
        f"batch_size={SP_FLAG_BATCH}", "train.epoch=1",
        "train.track_metrics=false", "train.eval_freq=1000000", "seed=0",
        f"train.eval_batch_size={SP_FLAG_BATCH}", "diffusion.sampler=ddim",
        f"diffusion.ddim_steps={SP_FLAG_DDIM}",
        f"save_weight_dir={root}/flag_ckpt",
        f"sampled_dir={root}/flag_sampled",
        f"metrics_save_dir={root}/flag_metrics", *extra])


def sp_vit_config(root: str, *extra):
    """Phase 20's ViT-B/16 (configs/imagenet256_uncond.yaml with
    model.backbone=vit: 256x256, bf16, dropout 0.15) at the flagship's
    phase 22 settings: SP_VIT_STEPS batches of SP_FLAG_BATCH, one epoch,
    no grid; DDIM SP_FLAG_DDIM at the same batch."""
    from itsd_tpu_torch.utils import load_config

    n_images = SP_VIT_STEPS * SP_FLAG_BATCH
    return load_config(IMAGENET_YAML, [
        "model.backbone=vit", "data.use_full_dataset=false",
        f"data.train_subset_ratio={n_images / 2048}",
        f"batch_size={SP_FLAG_BATCH}", "train.epoch=1",
        "train.track_metrics=false", "train.eval_freq=1000000", "seed=0",
        f"train.eval_batch_size={SP_FLAG_BATCH}", "diffusion.sampler=ddim",
        f"diffusion.ddim_steps={SP_FLAG_DDIM}",
        f"save_weight_dir={root}/vit_ckpt",
        f"sampled_dir={root}/vit_sampled",
        f"metrics_save_dir={root}/vit_metrics", *extra])


def sp_cifar_config(root: str, *extra):
    """Phase 7's configuration (configs/cifar10_uncond.yaml on shapes) at
    batch SP_CIFAR_BATCH for SP_CIFAR_STEPS steps, one epoch, no grid."""
    n_images = SP_CIFAR_STEPS * SP_CIFAR_BATCH
    return train_config(
        f"{root}/cifar", "bfloat16", f"batch_size={SP_CIFAR_BATCH}",
        "train.epoch=1", "data.use_full_dataset=false",
        f"data.train_subset_ratio={n_images / 2048}",
        "train.eval_freq=1000000", *extra)


def sp_run(root: str, spatial: bool, control=None) -> dict:
    """Phase 22's runs in this process: ``runner.train`` of the flagship,
    of the CIFAR-10 UNet and of the ViT, and ``runner.evaluate`` of the
    flagship and of the ViT (DDIM, their seeded weights, in bf16 and in
    f32), with train.spatial_shard=2 when ``spatial`` (each rank of the
    group on its image rows), else whole. Per run: the losses (or images),
    the launches, each step's wall ms, the ms of the steps spent in the
    halo, GroupNorm and ring exchanges and in the gradients' all-reduce
    (each synchronized, host clock), the peak memory, and the first step's
    gradient (flat f32 on the host: all-reduced and weighted to the global
    batch's, before the clip; for the ViT also its position embedding's
    share, ``grad_pos``). With ``control`` (train run names) those train
    runs take one step and nothing else runs."""
    from itsd_tpu_torch import parallel
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.kernels import ring_attention
    from itsd_tpu_torch.parallel import spatial as sp_mod
    from itsd_tpu_torch.train import loop

    extra = ["train.spatial_shard=2"] if spatial else []
    clock = {"exchange": 0.0, "reduce": 0.0}
    steps = []

    def timed(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                clock[key] += time.perf_counter() - c0
        return run

    make_step = runner.make_train_step
    clip = loop.clip_by_global_norm_
    first_grads, current, names = {}, [None], {}

    def clip_after_keeping_the_first(grads, max_norm):
        if current[0] not in first_grads:
            first_grads[current[0]] = torch.cat(
                [g.detach().float().reshape(-1) for g in grads]).cpu()
        return clip(grads, max_norm)

    def make_timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args, **kwargs):
            # the optimizer holds every parameter, in the model's order
            names.setdefault(current[0], [
                (n, p.numel()) for n, p in args[0].model.named_parameters()])
            torch.cuda.synchronize()
            before, s0 = dict(clock), time.perf_counter()
            out = step(*args, **kwargs)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - s0) * 1e3,
                          *((clock[k] - before[k]) * 1e3
                            for k in ("exchange", "reduce"))))
            return out
        return run

    # every run starts from the seeded weights, whose output layers are
    # not near zero, so that every branch's backward moves the gradient
    # (at the init the attention and the residual convolutions pass back
    # ~1e-10 of it)
    configs = {"flagship_train": (sp_flagship_config(root, *extra),
                                  SP_FLAG_STEPS),
               "cifar_train": (sp_cifar_config(root, *extra),
                               SP_CIFAR_STEPS),
               "vit_train": (sp_vit_config(root, *extra), SP_VIT_STEPS)}
    if control is not None:
        configs = {k: v for k, v in configs.items() if k in control}
    seeded = {}
    os.makedirs(root, exist_ok=True)
    for name, (cfg, _) in configs.items():
        seeded[name] = seeded_params(cfg)
        path = os.path.join(root, f"{name}_seeded_rank{parallel.rank()}.pt")
        torch.save(seeded[name], path)
        cfg.train.training_load_weight = path
    out = {}
    with contextlib.ExitStack() as stack:
        for mod, name, fn in (
                (runner, "make_train_step", make_timed_step),
                (sp_mod, "p2p", timed(sp_mod.p2p, "exchange")),
                (ring_attention, "p2p", timed(ring_attention.p2p,
                                              "exchange")),
                (sp_mod, "_all_reduce", timed(sp_mod._all_reduce,
                                              "exchange")),
                (sp_mod, "gather_rows", timed(sp_mod.gather_rows,
                                              "exchange")),
                (loop, "all_reduce_sum_", timed(loop.all_reduce_sum_,
                                                "reduce")),
                (loop, "clip_by_global_norm_",
                 clip_after_keeping_the_first)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        for name, (cfg, n) in configs.items():
            current[0] = name
            steps.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            s0 = time.perf_counter()
            res = runner.train(
                cfg, max_steps=n if control is None else 1, device=DEVICE)
            torch.cuda.synchronize()
            out[name] = dict(
                losses=res["losses"], launches=read_launches(),
                steps=steps[:], wall_s=time.perf_counter() - s0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                grad=first_grads[name], grad_pos=None)
            sizes = names[name]
            if sum(size for _, size in sizes) != first_grads[name].numel():
                fail(f"phase 22 {name}: the optimizer's gradients are not "
                     "the model's parameters")
            at = 0
            for key, size in sizes:
                if key == "pos_embed":
                    out[name]["grad_pos"] = first_grads[name][at:at + size]
                at += size
            del res
        if control is not None:
            return out
        for name, dtype, make, weights in (
                ("flagship_ddim", "bfloat16", sp_flagship_config,
                 "flagship_train"),
                ("flagship_ddim_f32", "float32", sp_flagship_config,
                 "flagship_train"),
                ("vit_ddim", "bfloat16", sp_vit_config, "vit_train"),
                ("vit_ddim_f32", "float32", sp_vit_config, "vit_train")):
            cfg = make(root, f"model.dtype={dtype}", *extra)
            torch.cuda.empty_cache()
            reset_launches()
            s0 = time.perf_counter()
            ev = runner.evaluate(cfg, params=seeded[weights], device=DEVICE)
            torch.cuda.synchronize()
            out[name] = dict(images=ev["images"], launches=read_launches(),
                             wall_s=time.perf_counter() - s0)
    return out


def _halo_backward_dropping_the_halo(ctx, g):
    """A planted fault: the halo's backward keeps the gradient of the
    rank's own rows and drops the halo rows' (nothing goes back to their
    owners)."""
    h = g.shape[2] - ctx.top - ctx.bottom
    return g.narrow(2, ctx.top, h).clone(), None, None, None


def _ring_backward_without_the_hop_home(ctx, do):
    """A planted fault: the ring's backward (``kernels.ring_attention.
    _Ring.backward``) without its last hop, so that each rank keeps the dk
    and dv shares of its neighbour's keys and values."""
    from itsd_tpu_torch.kernels import attention as A
    from itsd_tpu_torch.kernels import ring_attention as R

    q, k, v, o, lse = ctx.saved_tensors
    mesh, plain = ctx.mesh, ctx.plain
    scale = float(q.shape[-1]) ** -0.5
    do = do.contiguous()
    dd = A.row_dd(o, do).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kc, vc, dk, dv = k, v, None, None
    for hop in range(mesh.seq):
        if hop:
            kc, vc, dk, dv = R._pass_on((kc, vc, dk, dv), mesh)
        dq_h, dk_h, dv_h = R._hop_grads(q, kc, vc, do, lse, dd, scale,
                                        plain)
        dq += dq_h.float()
        dk = dk_h.float() if dk is None else dk + dk_h.float()
        dv = dv_h.float() if dv is None else dv + dv_h.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def _positions_of_rank0(pos_embed, n, mesh):
    """A planted fault: every seq rank adds rank 0's share of the ViT's
    position embedding (``models.vit.rank_positions``)."""
    return pos_embed.narrow(1, 0, n)


def _dropout_drawn_per_rank(h, rate, generator, h_axis=2):
    """A planted fault: the ViT's dropout masks drawn for the rank's own
    block from the generator (``models.unet.dropout`` without
    ``RowDraws``), not cut from the global draw."""
    from itsd_tpu_torch.models import unet
    from itsd_tpu_torch.parallel import RowDraws

    if isinstance(generator, RowDraws):
        generator = generator.generator
    return unet.dropout(h, rate, generator, h_axis)


# ``--sp-control``'s planted faults: (module, class or None, attribute,
# replacement, the train runs whose first gradient must show it)
SP_FAULTS = {
    "halo_gradient_dropped": (
        "itsd_tpu_torch.parallel.spatial", "_Halo", "backward",
        staticmethod(_halo_backward_dropping_the_halo),
        ("flagship_train", "cifar_train")),
    "ring_without_hop_home": (
        "itsd_tpu_torch.kernels.ring_attention", "_Ring", "backward",
        staticmethod(_ring_backward_without_the_hop_home),
        ("flagship_train", "cifar_train", "vit_train")),
    "vit_positions_of_rank0": (
        "itsd_tpu_torch.models.vit", None, "rank_positions",
        _positions_of_rank0, ("vit_train",)),
    "vit_dropout_per_rank": (
        "itsd_tpu_torch.models.vit", None, "dropout",
        _dropout_drawn_per_rank, ("vit_train",))}


def spatial_worker(argv) -> int:
    """``python chip_smoke.py --spatial ROOT RANK PORT [FAULT]``: one of
    phase 22's ranks. Starts its gloo group on ``tcp://localhost:PORT``
    (the port's ``maybe_initialize_distributed``, so that the runner finds
    it up), runs ``sp_run`` on ``cuda:0`` and writes its results to
    ``ROOT/rank{RANK}.pt``. With FAULT (a key of ``SP_FAULTS``) it runs
    ``sp_run``'s control, one step of each train run the fault concerns,
    with that fault planted ("none": every train run, no fault)."""
    import importlib

    import torch.distributed as dist
    from itsd_tpu_torch.parallel import maybe_initialize_distributed

    root, rank, port = argv[0], int(argv[1]), argv[2]
    fault = argv[3] if len(argv) > 3 else None
    torch.cuda.set_device(0)
    s0 = time.perf_counter()
    maybe_initialize_distributed(
        device="cpu", init_method=f"tcp://localhost:{port}",
        world_size=SP_RANKS, rank=rank, timeout=SP_TIMEOUT)
    group = {"backend": dist.get_backend(),
             "world_size": dist.get_world_size(),
             "start_s": time.perf_counter() - s0}
    try:
        control = None
        with contextlib.ExitStack() as stack:
            if fault == "none":
                control = tuple(SP_GRAD_RTOL)
            elif fault is not None:
                module, cls, attr, value, control = SP_FAULTS[fault]
                target = importlib.import_module(module)
                if cls is not None:
                    target = getattr(target, cls)
                stack.enter_context(mock.patch.object(target, attr, value))
            res = sp_run(root, spatial=True, control=control)
        res["group"] = group
        torch.save(res, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def sp_ranks(root: str, fault: str | None = None) -> list:
    """``spatial_worker`` at SP_RANKS ranks of one gloo group on cuda:0,
    started together (the kernels are built); their results, in rank
    order. ``fault``: see ``spatial_worker`` ("none": the control without
    a fault)."""
    import socket

    os.makedirs(root, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--spatial", root,
         str(r), str(port)] + ([fault] if fault else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(SP_RANKS)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=SP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed: time limit]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            log(text[-6000:])
            fail(f"phase 22 rank {r} exited {p.returncode}")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(SP_RANKS)]


def grad_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return ((got.double() - want).norm() / want.norm()).item()


def sp_control(card_line: str) -> int:
    """``python3 chip_smoke.py --sp-control``: phase 22's runs at two ranks
    and in one process, compared as phase 22 compares them (``sp_compare``),
    then one step of the train runs each of ``SP_FAULTS`` concerns at two
    ranks with that fault planted, their first gradients against one
    process's. Exits 0 when phase 22's checks pass and each fault goes
    beyond a gradient limit (``sp_grad_readings``) in every run it
    concerns."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="itsd_sp_control_") as tmpdir:
        got = sp_ranks(os.path.join(tmpdir, "two"))
        want = sp_run(os.path.join(tmpdir, "one"), spatial=False)
        verdict = all(sp_compare(got, want).values())
        for fault, (*_, runs) in SP_FAULTS.items():
            res = sp_ranks(os.path.join(tmpdir, fault), fault)[0]
            for name in runs:
                readings = sp_grad_readings(name, res[name], want[name])
                beyond = any(limit is not None and value > limit
                             for value, limit in readings.values())
                verdict = verdict and beyond
                log(f"sp-control, {fault}: {name} "
                    + "; ".join(f"{what} {value:.4g} (limit {limit})"
                                for what, (value, limit) in readings.items())
                    + f" -> {'caught' if beyond else 'NOT CAUGHT'}; loss "
                    f"{res[name]['losses'][0]:.6f} at 2 ranks, "
                    f"{want[name]['losses'][0]:.6f} in one process, on "
                    f"{card_line}")
    log(f"sp-control: {'passed' if verdict else 'FAILED'} in "
        f"{time.perf_counter() - t0:.2f} s")
    return 0 if verdict else 1


def _sp_step_line(run: dict) -> str:
    steps = run["steps"][1:]  # the first step warms up
    ms = [s[0] for s in steps]
    exch = sum(s[1] for s in steps) / max(1e-9, sum(ms))
    red = sum(s[2] for s in steps) / max(1e-9, sum(ms))
    return (f"step {float(np.median(ms)):.2f} ms (steps 2-{len(ms) + 1}: "
            f"{[round(m, 2) for m in ms]}), exchanges {100 * exch:.1f}% "
            f"and gradient all-reduce {100 * red:.1f}% of it, peak "
            f"{run['peak_gb']:.3f} GB")


def sp_grad_readings(name, got, want) -> dict:
    """The first step's gradient of train run ``name`` at a rank (``got``)
    against one process (``want``), as {reading: (value, limit)}: the
    whole gradient's relative L2 (SP_GRAD_RTOL), and for the ViT its
    position embedding's (SP_POS_GRAD_RTOL), a share of the whole too
    small to move it."""
    out = {"first step's gradient rel L2": (
        grad_rel(got["grad"], want["grad"]), SP_GRAD_RTOL[name])}
    if want["grad_pos"] is not None:
        out["position embedding's gradient rel L2"] = (
            grad_rel(got["grad_pos"], want["grad_pos"]), SP_POS_GRAD_RTOL)
    return out


def sp_compare(got, want) -> dict:
    """Phase 22's two ranks (``got``) against each other and against one
    process (``want``), each reading printed beside its limit: the losses
    (SP_LOSS_RTOL), the first step's gradient (``sp_grad_readings``), the
    bf16 images' mean error (SP_IMAGE_MEAN_TOL) and the f32 images'
    largest (SP_IMAGE_TOL). Returns {check: passed}."""
    checks, readings = {}, {}
    for name, steps_n in (("flagship_train", SP_FLAG_STEPS),
                          ("cifar_train", SP_CIFAR_STEPS),
                          ("vit_train", SP_VIT_STEPS)):
        losses = [r[name]["losses"] for r in got]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(losses[0], want[name]["losses"]))
        readings[f"{name} loss rel err"] = (rel, SP_LOSS_RTOL[name])
        checks[f"{name}: both ranks' losses equal"] = (
            losses[0] == losses[1] and len(losses[0]) == steps_n)
        grads = [r[name]["grad"] for r in got]
        checks[f"{name}: both ranks' first gradients equal"] = (
            torch.equal(*grads))
        for what, reading in sp_grad_readings(name, got[0][name],
                                              want[name]).items():
            readings[f"{name} {what}"] = reading
        log(f"{name}: losses {[round(x, 6) for x in losses[0]]} at 2 ranks, "
            f"{[round(x, 6) for x in want[name]['losses']]} in one process")
    for name in ("flagship_ddim", "flagship_ddim_f32", "vit_ddim",
                 "vit_ddim_f32"):
        images = [r[name]["images"] for r in got]
        checks[f"{name}: both ranks' images equal"] = bool(
            np.array_equal(images[0], images[1]))
        checks[f"{name}: finite images"] = bool(np.isfinite(images[0]).all())
        diff = np.abs(images[0] - want[name]["images"])
        log(f"{name}: DDIM {SP_FLAG_DDIM} at batch {SP_FLAG_BATCH}, "
            f"{got[0][name]['wall_s']:.2f} s at 2 ranks, "
            f"{want[name]['wall_s']:.2f} s in one process (runner.evaluate, "
            f"the model's set-up included); images against one process: "
            f"max |err| {diff.max():.4g}, mean {diff.mean():.4g}, share "
            f"beyond 0.1 {(diff > 0.1).mean():.4g}")
        if name in SP_IMAGE_MEAN_TOL:
            readings[f"{name} images mean abs err"] = (
                float(diff.mean()), SP_IMAGE_MEAN_TOL[name])
        else:
            readings[f"{name} images max abs err"] = (float(diff.max()),
                                                      SP_IMAGE_TOL[name])
    for what, (value, limit) in readings.items():
        ok = limit is not None and np.isfinite(value) and value <= limit
        checks[what] = ok
        log(f"  2 ranks vs one process, {what}: {value:.4g} (limit "
            f"{limit}) -> {'ok' if ok else 'BEYOND'}")
    for what, ok in checks.items():
        if what not in readings:
            log(f"  {what}: {'ok' if ok else 'FAILED'}")
    return checks


def spatial_path(tmpdir, counts, card_line):
    """Phase 22: ``sp_run`` at two ranks of one gloo group on cuda:0
    (``sp_ranks``), then in this process; the ranks must agree with each
    other exactly and with the one-process run to SP_LOSS_RTOL (losses),
    SP_GRAD_RTOL and SP_POS_GRAD_RTOL (the first step's gradient),
    SP_IMAGE_MEAN_TOL (bf16 images) and SP_IMAGE_TOL (f32 images), with
    exact launches: on row shards each GroupNorm is two stats launches and
    one apply, each attention call two hops of the flash forward, dq and
    dk/dv. ``counts``:
    (GroupNorm calls, attention calls) of one forward of the flagship, of
    the CIFAR UNet and of the ViT. Returns the two ranks' launches summed,
    per run."""
    t0 = time.perf_counter()
    got = sp_ranks(os.path.join(tmpdir, "sp_two"))
    two_s = time.perf_counter() - t0
    want = sp_run(os.path.join(tmpdir, "sp_one"), spatial=False)

    (flag_gn, flag_attn), (cifar_gn, cifar_attn), (vit_gn, vit_attn) = \
        counts

    def expect(gn, attn, steps, train, route, rows):
        k = 2 if rows else 1
        per = dict(gn=0 if rows else gn, gn_stats=2 * gn if rows else 0,
                   gn_apply=gn if rows else 0, fwd=k * attn)
        if train:
            per.update(dq=k * attn, dkv=k * attn)
        if route != "simt":  # route_counts gives simt what is left
            for fn in ("fwd", "dq", "dkv") if train else ("fwd",):
                per[f"{fn}_{route}"] = k * attn
        return scaled(route_counts(**per), steps)

    runs = {"flagship_train": (flag_gn, flag_attn, SP_FLAG_STEPS, True,
                               "wide"),
            "cifar_train": (cifar_gn, cifar_attn, SP_CIFAR_STEPS, True,
                            "mma"),
            "flagship_ddim": (flag_gn, flag_attn, SP_FLAG_DDIM, False,
                              "wide"),
            "flagship_ddim_f32": (flag_gn, flag_attn, SP_FLAG_DDIM, False,
                                  "simt"),
            "vit_train": (vit_gn, vit_attn, SP_VIT_STEPS, True, "mma"),
            "vit_ddim": (vit_gn, vit_attn, SP_FLAG_DDIM, False, "mma"),
            "vit_ddim_f32": (vit_gn, vit_attn, SP_FLAG_DDIM, False, "simt")}
    g = got[0]
    log(f"phase 22: {SP_RANKS} ranks of a {g['group']['backend']} group "
        f"(world size {g['group']['world_size']}) on cuda:0, started in "
        f"{g['group']['start_s']:.2f} s; both ranks {two_s:.2f} s wall, "
        f"then one process")
    checks = {}
    for name, spec in runs.items():
        checks[f"{name}: launches, each rank"] = all(
            r[name]["launches"] == expect(*spec, True) for r in got)
        checks[f"{name}: launches, one process"] = (
            want[name]["launches"] == expect(*spec, False))
    for name in ("flagship_train", "cifar_train", "vit_train"):
        for who, run in (("rank 0", got[0][name]), ("rank 1", got[1][name]),
                         ("one process", want[name])):
            log(f"  {name}, {who} on {card_line}: {_sp_step_line(run)}")
    for what, ok in checks.items():
        log(f"  {what}: {'ok' if ok else 'FAILED'}")
    checks.update(sp_compare(got, want))
    if not all(checks.values()):
        for name, spec in runs.items():
            log(f"{name} launches: ranks {[r[name]['launches'] for r in got]}"
                f", one process {want[name]['launches']}, want "
                f"{expect(*spec, True)} and {expect(*spec, False)}")
        fail("phase 22: " + ", ".join(k for k, ok in checks.items()
                                      if not ok))
    phase_done(22, "spatial sharding (train.spatial_shard=2, two gloo "
               "ranks on one card)", t0)
    return {f"sp_{name}": {k: sum(r[name]["launches"][k] for r in got)
                           for k in got[0][name]["launches"]}
            for name in runs}


# ---------------------------------------------------------------------------
# the guided path: configs/cifar10_cfg.yaml


def cfg_config(tmpdir: str, dtype: str = "bfloat16", *extra):
    """configs/cifar10_cfg.yaml (ch 128, ch_mult 1,4,8,8,4,2, 10 labels,
    table time embedding, T=3000, w=1.8, batch 256, lr 5e-5, sum/B^2 loss)
    in ``dtype``, on the shapes dataset (the repository's stand-in for
    CIFAR-10) with its 10 labels, the config's representation extraction
    (every 50 batches), no tracked metrics (phase 17 tracks the guided
    path), guided evals at batch 8."""
    from itsd_tpu_torch.utils import load_config

    return load_config(CFG_YAML, [
        f"model.dtype={dtype}", "seed=0", "data.dataset=shapes",
        "train.track_metrics=false",
        f"train.eval_batch_size={CFG_BATCH}",
        f"save_weight_dir={tmpdir}/cfg_ckpt",
        f"sampled_dir={tmpdir}/cfg_sampled",
        f"metrics_save_dir={tmpdir}/cfg_metrics", *extra])


@contextlib.contextmanager
def watch_sampling():
    """Inside ``runner.evaluate``: the batch of every attention call of the
    UNet (a wrapper around its ``spatial_attention`` that launches nothing
    itself); the wall seconds of ``run_sampler``, synchronized before and
    after, so that a step's time leaves out the model's set-up; and every
    synchronizing CUDA operation the sampler makes, which PyTorch's sync
    debug mode reports (the samplers promise none, but for Picard's one
    read a sweep: the host never waits on the device within a step)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models import unet

    batches, seconds, syncs = [], [], []
    attention_fn, sampler_fn = unet.spatial_attention, runner.run_sampler

    def attention(q, k, v, impl="auto"):
        batches.append(q.shape[0])
        return attention_fn(q, k, v, impl)

    def reported_syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]

    def sampler(*a, **kw):
        # the detector reports a known sync, so that no report means none
        if not reported_syncs(
                lambda: torch.ones(1, device=DEVICE).item())[1]:
            fail("sync debug mode reported no sync for .item()")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, found = reported_syncs(lambda: sampler_fn(*a, **kw))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        syncs.extend(found)
        return out

    with mock.patch.object(unet, "spatial_attention", attention), \
            mock.patch.object(runner, "run_sampler", sampler):
        yield batches, seconds, syncs


def guided_eval(what, cfg, params, want_steps, want_batches, card_line):
    """One ``runner.evaluate`` of the conditional model; checks its launch
    counts (``want_steps``: step count -> launches a step), the batch of
    every attention call and the images. Returns (launches, result)."""
    from itsd_tpu_torch.cli import runner

    reset_launches()
    t0 = time.perf_counter()
    with watch_sampling() as (batches, sampler_s, syncs):
        out = runner.evaluate(cfg, params, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if syncs:
        fail(f"{what}: the sampler made {len(syncs)} synchronizing CUDA "
             f"operations, the first: {syncs[0]}")
    want = collections.Counter()
    for steps, per in want_steps:
        want.update(scaled(per, steps))
    T = cfg.diffusion.T
    if launches != {k: want[k] for k in launches}:
        fail(f"{what}: launches {launches}, want {dict(want)}")
    if collections.Counter(batches) != want_batches:
        fail(f"{what}: attention batches {collections.Counter(batches)}, "
             f"want {want_batches}")
    imgs = out["images"]
    if imgs.shape != (CFG_BATCH, 32, 32, 3) or not np.isfinite(imgs).all():
        fail(f"{what}: images of shape {imgs.shape}, finite: "
             f"{bool(np.isfinite(imgs).all())}")
    step_ms = sampler_s[0] / T * 1e3
    res = dict(T=T, sampler_s=sampler_s[0], evaluate_s=seconds,
               ms_per_step=step_ms, images_per_s=CFG_BATCH / sampler_s[0])
    log(f"{what}: T={T}, batch {CFG_BATCH}, bf16: sampler {sampler_s[0]:.3f} "
        f"s = {step_ms:.3f} ms/step, {res['images_per_s']:.4f} images/s "
        f"(runner.evaluate {seconds:.3f} s with the model's set-up) on "
        f"{card_line}; launches {launches}; attention batches "
        f"{dict(collections.Counter(batches))}; images min {imgs.min():.3f} "
        f"max {imgs.max():.3f} std {imgs.std():.3f}")
    return launches, res


def guided_eval_path(cparams, tmpdir, card_line):
    """Phase 9: runner.evaluate of the conditional model at the full width
    of configs/cifar10_cfg.yaml on seeded weights, bf16, batch 8, guided
    by w=1.8: CFG over a chain of CFG_LONG_T steps; CFG restricted to the
    interval CFG_INTERVAL; autoguidance against a second seeded weight
    file. The last two run a chain of CFG_SHORT_T steps. Each cuts the
    config's T=3000 (diffusion.T overridden, the time table cut to its
    first rows), to stay inside the script's time limit. Every guided eval clips the implied x_0 at each
    step (diffusion.clip_denoised), as long extrapolative-CFG chains need:
    on random weights the unclipped chain grows by ~1/sqrt(alpha_bar_T),
    ~1e9 at T=3000. Returns {run: launches}, {run: result}."""
    from itsd_tpu_torch.cli import runner

    t0 = time.perf_counter()
    gn, fwd, mma, wide = CFG_PER_FORWARD
    one = route_counts(gn=gn, fwd=fwd, fwd_mma=mma, fwd_wide=wide)
    launches, results = {}, {}
    B = CFG_BATCH

    T = CFG_LONG_T
    cfg = cfg_config(tmpdir, "bfloat16", f"diffusion.T={T}",
                     "diffusion.clip_denoised=true")
    p_long = dict(cparams)
    p_long["time_embedding.table"] = cparams["time_embedding.table"][:T]
    launches["cfg_eval"], results["cfg_eval"] = guided_eval(
        f"CFG w={cfg.diffusion.w}", cfg, p_long, [(T, one)],
        {2 * B: fwd * T}, card_line)
    del p_long

    short = [f"diffusion.T={CFG_SHORT_T}", "diffusion.clip_denoised=true"]
    lo, hi = CFG_INTERVAL
    cfg = cfg_config(tmpdir, "bfloat16", *short,
                     f"diffusion.cfg_interval=[{lo},{hi}]")
    p_short = dict(cparams)
    p_short["time_embedding.table"] = cparams[
        "time_embedding.table"][:CFG_SHORT_T].clone()
    inside = hi - lo
    launches["cfg_interval_eval"], results["cfg_interval_eval"] = \
        guided_eval(f"CFG w={cfg.diffusion.w} on {lo} <= t < {hi}", cfg,
                    p_short, [(CFG_SHORT_T, one)],
                    {2 * B: fwd * inside, B: fwd * (CFG_SHORT_T - inside)},
                    card_line)

    wdir = os.path.join(tmpdir, "cfg_weights")
    os.makedirs(wdir, exist_ok=True)
    weak_cfg = cfg_config(tmpdir, "float32", *short, "seed=1")
    torch.save(p_short, os.path.join(wdir, "strong.pt"))
    torch.save(seeded_params(weak_cfg), os.path.join(wdir, "weak.pt"))
    cfg = cfg_config(tmpdir, "bfloat16", *short, f"save_weight_dir={wdir}",
                     "test_load_weight=strong.pt", "diffusion.guidance=auto",
                     "diffusion.weak_load_weight=weak.pt")
    launches["auto_eval"], results["auto_eval"] = guided_eval(
        f"autoguidance w={cfg.diffusion.w}", cfg, None,
        [(CFG_SHORT_T, scaled(one, 2))], {B: 2 * fwd * CFG_SHORT_T},
        card_line)
    phase_done(9, "guided eval path (runner.evaluate)", t0)
    return launches, results


def guided_parity(cparams, tmpdir):
    """Phase 10: the guided path through the kernels against the plain
    path, in f32 and bf16, at full width on the seeded weights: one
    conditional forward and one guided (dual-batched CFG) eps at timesteps
    spread over the T=3000 chain, then 20 guided steps from one x_T with
    one fed noise sequence, guided on 5 <= t < 15 (so that both branches
    of the interval run)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import denoise_segment

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    B = CFG_BATCH
    gen = torch.Generator(device=dev).manual_seed(21)
    x_T = torch.randn((B, 32, 32, 3), generator=gen, device=dev)
    noise = [torch.randn((B, 32, 32, 3), generator=gen, device=dev)
             for _ in range(PARITY_STEPS)]
    labels = torch.arange(B, device=dev) % 10 + 1
    f32_launches, errs = {}, {}
    gn, fwd, mma, wide = CFG_PER_FORWARD

    def check(what, name, got, want, tol):
        err = (got - want).abs().max().item()
        ok = np.isfinite(err) and err <= tol
        log(f"guided parity {name} {what}: max_abs_err {err:.3g} (tol "
            f"{tol:.3g}), max |plain| {want.abs().max().item():.3f} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"guided parity {name} {what}: {err:.3g} > {tol:.3g}")
        return err

    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = cfg_config(tmpdir, name)
        T, w = cfg.diffusion.T, cfg.diffusion.w
        t_eps = torch.linspace(0, T - 1, B, device=dev).round().long()
        model, _ = runner.build_model(cfg)
        model.load_state_dict(cparams)
        model.to(dev).eval()
        sched = runner.build_schedule(cfg, inference=True, device=dev)
        guided = runner.make_eps_fn(model, True, labels, w)
        guided_iv = runner.make_eps_fn(model, True, labels, w,
                                       cfg_interval=(5, 15))

        def run():
            with torch.inference_mode():
                single = model(x_T, t_eps, labels)
                eps = guided(x_T, t_eps)
                x = denoise_segment(sched, guided_iv, x_T, PARITY_STEPS, 0,
                                    noise_fn=lambda i, t: noise[i])
            return single, eps, x

        reset_launches()
        got = run()
        n1 = read_launches()
        forwards = 2 + PARITY_STEPS
        tc = forwards if dtype == torch.bfloat16 else 0  # tensor cores
        want_n = route_counts(gn=gn * forwards, fwd=fwd * forwards,
                              fwd_mma=mma * tc, fwd_wide=wide * tc)
        if n1 != want_n:
            fail(f"guided parity {name}: the kernel path launched {n1}, "
                 f"want {want_n}")
        if dtype == torch.float32:
            f32_launches = n1
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            want = run()
        if read_launches() != n1:
            fail("guided parity: the plain path launched a kernel")
        gain = 1 + 2 * w
        errs[name] = (
            check("eps (one conditional forward)", name, got[0], want[0],
                  EPS_TOL[dtype]),
            check(f"guided eps (w={w})", name, got[1], want[1],
                  gain * EPS_TOL[dtype]),
            check(f"x ({PARITY_STEPS} guided steps)", name, got[2], want[2],
                  gain * PATH_TOL[dtype]))
        del model
    phase_done(10, "guided path parity", t0)
    return f32_launches, errs


def cond_train_parity(cparams, tmpdir):
    """Phase 11: TRAIN_PARITY_STEPS conditional optimizer steps of the
    kernel path against the plain path from the same seeded weights,
    batches, labels, t, noise and label-dropout masks (dropout 0), at the
    full width of configs/cifar10_cfg.yaml (its lr, sum/B^2 loss and label
    dropout) and batch COND_PARITY_BATCH, in f32 and bf16."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                      make_optimizer, make_train_step)

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    B = COND_PARITY_BATCH
    images, labels = shapes_dataset(n=B * TRAIN_PARITY_STEPS, seed=17)
    batches = [{"image": x, "label": y} for x, y in zip(
        torch.from_numpy(images).to(dev).split(B),
        torch.from_numpy(labels).to(dev).split(B))]
    gen = torch.Generator(device=dev).manual_seed(18)
    results, f32_launches = {}, {}
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = cfg_config(tmpdir, name, "dropout=0.0")
        sched = runner.build_schedule(cfg, device=dev)
        ts = [torch.randint(0, cfg.diffusion.T, (B,), generator=gen,
                            device=dev) for _ in batches]
        noises = [torch.randn(b["image"].shape, generator=gen, device=dev)
                  for b in batches]
        drops = [torch.rand((B,), generator=gen, device=dev)
                 < cfg.train.label_dropout for _ in batches]

        def run():
            model, _ = runner.build_model(cfg)
            model.load_state_dict(cparams)
            model.to(dev)
            tx = make_optimizer(OptimizerConfig(
                lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
                grad_clip=cfg.train.grad_clip,
                multiplier=cfg.train.multiplier, epochs=cfg.train.epoch,
                steps_per_epoch=8), model.parameters())
            state = create_train_state(model, tx)
            step = make_train_step(
                sched, conditional=True,
                loss_reduction=cfg.train.loss_reduction,
                label_dropout=cfg.train.label_dropout,
                ema_decay=cfg.train.ema_decay)
            metrics = [step(state, b, None, t, nz, d)
                       for b, t, nz, d in zip(batches, ts, noises, drops)]
            return ([(m["loss"].item(), m["grad_norm"].item())
                     for m in metrics], model.state_dict())

        reset_launches()
        got, got_params = run()
        n1 = read_launches()
        per = {k: n / TRAIN_PARITY_STEPS for k, n in n1.items()}
        gn, fwd, mma, wide = CFG_PER_FORWARD
        if dtype == torch.float32:
            mma = wide = 0
        if per != step_counts(gn, fwd, mma, wide):
            fail(f"cond train parity {name}: the kernel path launched {per} "
                 "a step")
        if dtype == torch.float32:
            f32_launches = n1
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            want, want_params = run()
        if read_launches() != n1:
            fail("cond train parity: the plain path launched a kernel")
        loss_err = max(abs(g[0] - w[0]) / abs(w[0]) for g, w in zip(got, want))
        gnorm_err = max(abs(g[1] - w[1]) / abs(w[1])
                        for g, w in zip(got, want))
        param_err = max((got_params[k] - w).abs().max().item()
                        for k, w in want_params.items())
        ok = (loss_err <= TRAIN_LOSS_RTOL[dtype]
              and gnorm_err <= TRAIN_GNORM_RTOL[dtype]
              and param_err <= TRAIN_PARAM_TOL[dtype]
              and all(np.isfinite(x) for m in got for x in m))
        log(f"cond train parity {name}: {TRAIN_PARITY_STEPS} steps, batch "
            f"{B}; losses {[round(g[0], 6) for g in got]} vs "
            f"{[round(w[0], 6) for w in want]}; grad norms "
            f"{[round(g[1], 5) for g in got]} vs "
            f"{[round(w[1], 5) for w in want]}; rel err loss {loss_err:.3g} "
            f"(tol {TRAIN_LOSS_RTOL[dtype]}), grad norm {gnorm_err:.3g} "
            f"(tol {TRAIN_GNORM_RTOL[dtype]}); max |dparam| {param_err:.3g} "
            f"(tol {TRAIN_PARAM_TOL[dtype]}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"cond train parity {name} beyond its limits")
        results[name] = (loss_err, gnorm_err, param_err)
        del got_params, want_params
    phase_done(11, "conditional train-step parity", t0)
    return results, f32_launches


def check_representations(rep_dir, epochs, rows, width):
    """The .npz files of a conditional train's representation extraction:
    one an epoch, ``rows`` finite representations of ``width`` and their
    labels; then the analysis CLI's statistics over them (its plots need
    scikit-learn and matplotlib, which the card's machine lacks: it says
    so and draws none)."""
    from itsd_tpu_torch.cli import analyze

    per_epoch = analyze.load_representations(rep_dir)
    bad = [e for e, (r, lab) in per_epoch.items()
           if r.shape != (rows, width) or lab.shape != (rows,)
           or r.dtype != np.float32 or not np.isfinite(r).all()
           or lab.min() < 0 or lab.max() > 9]
    if sorted(per_epoch) != list(range(epochs)) or bad:
        fail(f"representations in {rep_dir}: epochs {sorted(per_epoch)}, "
             f"want {epochs} of [{rows}, {width}]; bad {bad}")
    first, last = (analyze.representation_stats(*per_epoch[e])
                   for e in (0, epochs - 1))
    log(f"representations: {epochs} files of [{rows}, {width}]; epoch 0 "
        f"{first}; epoch {epochs - 1} {last}")
    rc = analyze.main(["--repr-dir", rep_dir, "--out-dir",
                       os.path.join(rep_dir, "analysis")])
    if rc != 0:
        fail(f"python -m itsd_tpu_torch.cli.analyze exited {rc}")


def cond_train_path(tmpdir, card_line):
    """Phase 12: runner.train at the full configuration of
    configs/cifar10_cfg.yaml on the shapes dataset (batch 256, bf16) for
    COND_TRAIN_EPOCHS epochs (8 steps each), no sample grid, one checkpoint at
    the end; exactly 78/13/13/13 launches a step of GroupNorm / flash
    forward / dq / dk-dv, 5 of each attention kernel's 13 on the mma route,
    the other 8 on wide and none on simt; a finite, falling loss; the
    checkpoint restored for one more step and, through the eval loader,
    for RESTORED_EVAL_STEPS guided steps; ms per step, images/s, peak
    memory and the device's busy share."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import denoise_segment
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                      make_optimizer, make_train_step)
    from itsd_tpu_torch.train.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    E = COND_TRAIN_EPOCHS
    cfg = cfg_config(tmpdir, "bfloat16", f"train.epoch={E}",
                     f"train.model_save_freq={E}", "train.eval_freq=1000000")
    B = cfg.train.batch_size
    per_epoch = len(runner.load_dataset(cfg)[0]) // B
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = runner.train(cfg, device=DEVICE)
    torch.cuda.synchronize()
    launches = read_launches()
    seconds = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = out["steps"]
    losses = np.asarray(out["losses"])
    gn, fwd, mma, wide = CFG_PER_FORWARD
    # the config's representation extraction: one forward (no gradient) on
    # every extract_representation_freq-th batch of an epoch
    freq = cfg.train.extract_representation_freq
    per_epoch_reps = -(-per_epoch // freq)
    extracted = scaled(route_counts(gn=gn, fwd=fwd, fwd_mma=mma,
                                    fwd_wide=wide), E * per_epoch_reps)
    per_step = {k: (n - extracted[k]) / steps for k, n in launches.items()}
    log(f"cond train: {steps} steps of batch {B} in {seconds:.2f} s "
        f"(dataset, model set-up, checkpoint and {E * per_epoch_reps} "
        f"representation forwards included); launches {launches}; per step "
        f"{per_step}")
    if per_step != step_counts(gn, fwd, mma, wide):
        fail(f"launches per cond train step {per_step}, want 78/13/13/13, 5 "
             "of each attention kernel's on mma, the other 8 on wide and "
             "none on simt")
    first, last = losses[:per_epoch].mean(), losses[-per_epoch:].mean()
    log(f"loss (sum/B^2): first {losses[0]:.5f}, mean of the first epoch "
        f"({per_epoch} steps) {first:.5f}, of the last {last:.5f}, final "
        f"{losses[-1]:.5f}")
    if (steps != E * per_epoch or not np.isfinite(losses).all()
            or not last < COND_LOSS_FALL * first):
        fail(f"the cond train loss is not finite or did not fall below "
             f"{COND_LOSS_FALL} of its first epoch's mean")
    ckpt = os.path.join(cfg.save_weight_dir, f"ckpt_{E - 1}")
    metrics = os.path.join(cfg.metrics_save_dir, "train_metrics.jsonl")
    if out["checkpoints"] != [ckpt] or not all(
            os.path.isfile(p) for p in (ckpt, metrics)):
        fail(f"missing outputs: checkpoints {out['checkpoints']}, metrics "
             f"{os.path.isfile(metrics)}")
    check_representations(os.path.join(cfg.save_weight_dir,
                                       "representations"),
                          E, per_epoch_reps * B, cfg.model.channel)

    model, _ = runner.build_model(cfg)
    model.to(dev)
    tx = make_optimizer(OptimizerConfig(
        lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
        grad_clip=cfg.train.grad_clip, multiplier=cfg.train.multiplier,
        epochs=cfg.train.epoch, steps_per_epoch=per_epoch),
        model.parameters())
    state = restore_checkpoint(ckpt, create_train_state(model, tx))
    trained = out["state"].model.state_dict()
    for k, v in state.model.state_dict().items():
        if not torch.equal(v, trained[k]):
            fail(f"restored checkpoint differs from the trained state at {k}")
    del out, trained
    step = make_train_step(
        runner.build_schedule(cfg, device=dev), conditional=True,
        loss_reduction=cfg.train.loss_reduction,
        label_dropout=cfg.train.label_dropout, ema_decay=cfg.train.ema_decay)
    images, labels = shapes_dataset(n=B, seed=31)
    batch = {"image": torch.from_numpy(images).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(32)
    resumed_loss = step(state, batch, gen)["loss"].item()
    if state.step != steps + 1 or not np.isfinite(resumed_loss):
        fail(f"resumed step {state.step}, loss {resumed_loss}")
    log(f"restored {ckpt} (step {steps}) and took step {state.step}: loss "
        f"{resumed_loss:.5f}")
    # the checkpoint's EMA weights through the eval loader into the guided
    # eps_fn, for the first RESTORED_EVAL_STEPS steps of the T=3000 chain
    # (phase 9 runs whole chains through runner.evaluate)
    ev_cfg = cfg_config(tmpdir, "bfloat16", f"test_load_weight=ckpt_{E - 1}")
    ev_model, _ = runner.build_model(ev_cfg)
    ev_model.load_state_dict(runner.load_eval_params(ev_cfg))
    ev_model.to(dev).eval()
    eps_fn = runner.sampling_eps_fn(ev_cfg, ev_model, True, CFG_BATCH)
    T = ev_cfg.diffusion.T
    x_T = torch.randn((CFG_BATCH, 32, 32, 3), generator=gen, device=dev)
    with torch.inference_mode():
        ev = denoise_segment(
            runner.build_schedule(ev_cfg, inference=True, device=dev),
            eps_fn, x_T, T, T - RESTORED_EVAL_STEPS, generator=gen)
    if not torch.isfinite(ev).all():
        fail("guided steps from the checkpoint gave non-finite values")
    log(f"guided eval from ckpt_{E - 1} (EMA weights, CFG w="
        f"{ev_cfg.diffusion.w}, batch {CFG_BATCH}): t = {T - 1} down to "
        f"{T - RESTORED_EVAL_STEPS}, x std {ev.std().item():.3f}")
    del ev_model

    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - s0) * 1e3)
    step_ms = float(np.median(walls[2:]))
    kernels, prof_ms = profile_steps(step, state, batch, gen)
    cats = collections.Counter()
    for k, v in kernels.items():
        cats[_category(k)] += v
    dev_ms = sum(kernels.values())
    log(f"cond train step (batch {B}, bf16) on {card_line}: median "
        f"{step_ms:.2f} ms wall (steps 3-7: "
        f"{[round(w, 1) for w in walls[2:]]}), {B / step_ms * 1e3:.1f} "
        f"images/s; peak memory {peak_gb:.3f} GB "
        f"(torch.cuda.max_memory_allocated over runner.train)")
    log(f"profiler: {dev_ms:.2f} ms of kernels a step ({prof_ms:.2f} ms "
        f"wall a step under the profiler); against the median step's "
        f"{step_ms:.2f} ms wall the device is busy "
        f"{100 * dev_ms / step_ms:.1f}%")
    log("  by category (ms a step): " + ", ".join(
        f"{c} {v:.2f}" for c, v in cats.most_common()))
    log("  top kernels (ms a step):")
    for k, v in kernels.most_common(12):
        log(f"    {v:8.3f}  {k[:110]}")
    phase_done(12, "conditional train path (runner.train)", t0)
    return launches




# ---------------------------------------------------------------------------
# the fast and composite samplers (phases 13 and 14)


def sampler_eval(what, cfg, params, per_forward, card_line, want_forwards,
                 want_batches, nfe_of, fold=None, sequential_s=None):
    """One ``runner.evaluate`` through the sampler ``cfg`` names, watched as
    phase 9 watches it: exact launches (``want_forwards`` forwards of
    ``per_forward`` launches each), the batch of every attention call
    (``want_batches``), no synchronizing CUDA operation, finite images.
    ``fold`` = (rows, attention calls a forward) marks Picard: every call
    takes the folded batch, the forwards are its sweeps (read off the
    calls), and the sampler reads delta back once a sweep, so it makes
    exactly that many synchronizing calls; ``sequential_s`` is then the
    sampler seconds of sequential DDIM at the same n, set beside its own.
    ``nfe_of(forwards)``: model evaluations an image. Returns (launches,
    result)."""
    from itsd_tpu_torch.cli import runner

    B = cfg.train.eval_batch_size
    reset_launches()
    t0 = time.perf_counter()
    with watch_sampling() as (batches, sampler_s, syncs):
        out = runner.evaluate(cfg, params, device=DEVICE)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    n_syncs = 0
    if fold is not None:
        rows, per = fold
        want_forwards, rest = divmod(len(batches), per)
        if rest or not want_forwards:
            fail(f"{what}: {len(batches)} attention calls, not a whole "
                 f"number of forwards of {per}")
        want_batches = collections.Counter({rows: len(batches)})
        n_syncs = want_forwards
    if len(syncs) != n_syncs:
        fail(f"{what}: the sampler made {len(syncs)} synchronizing CUDA "
             f"operations, want {n_syncs}: {syncs[:1]}")
    if launches != scaled(per_forward, want_forwards):
        fail(f"{what}: launches {launches}, want {want_forwards} forwards "
             f"of {per_forward}")
    if collections.Counter(batches) != want_batches:
        fail(f"{what}: attention batches {collections.Counter(batches)}, "
             f"want {want_batches}")
    imgs = out["images"]
    if imgs.shape != (B, 32, 32, 3) or not np.isfinite(imgs).all():
        fail(f"{what}: images of shape {imgs.shape}, finite: "
             f"{bool(np.isfinite(imgs).all())}")
    nfe = nfe_of(want_forwards)
    sec = sampler_s[0]
    res = dict(nfe=nfe, forwards=want_forwards, sampler_s=sec,
               evaluate_s=seconds, ms_per_nfe=sec * 1e3 / nfe,
               ms_per_image=sec * 1e3 / B, images_per_s=B / sec)
    log(f"{what}: batch {B}, bf16: NFE {nfe} ({want_forwards} forwards), "
        f"sampler {sec:.3f} s = {res['ms_per_nfe']:.3f} ms/NFE, "
        f"{res['ms_per_image']:.1f} ms/image, {res['images_per_s']:.4f} "
        f"images/s (runner.evaluate {seconds:.3f} s) on {card_line}; "
        f"syncs {len(syncs)}; attention batches "
        f"{dict(collections.Counter(batches))}; images min {imgs.min():.3f} "
        f"max {imgs.max():.3f} std {imgs.std():.3f}")
    if fold is not None:
        res.update(sweeps=want_forwards, sequential_ddim_s=sequential_s)
        log(f"{what}: {want_forwards} sweeps at batch {fold[0]} in "
            f"{sec:.3f} s against sequential DDIM {sequential_s:.3f} s "
            f"({sequential_s / sec:.3f}x) on {card_line}")
    return launches, res


def eval_timesteps(sampler_fn, sched_cpu):
    """The timesteps a deterministic sampler evaluates, in order, read on
    the CPU from a probe eps_fn at one element (phase 13 counts the guided
    steps of an interval from them)."""
    seen = []

    def probe(x, t):
        seen.append(int(t[0]))
        return torch.zeros_like(x)

    sampler_fn(sched_cpu, probe, torch.zeros(1, 1, 1, 1))
    return seen


def fast_sampler_path(params, cparams, tmpdir, card_line):
    """Phase 13: runner.evaluate through the fast and composite samplers at
    full width, bf16, batch 8, on the seeded weights. Unconditional UNet
    (T=1000): DDIM 50 at eta 0 and 1, DPM-Solver++ 20, restart
    RESTARTS over DDIM 50, Picard 50 (batch 400 folded; its wall time
    against sequential DDIM 50 from the same x_T). CFG UNet
    (T=3000, w=1.8): DDIM 50 (dual batch 16), DPM 20 guided on
    CFG_INTERVAL, DDIM 50 with autoguidance, Picard 50 without an interval
    (batch 800). Returns {run: launches}, {run: result}."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import dpm_solver_sample
    from itsd_tpu_torch.core.sampling import restart_nfes, segment_cost

    t0 = time.perf_counter()
    launches, results = {}, {}
    one = route_counts(gn=51, fwd=6, fwd_mma=6)
    n = FAST_STEPS
    ddim = ["diffusion.sampler=ddim", f"diffusion.ddim_steps={n}"]
    restart_fwd = restart_nfes(T_STEPS, RESTARTS,
                               segment_cost(T_STEPS, "ddim", n))
    runs = [
        ("ddim_eval", f"DDIM {n} eta 0", ddim, n),
        ("ddim_eta1_eval", f"DDIM {n} eta 1",
         ddim + ["diffusion.ddim_eta=1.0"], n),
        ("dpm_eval", f"DPM-Solver++ {DPM_STEPS}",
         ["diffusion.sampler=dpm", f"diffusion.ddim_steps={DPM_STEPS}"],
         DPM_STEPS),
        ("restart_eval", f"restart {list(RESTARTS)} over DDIM {n}",
         ddim + [f"diffusion.restart_intervals={list(map(list, RESTARTS))}"
                 .replace(" ", "")], restart_fwd)]
    for tag, what, keys, forwards in runs:
        cfg = eval_config(tmpdir, "bfloat16", *keys)
        launches[tag], results[tag] = sampler_eval(
            what, cfg, params, one, card_line, forwards,
            collections.Counter({BATCH: 6 * forwards}), lambda f: f)
    cfg = eval_config(tmpdir, "bfloat16", "diffusion.sampler=picard",
                      f"diffusion.ddim_steps={n}")
    launches["picard_eval"], results["picard_eval"] = sampler_eval(
        f"Picard {n}", cfg, params, one, card_line, None, None,
        lambda f: f * n, fold=(n * BATCH, 6),
        sequential_s=results["ddim_eval"]["sampler_s"])

    gn, fwd, mma, wide = CFG_PER_FORWARD
    cone = route_counts(gn=gn, fwd=fwd, fwd_mma=mma, fwd_wide=wide)
    B = CFG_BATCH
    cfg = cfg_config(tmpdir, "bfloat16", *ddim)
    launches["cfg_ddim_eval"], results["cfg_ddim_eval"] = sampler_eval(
        f"CFG w={cfg.diffusion.w} DDIM {n}", cfg, cparams, cone, card_line,
        n, collections.Counter({2 * B: fwd * n}), lambda f: 2 * f)
    lo, hi = CFG_INTERVAL
    dkeys = ["diffusion.sampler=dpm", f"diffusion.ddim_steps={DPM_STEPS}",
             f"diffusion.cfg_interval=[{lo},{hi}]"]
    cfg = cfg_config(tmpdir, "bfloat16", *dkeys)
    ts = eval_timesteps(
        lambda sc, e, x: dpm_solver_sample(sc, e, x, num_steps=DPM_STEPS),
        runner.build_schedule(cfg, inference=True, device="cpu"))
    guided = sum(lo <= t < hi for t in ts)
    launches["cfg_dpm_interval_eval"], results["cfg_dpm_interval_eval"] = \
        sampler_eval(
            f"CFG w={cfg.diffusion.w} on {lo} <= t < {hi}, DPM-Solver++ "
            f"{DPM_STEPS} ({guided} steps guided)", cfg, cparams, cone,
            card_line, DPM_STEPS, collections.Counter(
                {2 * B: fwd * guided, B: fwd * (DPM_STEPS - guided)}),
            lambda f: f + guided)
    if not 0 < guided < DPM_STEPS:
        fail(f"DPM-Solver++ {DPM_STEPS} over T={cfg.diffusion.T} guides "
             f"{guided} steps on [{lo}, {hi}): want both branches")
    # the weak weights of autoguidance are read from a file: a second
    # seeded weight file at the config's T=3000
    wdir = os.path.join(tmpdir, "cfg_weights_full")
    os.makedirs(wdir, exist_ok=True)
    cfg = cfg_config(tmpdir, "bfloat16", *ddim, f"save_weight_dir={wdir}",
                     "diffusion.guidance=auto",
                     "diffusion.weak_load_weight=weak.pt")
    weak = seeded_params(cfg_config(tmpdir, "float32", "seed=1"))
    torch.save(weak, os.path.join(wdir, "weak.pt"))
    del weak
    launches["auto_ddim_eval"], results["auto_ddim_eval"] = sampler_eval(
        f"autoguidance w={cfg.diffusion.w} DDIM {n}", cfg, cparams, cone,
        card_line, 2 * n, collections.Counter({B: 2 * fwd * n}),
        lambda f: f)
    cfg = cfg_config(tmpdir, "bfloat16", "diffusion.sampler=picard",
                     f"diffusion.ddim_steps={n}")
    launches["cfg_picard_eval"], results["cfg_picard_eval"] = \
        sampler_eval(f"CFG w={cfg.diffusion.w} Picard {n}", cfg, cparams,
                     cone, card_line, None, None, lambda f: 2 * f * n,
                     fold=(2 * n * B, fwd),
                     sequential_s=results["cfg_ddim_eval"]["sampler_s"])
    phase_done(13, "fast and composite samplers (runner.evaluate)", t0)
    return launches, results


def chain_gain(sampler_fn, sched_cpu, steps):
    """How far an eps error moves the output of a deterministic sampler:
    the sampler is linear in x and eps, so feeding eps = 1 at step j alone
    (x_T = 0) gives that step's weight w_j in the output. Returns (rms,
    worst): sqrt(sum w_j^2), the output's error per unit eps error when
    the steps' errors are independent of each other (an element's error
    is then a sum of independent terms, whose size adds in squares), and
    sum |w_j|, its error when every step's eps is off by 1 in the
    direction that adds up (a bias). DDIM's weights grow where the chain
    divides by a small sqrt(abar) (its first steps) and multiplies back
    less."""
    weights = []
    for j in range(steps):
        calls = []

        def one_hot(x, t):
            calls.append(None)
            return torch.full_like(x, float(len(calls) - 1 == j))

        out = sampler_fn(sched_cpu, one_hot, torch.zeros(1, 1, 1, 1,
                                                         dtype=torch.float64))
        weights.append(float(out))
    w = np.asarray(weights)
    return float(np.sqrt((w ** 2).sum())), float(np.abs(w).sum())


def fast_sampler_parity(params, cparams, tmpdir):
    """Phase 14: the fast samplers through the kernels against the plain
    path, in f32 and bf16, at full width on the seeded weights, from one
    x_T: unconditional DDIM (eta 0) over the whole 50-step chain and
    DPM-Solver++ 20; Picard with max_iters = n against sequential DDIM at
    n = PICARD_PARITY_STEPS, where the two grids agree; the CFG UNet's
    guided (w=1.8) DDIM, 20 steps from state CFG_DDIM_FROM to 0. Each
    limit is the sampler's rms chain gain (``chain_gain``, from its
    coefficients) times the eps limit of phases 4 and 10, which one
    forward meets: the kernels' eps errors come from rounding and
    summation order, independent from step to step, so an eps off by up
    to EPS_TOL at every step moves the output by about that much. (With
    phase 4's measured bf16 eps error, 0.055, the rms gains predict 2.7,
    3.9 and 4.3 on the three unconditional chains; a run on an H100,
    NVIDIA H100 80GB HBM3 at 700 W, read 2.54, 5.54 and 3.98.) An error
    that keeps its sign from step to step adds up as the worst-case gain
    says, and a bias near EPS_TOL then fails the limit; each reading is
    printed beside both limits. Returns {dtype: errors}, the f32 kernel
    path's launches."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import (ddim_sample, ddim_segment,
                                     dpm_solver_sample,
                                     parallel_picard_sample)
    from itsd_tpu_torch.core.sampling import ddim_timesteps

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    m = PICARD_PARITY_STEPS
    if not np.array_equal(ddim_timesteps(T_STEPS, m),
                          np.linspace(T_STEPS - 1, 0, m).round()):
        fail(f"DDIM's and Picard's grids differ at T={T_STEPS}, n={m}")
    samplers = {
        f"DDIM {FAST_STEPS} (eta 0)": lambda sc, e, x: ddim_sample(
            sc, e, x, num_steps=FAST_STEPS, clip_output=False),
        f"DPM-Solver++ {DPM_STEPS}": lambda sc, e, x: dpm_solver_sample(
            sc, e, x, num_steps=DPM_STEPS, clip_output=False)}
    picard_seq = lambda sc, e, x: ddim_sample(  # noqa: E731
        sc, e, x, num_steps=m, clip_output=False)
    cfg_ddim = lambda sc, e, x: ddim_segment(  # noqa: E731
        sc, e, x, CFG_DDIM_FROM, 0, num_steps=PARITY_STEPS)
    sched_cpu = runner.build_schedule(eval_config(tmpdir), inference=True,
                                      device="cpu")
    csched_cpu = runner.build_schedule(cfg_config(tmpdir), inference=True,
                                       device="cpu")
    steps = {f"DDIM {FAST_STEPS} (eta 0)": FAST_STEPS,
             f"DPM-Solver++ {DPM_STEPS}": DPM_STEPS}
    gains = {k: chain_gain(fn, sched_cpu, steps[k])
             for k, fn in samplers.items()}
    gains["picard"] = chain_gain(picard_seq, sched_cpu, m)
    gains["cfg"] = chain_gain(cfg_ddim, csched_cpu, PARITY_STEPS)
    log("phase 14 chain gains (output error per unit eps error at every "
        "step, (rms, worst case)): "
        f"{({k: tuple(round(g, 4) for g in v) for k, v in gains.items()})}")
    gen = torch.Generator(device=dev).manual_seed(31)
    x_T = torch.randn((BATCH, 32, 32, 3), generator=gen, device=dev)
    labels = torch.arange(CFG_BATCH, device=dev) % 10 + 1
    errs, f32_launches = {}, {}

    def check(what, name, got, want, key, factor=1.0):
        """``got`` against ``want`` within factor x gains[key] x EPS_TOL
        of the loop's dtype: the rms gain sets the limit, the worst-case
        one is printed beside it."""
        tol, worst = (factor * g * EPS_TOL[dtype] for g in gains[key])
        err = (got - want).abs().max().item()
        ok = np.isfinite(err) and err <= tol
        log(f"fast parity {name} {what}: max_abs_err {err:.3g} (tol "
            f"{tol:.3g}, {err / tol:.3f} of it; worst-case limit "
            f"{worst:.3g}, {err / worst:.3f} of it), max |want| "
            f"{want.abs().max().item():.3f} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"fast parity {name} {what}: {err:.3g} > {tol:.3g}")
        return err

    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        e = {}
        cfg = eval_config(tmpdir, dtype=name)
        model, _ = runner.build_model(cfg)
        model.load_state_dict(params)
        model.to(dev).eval()
        sched = runner.build_schedule(cfg, inference=True, device=dev)

        def run():
            with torch.inference_mode():
                return {k: fn(sched, model, x_T)
                        for k, fn in samplers.items()}

        reset_launches()
        got = run()
        n1 = read_launches()
        fwds = FAST_STEPS + DPM_STEPS
        tc = fwds if dtype == torch.bfloat16 else 0
        if n1 != route_counts(gn=51 * fwds, fwd=6 * fwds, fwd_mma=6 * tc):
            fail(f"fast parity {name}: the kernel path launched {n1}")
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            want = run()
        if read_launches() != n1:
            fail("fast parity: the plain path launched a kernel")
        for k in samplers:
            e[k] = check(k, name, got[k], want[k], k)
        reset_launches()
        with torch.inference_mode():
            par, sweeps = parallel_picard_sample(
                sched, model, x_T[:PICARD_PARITY_BATCH], num_steps=m,
                max_iters=m, tol=0.0, clip_output=False)
            seq = picard_seq(sched, model, x_T[:PICARD_PARITY_BATCH])
        n2 = read_launches()
        want_n = sweeps + m
        if n2 != route_counts(gn=51 * want_n, fwd=6 * want_n,
                              fwd_mma=6 * want_n * (dtype == torch.bfloat16)):
            fail(f"fast parity {name}: Picard and DDIM launched {n2}, want "
                 f"{sweeps} sweeps and {m} steps")
        e["picard"] = check(f"Picard {m} ({sweeps} sweeps) vs sequential "
                            f"DDIM {m}", name, par, seq, "picard")
        del model
        ccfg = cfg_config(tmpdir, name)
        cmodel, _ = runner.build_model(ccfg)
        cmodel.load_state_dict(cparams)
        cmodel.to(dev).eval()
        csched = runner.build_schedule(ccfg, inference=True, device=dev)
        guided = runner.make_eps_fn(cmodel, True, labels, ccfg.diffusion.w)

        def crun():
            with torch.inference_mode():
                return cfg_ddim(csched, guided, x_T)

        reset_launches()
        cgot = crun()
        n3 = read_launches()
        gn, fwd, mma, wide = CFG_PER_FORWARD
        tc = PARITY_STEPS if dtype == torch.bfloat16 else 0
        if n3 != route_counts(gn=gn * PARITY_STEPS, fwd=fwd * PARITY_STEPS,
                              fwd_mma=mma * tc, fwd_wide=wide * tc):
            fail(f"fast parity {name}: the guided kernel path launched {n3}")
        p_gn, p_attn = plain_path()
        with p_gn, p_attn:
            cwant = crun()
        w = ccfg.diffusion.w
        e["cfg"] = check(f"CFG w={w} DDIM {PARITY_STEPS} steps from "
                         f"{CFG_DDIM_FROM}", name, cgot, cwant,
                         "cfg", 1 + 2 * w)
        if dtype == torch.float32:
            f32_launches = {k: n1[k] + n2[k] + n3[k] for k in n1}
        errs[name] = e
        del cmodel
    phase_done(14, "fast sampler parity", t0)
    return errs, f32_launches


# ---------------------------------------------------------------------------
# search (phases 15 and 16)


def train_search_classifier(tmpdir):
    """The classifier verifier's SmallCNN, trained on the card on the
    shapes dataset at 32x32 with the port's ``train_classifier`` and saved
    with ``save_classifier``. Returns its path."""
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.models import save_classifier, train_classifier

    t0 = time.perf_counter()
    images, labels = shapes_dataset(n=CLF_IMAGES, img_size=32, seed=1)
    _, params, acc = train_classifier(images, labels, epochs=CLF_EPOCHS,
                                      device=DEVICE)
    path = os.path.join(tmpdir, "classifier_shapes32.pt")
    save_classifier(path, params)
    log(f"classifier: SmallCNN (10 classes, ch 32, depth 3) trained on "
        f"{CLF_IMAGES} shapes images for {CLF_EPOCHS} epochs in "
        f"{time.perf_counter() - t0:.2f} s, accuracy {acc:.4f} on the first "
        f"512 -> {path}")
    if acc < CLF_MIN_ACC:
        fail(f"the classifier reached accuracy {acc:.4f} < {CLF_MIN_ACC}")
    return path


ALGORITHMS = ("random_search", "zero_order_search", "path_search",
              "pruned_search", "smc_search", "gradient_search")


@contextlib.contextmanager
def watch_search():
    """Inside ``runner.run_search``: the batch of every attention call; the
    synchronizing CUDA operations PyTorch's sync debug mode reports, per
    call of a search algorithm (the algorithms promise none) and between
    consecutive calls (random search's one read a chunk); the seconds of
    the algorithm calls, synchronized before and after."""
    from itsd_tpu_torch.models import unet
    from itsd_tpu_torch.search import algorithms as A

    seen = dict(batches=[], inside=[], between=[], seconds=0.0)
    attention_fn = unet.spatial_attention
    ends = []

    def attention(q, k, v, impl="auto"):
        seen["batches"].append(q.shape[0])
        return attention_fn(q, k, v, impl)

    def syncs(caught):
        return [str(w.message) for w in caught
                if "called a synchronizing" in str(w.message)]

    def wrap(fn):
        def wrapped(*a, **kw):
            if ends:
                seen["between"].append(len(syncs(caught[ends[-1]:])))
            torch.cuda.synchronize()
            n0, t0 = len(caught), time.perf_counter()
            out = fn(*a, **kw)
            found = syncs(caught[n0:])
            torch.cuda.synchronize()
            seen["seconds"] += time.perf_counter() - t0
            seen["inside"].append(found)
            ends.append(len(caught))
            return out
        return wrapped

    patches = [mock.patch.object(unet, "spatial_attention", attention)] + [
        mock.patch.object(A, name, wrap(getattr(A, name)))
        for name in ALGORITHMS]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device=DEVICE).item()
            if not syncs(caught):
                fail("sync debug mode reported no sync for .item()")
            del caught[:]
            with contextlib.ExitStack() as stack:
                for p in patches:
                    stack.enter_context(p)
                yield seen
        finally:
            torch.cuda.set_sync_debug_mode("default")


def search_run(what, cfg, params, per_forward, forwards, grad_forwards,
               batches, nfes, card_line, reads=0, recompute=0,
               verifier_syncs=False):
    """One ``runner.run_search``, watched: exact launches (``forwards``
    model forwards of ``per_forward`` launches each, plus ``recompute``
    forwards rerun by the remat'd backward, and one dq and one dk/dv per
    attention call of ``grad_forwards`` differentiated forwards), the
    attention batch of every call (``batches``), no synchronizing CUDA
    operation inside an algorithm and ``reads`` between its calls (random
    search: one a chunk), the NFE of JAX's accounting (``nfes``), a finite
    best score and images. ``verifier_syncs``: the verifier reads back
    inside the algorithm (the ensemble verifier's eigendecompositions check
    their error flag on the host), so its syncs are counted, not refused.
    Returns (launches, result)."""
    from itsd_tpu_torch.cli import runner

    B = cfg.train.eval_batch_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with watch_search() as seen:
        out = runner.run_search(cfg, params, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = out["result"]
    inside = [s for call in seen["inside"] for s in call]
    if inside and not verifier_syncs:
        fail(f"{what}: a search algorithm made {len(inside)} synchronizing "
             f"CUDA operations, the first: {inside[0]}")
    if any(n != reads for n in seen["between"]):
        fail(f"{what}: {seen['between']} synchronizing operations between "
             f"the algorithm's calls, want {reads} each")
    attn = per_forward["flash_attention"]
    want = scaled(per_forward, forwards + recompute)
    for k in ("mma", "wide"):
        want[f"flash_bwd_dq_{k}"] = want[f"flash_bwd_dkv_{k}"] = (
            per_forward[f"flash_attention_{k}"] * grad_forwards)
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = attn * grad_forwards
    want["flash_bwd_dq_simt"] = want["flash_bwd_dkv_simt"] = (
        want["flash_bwd_dq"] - want["flash_bwd_dq_mma"]
        - want["flash_bwd_dq_wide"])
    if launches != want:
        fail(f"{what}: launches {launches}, want {want}")
    if collections.Counter(seen["batches"]) != batches:
        fail(f"{what}: attention batches "
             f"{dict(collections.Counter(seen['batches']))}, want "
             f"{dict(batches)}")
    if out["nfes"] != nfes:
        fail(f"{what}: NFE {out['nfes']}, JAX's accounting gives {nfes}")
    imgs = res.best_images
    best = out["best_score"]
    if (imgs is None or tuple(imgs.shape) != (B, 32, 32, 3)
            or not torch.isfinite(imgs).all() or not np.isfinite(best)):
        fail(f"{what}: best score {best}, images "
             f"{None if imgs is None else tuple(imgs.shape)}")
    scores = res.history["scores"]
    scores = np.asarray(scores.float().cpu() if torch.is_tensor(scores)
                        else scores, np.float64).ravel()
    model_fwd = forwards + recompute
    # JAX's NFE unit is T model evaluations: a short DDIM chain can round
    # to 0 of them, and then has no ms per NFE
    ms_nfe = (seen["seconds"] * 1e3 / out["nfes"] if out["nfes"]
              else float("nan"))
    r = dict(nfe=out["nfes"], forwards=forwards, seconds=seconds,
             search_s=seen["seconds"], ms_per_nfe=ms_nfe,
             ms_per_forward=seen["seconds"] * 1e3 / model_fwd,
             peak_gb=peak_gb, best=best,
             median=float(np.nanmedian(scores)),
             syncs_between=sum(seen["between"]), guard=out["guard"],
             syncs_inside=len(inside))
    log(f"{what}: NFE {r['nfe']} ({forwards} forwards"
        f"{f' + {recompute} recomputed' if recompute else ''}, "
        f"{grad_forwards} differentiated), search {seen['seconds']:.3f} s "
        f"(run_search {seconds:.3f} s with set-up) = {r['ms_per_nfe']:.1f} "
        f"ms/NFE, {r['ms_per_forward']:.3f} ms/forward, peak "
        f"{peak_gb:.3f} GB, best score {best:.4f}, median candidate score "
        f"{r['median']:.4f}, syncs: {len(inside)} in the algorithm, "
        f"{r['syncs_between']} between its calls, on {card_line}; attention "
        f"batches {dict(collections.Counter(seen['batches']))}")
    return launches, r


def search_path(params, cparams, tmpdir, card_line, held):
    """Phase 15: runner.run_search at full width, bf16, batch 8, on the
    seeded weights, scored by the classifier verifier (a SmallCNN trained
    here on shapes). Unconditional UNet (T=1000, target class TARGET): random
    N=16 over the ancestral chain cut to SEARCH_T (128 rows; BASELINE
    workload 3 at T=1000); random N=16 in chunks of 4 over DDIM 50, with the
    verifier-hacking guard; pruned 16 -> 4 at SEARCH_PRUNE_AT and path
    search 4/2 at SEARCH_INJECT_AT (ancestral, SEARCH_T);
    zero-order 4 neighbours x 2 iterations over DDIM 50; SMC, 16 particles
    weighed at 700, 400 and 150 (spread scaling, lambda 10), over DDIM 50
    segments; gradient search
    through DPM-Solver++ 20 for 2 iterations, and through the remat'd
    ancestral chain for 1 iteration at diffusion.T=REMAT_T. CFG UNet
    (w=1.8, dual batch 16, the classes of labels 1..8): random N=4 and
    pruned 4 -> 2 at t=1500 over DDIM 50, gradient search through
    DPM-Solver++ 20. Every run's attention batches must be among those
    phase 2 held (``held``: model -> batches). Returns the classifier's
    path, {run: launches}, {run: result}."""
    from itsd_tpu_torch.core.sampling import segment_cost
    from itsd_tpu_torch.search.algorithms import (path_search_nfes,
                                                  pruned_search_nfes,
                                                  smc_search_nfes)

    t0 = time.perf_counter()
    clf = train_search_classifier(tmpdir)
    launches, results = {}, {}
    one = route_counts(gn=51, fwd=6, fwd_mma=6)
    B, T = BATCH, T_STEPS
    n = FAST_STEPS
    verifier = ["search.verifier=classifier",
                f"search.classifier_ckpt={clf}"]
    ddim = ["diffusion.sampler=ddim", f"diffusion.ddim_steps={n}"]
    dpm = ["diffusion.sampler=dpm", f"diffusion.ddim_steps={DPM_STEPS}"]
    ddim_cost = segment_cost(T, "ddim", n)

    def run(model, tag, what, cfg, weights, per_forward, forwards,
            grad_forwards, batches, nfes, **kw):
        unheld = set(batches) - held[model]
        if unheld:
            fail(f"{what}: attention batches {sorted(unheld)} were not "
                 f"held against the plain version in phase 2")
        launches[tag], results[tag] = search_run(
            what, cfg, weights, per_forward, forwards, grad_forwards,
            collections.Counter({b: per_forward["flash_attention"] * f
                                 for b, f in batches.items()}),
            nfes, card_line, **kw)

    def uncond(tag, what, keys, forwards, grad_forwards, batches, nfes,
               **kw):
        cfg = eval_config(tmpdir, "bfloat16", *verifier,
                          f"search.target_label={TARGET}", *keys)
        run("uncond", tag, what, cfg, params, one, forwards, grad_forwards,
            batches, nfes, **kw)

    N, ST = 16, SEARCH_T
    uncond("search_random", f"random N={N}, ancestral T={ST}",
           [f"search.n_candidates={N}", f"diffusion.T={ST}"], ST, 0,
           {N * B: ST}, N)
    chunk, draws = SEARCH_FOLD, 4
    uncond("search_random_chunked",
           f"random N={N} in chunks of {chunk}, DDIM {n}, guard",
           [f"search.n_candidates={N}", f"search.candidate_chunk={chunk}",
            "search.guard_proxy=true", "data.dataset=shapes",
            f"search.guard_baseline_draws={draws}", *ddim],
           (N // chunk + draws) * n, 0,
           {chunk * B: N // chunk * n, B: draws * n}, N,
           reads=1)
    g = results["search_random_chunked"]["guard"]
    log(f"guard: winner FID-proxy {g['winner_fid_proxy']:.4f}, unsearched "
        f"baseline {g['baseline_fid_proxy']:.4f} +- "
        f"{g['baseline_fid_proxy_std']:.4f} over {draws} draws, flagged "
        f"{g['flagged']}")
    if len(g["baseline_fid_proxy_draws"]) != draws or not np.isfinite(
            g["winner_fid_proxy"]):
        fail(f"the guard gave {g}")
    keep, t_p = SEARCH_FOLD, SEARCH_PRUNE_AT
    uncond("search_pruned", f"pruned {N} -> {keep} at t={t_p}, ancestral "
           f"T={ST}",
           [f"search.n_candidates={N}", "search.algorithm=pruned",
            f"search.prune_schedule=[[{t_p},{keep}]]", f"diffusion.T={ST}"],
           ST - t_p + 1 + t_p, 0, {N * B: ST - t_p + 1, keep * B: t_p},
           pruned_search_nfes(ST, N, [(t_p, keep)]))
    paths, active, t_inj, delta = SEARCH_FOLD, 2, SEARCH_INJECT_AT, 50
    uncond("search_path", f"path {paths}/{active} at t={t_inj}, ancestral "
           f"T={ST}",
           ["search.algorithm=path", f"search.n_paths={paths}",
            f"search.n_active={active}",
            f"search.injection_steps=[{t_inj}]", f"search.delta_f={delta}",
            f"diffusion.T={ST}"],
           ST - t_inj + 1 + min(t_inj + delta, ST), 0,
           {paths * B: ST - t_inj + 1 + min(t_inj + delta, ST)},
           path_search_nfes(ST, paths, [t_inj], delta))
    nb, it = SEARCH_FOLD, 2
    uncond("search_zero_order",
           f"zero-order {nb} neighbours x {it} iterations, DDIM {n}",
           ["search.algorithm=zero_order", f"search.n_neighbors={nb}",
            f"search.n_iterations={it}", *ddim],
           (it + 1) * n, 0, {nb * B: it * n, B: n}, it * nb + 1)
    steps = SMC_STEPS
    bounds = (T,) + steps + (0,)
    smc_fwd = sum(ddim_cost(hi, lo) for hi, lo in zip(bounds, bounds[1:]))
    uncond("search_smc", f"SMC {N} particles at {list(steps)}, spread "
           f"lambda 10, DDIM {n}",
           ["search.algorithm=smc", f"search.n_candidates={N}",
            f"search.smc_resample_steps={list(steps)}".replace(" ", ""),
            "search.smc_lambda_scale=spread", *ddim],
           smc_fwd + len(steps), 0,
           {N * B: smc_fwd + len(steps)},
           smc_search_nfes(T, N, steps, ddim_cost))
    uncond("search_gradient_dpm",
           f"gradient, DPM-Solver++ {DPM_STEPS} x 2 iterations",
           ["search.algorithm=gradient", "search.n_iterations=2", *dpm],
           3 * DPM_STEPS, 2 * DPM_STEPS, {B: 3 * DPM_STEPS}, 3)
    uncond("search_gradient_remat",
           f"gradient, remat'd ancestral T={REMAT_T} x 1 iteration",
           ["search.algorithm=gradient", "search.n_iterations=1",
            f"diffusion.T={REMAT_T}"],
           2 * REMAT_T, REMAT_T, {B: 3 * REMAT_T}, 2, recompute=REMAT_T)

    gn, fwd, mma, wide = CFG_PER_FORWARD
    cone = route_counts(gn=gn, fwd=fwd, fwd_mma=mma, fwd_wide=wide)
    CT = cfg_config(tmpdir).diffusion.T

    def cond(tag, what, keys, forwards, grad_forwards, batches, nfes):
        cfg = cfg_config(tmpdir, "bfloat16", *verifier,
                         "diffusion.clip_denoised=true", *keys)
        run("cfg", tag, what, cfg, cparams, cone, forwards, grad_forwards,
            batches, nfes)

    CN = CFG_SEARCH_N
    cond("cfg_search_random", f"CFG random N={CN}, DDIM {n}",
         [f"search.n_candidates={CN}", *ddim], n, 0, {2 * CN * B: n}, CN)
    ccost = segment_cost(CT, "ddim", n)
    ckeep, ct_p = CFG_SEARCH_KEEP, CFG_PRUNE_AT
    cond("cfg_search_pruned", f"CFG pruned {CN} -> {ckeep} at t={ct_p}, "
         f"DDIM {n}", [f"search.n_candidates={CN}", "search.algorithm=pruned",
                       f"search.prune_schedule=[[{ct_p},{ckeep}]]", *ddim],
         ccost(CT, ct_p) + 1 + ccost(ct_p, 0), 0,
         {2 * CN * B: ccost(CT, ct_p) + 1, 2 * ckeep * B: ccost(ct_p, 0)},
         pruned_search_nfes(CT, CN, [(ct_p, ckeep)], ccost))
    cond("cfg_search_gradient_dpm",
         f"CFG gradient, DPM-Solver++ {DPM_STEPS} x 2 iterations",
         ["search.algorithm=gradient", "search.n_iterations=2", *dpm],
         3 * DPM_STEPS, 2 * DPM_STEPS, {2 * B: 3 * DPM_STEPS}, 3)
    phase_done(15, "search (runner.run_search)", t0)
    return clf, launches, results


def search_parity(params, cparams, clf, tmpdir):
    """Phase 16: search through the kernels against the plain path on the
    same seeds, in f32 (simt) and bf16 (mma, wide). Random N=16 and pruned
    16 -> 4 at t=500 of the unconditional UNet over DDIM 50 at eta 0 (the
    candidates drawn from one seed; nothing else is drawn): every
    candidate's score within SCORE_TOL of the plain path's, and the same
    winner unless the plain path's two best lie within SCORE_TOL (the
    margin is printed). Gradient search's gradient of the classifier
    score with respect to the noise through DPM-Solver++ (the unconditional
    UNet at batch 8 over its whole chain in DPM_STEPS steps; the CFG UNet
    at dual batch 16 from state CFG_DDIM_FROM in CFG_GRAD_STEPS): relative
    L2 distance within GRAD_REL_TOL. The classifier scores the chain's
    unclipped output divided by twice its largest magnitude (one constant
    for both paths): on the seeded weights the output is O(700) (phase 14), so
    the sampler's clip to [-1, 1] passes the gradient of only the few
    pixels left inside it, and in bf16 which ones differs between the
    paths by rounding (relative L2 0.97 on an H100, NVIDIA H100 80GB HBM3,
    700 W; f32 4.2e-5). The CFG chain starts at state 200, as phase 14's
    guided parity does: from T=3000 its output reaches ~1e10. Returns the
    f32 kernel path's launches."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import dpm_segment

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    verifier = ["search.verifier=classifier",
                f"search.classifier_ckpt={clf}"]
    ddim = ["diffusion.sampler=ddim", f"diffusion.ddim_steps={FAST_STEPS}"]
    searches = {
        "random N=16": ["search.n_candidates=16"],
        f"pruned 16 -> 4 at t={PRUNE_AT}": [
            "search.algorithm=pruned", "search.n_candidates=16",
            f"search.prune_schedule=[[{PRUNE_AT},4]]"]}
    f32_launches = collections.Counter()
    log(f"search parity limits: scores {SCORE_TOL}, gradient relative L2 "
        f"{GRAD_REL_TOL}")
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        for what, keys in searches.items():
            cfg = eval_config(tmpdir, name, *verifier,
                              f"search.target_label={TARGET}", *ddim, *keys)
            reset_launches()
            got = runner.run_search(cfg, params, device=DEVICE)
            n1 = read_launches()
            if not n1["flash_attention"]:
                fail(f"search parity {what} {name}: no kernel launched")
            if dtype == torch.float32:
                f32_launches.update(n1)
            p_gn, p_attn = plain_path()
            with p_gn, p_attn:
                want = runner.run_search(cfg, params, device=DEVICE)
            if read_launches() != n1:
                fail("search parity: the plain path launched a kernel")
            tol = SCORE_TOL[name]
            # the candidate pool's scores (pruned: at its prune point, where
            # the 4 survivors are chosen), then the winner among the
            # finals
            rounds = [("pool", "scores", 1 if "random" in what else 4)]
            if "pruned" in what:
                rounds.append(("finals", "final_scores", 1))
            for part, hist, keep in rounds:
                gs, ws = (np.asarray(torch.as_tensor(
                    o["result"].history[hist]).float().cpu())
                    for o in (got, want))
                err = float(np.abs(gs - ws).max())
                order = np.argsort(-ws, kind="stable")
                margin = float(ws[order[keep - 1]] - ws[order[keep]]) if \
                    len(ws) > keep else float("inf")
                same = (set(np.argsort(-gs, kind="stable")[:keep])
                        == set(order[:keep]))
                ok = (np.isfinite(err) and err <= tol
                      and (same or margin <= tol))
                best_g = sorted(int(i) for i in
                                np.argsort(-gs, kind="stable")[:keep])
                best_w = sorted(int(i) for i in order[:keep])
                log(f"search parity {what} {name} {part}: max |score err| "
                    f"{err:.4g} (limit {tol}), best {keep} kernels {best_g} "
                    f"plain {best_w}, plain margin {margin:.4g} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"search parity {what} {name} {part}")
                if not same:
                    break  # other survivors: their finals differ

    models = (
        ("uncond", eval_config, params, DPM_STEPS, T_STEPS),
        ("cfg", cfg_config, cparams, CFG_GRAD_STEPS, CFG_DDIM_FROM))
    for tag, make, weights, steps, t_from in models:
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            cfg = make(tmpdir, name, *verifier,
                       f"search.target_label={TARGET}")
            model, conditional = runner.build_model(cfg)
            model.load_state_dict(weights)
            model.to(dev).eval().requires_grad_(False)
            eps_fn = runner.sampling_eps_fn(cfg, model, conditional, BATCH)
            score = runner.build_cli_verifier(cfg, conditional, BATCH,
                                              DEVICE)
            sched = runner.build_schedule(cfg, inference=True, device=dev)
            noise = torch.randn((BATCH, 32, 32, 3), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(41))

            def chain(x):
                return dpm_segment(sched, eps_fn, x, t_from, 0,
                                   num_steps=steps)

            with torch.no_grad():
                # twice the largest magnitude: no pixel reaches the
                # verifier's clamp to [0, 1], whose gradient a pixel
                # exactly at the bound passes on one path and not the
                # other (one such pixel read 4.5e-3 of the f32 CFG
                # gradient's norm)
                out_scale = 2 * chain(noise).abs().max().item()

            def grad():
                x = noise.clone().requires_grad_(True)
                return torch.autograd.grad(score(chain(x) / out_scale),
                                           x)[0]

            reset_launches()
            got = grad()
            n1 = read_launches()
            per = CFG_PER_FORWARD[1] if conditional else 6
            if (n1["flash_bwd_dq"] != per * steps
                    or n1["flash_bwd_dkv"] != per * steps):
                fail(f"gradient parity {tag} {name}: launches {n1}")
            if dtype == torch.float32:
                f32_launches.update(n1)
            p_gn, p_attn = plain_path()
            with p_gn, p_attn:
                want = grad()
            rel = ((got - want).norm() / want.norm()).item()
            tol = GRAD_REL_TOL[name]
            ok = np.isfinite(rel) and rel <= tol
            log(f"gradient parity {tag} {name} (DPM-Solver++ {steps} from "
                f"state {t_from}, batch {BATCH}"
                f"{', dual 16' if conditional else ''}, output / "
                f"{out_scale:.4g}): "
                f"relative L2 {rel:.4g} (limit {tol}), |grad| "
                f"{want.norm().item():.4g} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"gradient parity {tag} {name}: {rel:.4g} > {tol}")
            del model, got, want
    gradient_search_parity(params, clf, tmpdir, f32_launches)
    phase_done(16, "search parity", t0)
    return dict(f32_launches)


def recorded_sample(store):
    """``core.sampling.sample`` as gradient_search calls it, recording in
    ``store`` each call's noise, its output before the clip to [-1, 1], its
    generator's state at the start and, once the backward has passed, the
    gradient that reached the noise (None without one); the clip itself is
    the one ``sample`` applies."""
    from itsd_tpu_torch.core.sampling import sample

    def run(sched, eps_fn, x_T, **kw):
        clip = kw.pop("clip_output", True)
        gen = kw.get("generator")
        state = None if gen is None else gen.get_state()
        x = sample(sched, eps_fn, x_T, clip_output=False, **kw)
        rec = [x_T.detach().clone(), x.detach().clone(), state, None]
        if x_T.requires_grad:
            x_T.register_hook(lambda g: rec.__setitem__(3, g.detach().clone()))
        store.append(rec)
        return x.clamp(-1.0, 1.0) if clip else x

    return run


def worst_element(gs, ws, chains) -> str:
    """The worst element of a gradient_search parity: the iteration whose
    score differs most between the paths, and there the pixel of the
    sampler's images before its clip whose distance to +-1 is smallest
    against the paths' difference: its index, its value on each path, and
    both numbers in float32 steps (ulps) of 1.0. A pixel within the paths'
    difference of +-1 is clipped on one path and passes its gradient on
    the other."""
    worst = int(np.argmax(np.abs(gs - ws)))
    xk, xp = chains["kernels"][worst][1], chains["plain"][worst][1]
    ulp = float(np.spacing(np.float32(1.0)))
    gap = (xk.abs() - 1.0).abs().minimum((xp.abs() - 1.0).abs())
    diff = (xk - xp).abs()
    i = int(torch.argmin(gap - diff))
    idx = tuple(int(j) for j in np.unravel_index(i, tuple(xk.shape)))
    return (f"iteration {worst} (|score err| {abs(gs[worst] - ws[worst]):.4g})"
            f"; the pixel nearest the clip against the paths' difference: "
            f"{idx} kernels {float(xk.flatten()[i]):.9g} plain "
            f"{float(xp.flatten()[i]):.9g}, "
            f"{float(gap.flatten()[i]) / ulp:.3g} ulps from +-1, paths "
            f"{float(diff.flatten()[i]) / ulp:.3g} ulps apart")


def gradient_search_parity(params, clf, tmpdir, f32_launches,
                           records=None):
    """Phase 16, continued: ``gradient_search`` itself (the remat'd
    ancestral chain, Adam, best tracking) on the unconditional UNet at
    batch 8, diffusion.T=GS_T, GS_ITERS iterations, the sampler's draws
    from one seed, on the kernels; then the plain path at each of its
    iterates (the same noise and draws): the scores and gradient norms,
    kernels against plain (GS_SCORE_TOL absolute, GS_NORM_REL_TOL
    relative), the gradient itself at each iterate, the one the search
    used against the plain path's (GS_GRAD_REL_TOL, relative L2), and the
    best score the best of the kernels' history. The plain path is held at
    the kernels' iterates, not run through Adam on its own: Adam's first
    update is ~lr times the sign of each gradient element, so an element
    whose gradient is at the level of Adam's eps (1e-8) or of the paths'
    f32 difference moves by up to 2 lr more on one path than on the other,
    and the next iterate's score differs by up to ~|g| lr (1e-4 where the
    1e-5 limit holds the rest: seen once in twelve runs on an H100). The
    classifier scores the images halved, so that no pixel sits at its
    clamp to [0, 1]. Then, on the kernels, the gradient of that score
    through ``sample(remat=True)`` against ``remat=False`` on the same
    draws, bit for bit under cuDNN's deterministic algorithms, with exact
    launches: the remat'd backward reruns each step's forward. Adds the
    f32 kernel runs' launches to ``f32_launches`` and, by dtype, the
    kernels' iterates and their gradients on both paths to ``records``
    when given (``chip_gs_repeat.py``), before any check can fail."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core.sampling import sample
    from itsd_tpu_torch.search import algorithms as A

    dev = torch.device(DEVICE)
    lr = 0.01  # gradient_search's default
    log(f"gradient_search parity (remat'd ancestral T={GS_T}, {GS_ITERS} "
        f"iterations, batch {BATCH}, lr {lr}; the plain path at the "
        f"kernels' iterates) limits: scores {GS_SCORE_TOL}, gradient norms "
        f"relative {GS_NORM_REL_TOL}, gradients relative L2 "
        f"{GS_GRAD_REL_TOL}; remat against no remat: bit for bit")
    if records is None:
        records = {}
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = eval_config(tmpdir, name, "search.verifier=classifier",
                          f"search.classifier_ckpt={clf}",
                          f"search.target_label={TARGET}",
                          f"diffusion.T={GS_T}")
        model, conditional = runner.build_model(cfg)
        model.load_state_dict(params)
        model.to(dev).eval().requires_grad_(False)
        eps_fn = runner.sampling_eps_fn(cfg, model, conditional, BATCH)
        score = runner.build_cli_verifier(cfg, conditional, BATCH, DEVICE)
        sched = runner.build_schedule(cfg, inference=True, device=dev)
        noise = torch.randn((BATCH, 32, 32, 3), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(43))

        def draws():
            return torch.Generator(device=dev).manual_seed(44)

        def verifier(images):
            return score(images / 2)

        steps = GS_ITERS * GS_T
        chains = {"kernels": [], "plain": []}
        reset_launches()
        with mock.patch.object(A, "sample",
                               recorded_sample(chains["kernels"])):
            got = A.gradient_search(noise, sched, eps_fn, verifier,
                                    n_iterations=GS_ITERS, lr=lr,
                                    generator=draws())
        n1 = read_launches()
        want_n = route_counts(
            gn=51 * 2 * steps, fwd=6 * 2 * steps, dq=6 * steps,
            dkv=6 * steps, **({} if dtype == torch.float32 else dict(
                fwd_mma=6 * 2 * steps, dq_mma=6 * steps,
                dkv_mma=6 * steps)))
        if n1 != want_n:
            fail(f"gradient_search {name}: launches {n1}, want {want_n}")
        if dtype == torch.float32:
            f32_launches.update(n1)

        def loss_and_grad(chain, at, state):
            gen = torch.Generator(device=dev)
            gen.set_state(state)
            x = at.clone().requires_grad_(True)
            loss = -verifier(chain(sched, eps_fn, x, generator=gen,
                                   remat=True))
            (g,) = torch.autograd.grad(loss, x)
            return float(-loss.detach()), g

        # the plain path at each of the kernels' iterates, with its draws
        p_gn, p_attn = plain_path()
        plain = []
        reset_launches()
        with p_gn, p_attn:
            for at, _, state, _ in chains["kernels"]:
                plain.append(loss_and_grad(
                    recorded_sample(chains["plain"]), at, state))
        if any(read_launches().values()):
            fail("gradient_search parity: the plain path launched a kernel")
        gs = got.history["scores"].float().cpu().numpy()
        ws = np.asarray([sc for sc, _ in plain], np.float32)
        gn_ = got.history["grad_norms"].float().cpu().numpy()
        wn_ = np.asarray([float(torch.sqrt((g * g).sum())) for _, g in plain])
        # the gradient each iteration used, against the plain path's there
        g_rel = np.asarray([float((gk - gp).norm() / gp.norm()) for
                            (_, _, _, gk), (_, gp) in zip(chains["kernels"],
                                                          plain)])
        s_err = float(np.abs(gs - ws).max())
        n_rel = float((np.abs(gn_ - wn_) / wn_).max())
        best = float(got.best_score)
        ok = (np.isfinite(s_err) and np.isfinite(n_rel)
              and np.isfinite(g_rel).all()
              and s_err <= GS_SCORE_TOL[name]
              and n_rel <= GS_NORM_REL_TOL[name]
              and g_rel.max() <= GS_GRAD_REL_TOL[name]
              and best == float(gs.max()))

        def show(a):
            return " ".join(f"{x:.6g}" for x in a)

        log(f"gradient_search parity {name}: scores kernels {show(gs)}"
            f", plain {show(ws)}, best {best:.6g}, "
            f"max |score err| {s_err:.4g} (limit {GS_SCORE_TOL[name]}); "
            f"gradient norms kernels {show(gn_)}, plain {show(wn_)}, max "
            f"relative err {n_rel:.4g} (limit {GS_NORM_REL_TOL[name]}); "
            f"gradients relative L2 {show(g_rel)} (limit "
            f"{GS_GRAD_REL_TOL[name]}) -> {'ok' if ok else 'FAIL'}")
        log(f"gradient_search parity {name}, worst element: "
            + worst_element(gs, ws, chains))
        records[name] = dict(
            iterates=[at for at, _, _, _ in chains["kernels"]],
            kernel_grads=[g for _, _, _, g in chains["kernels"]],
            plain_grads=[g for _, g in plain])
        if not ok:
            fail(f"gradient_search parity {name}")

        def grad(remat):
            x = noise.clone().requires_grad_(True)
            img = sample(sched, eps_fn, x, generator=draws(), remat=remat)
            return torch.autograd.grad(verifier(img), x)[0]

        grads = {}
        for remat in (True, False):
            reset_launches()
            # cuDNN's default f32 convolution backward differs from run to
            # run in the last bits (two held chains: 3.4e-7 relative on an
            # H100); its deterministic algorithms leave the recompute as
            # the only difference
            torch.backends.cudnn.deterministic = True
            try:
                grads[remat] = grad(remat)
            finally:
                torch.backends.cudnn.deterministic = False
            n1 = read_launches()
            fwds = GS_T * (2 if remat else 1)
            if (n1["groupnorm_swish"] != 51 * fwds
                    or n1["flash_attention"] != 6 * fwds
                    or n1["flash_bwd_dq"] != 6 * GS_T
                    or n1["flash_bwd_dkv"] != 6 * GS_T):
                fail(f"gradient remat={remat} {name}: launches {n1}")
        rel = ((grads[True] - grads[False]).norm()
               / grads[False].norm()).item()
        ok = (torch.equal(grads[True], grads[False])
              and grads[False].norm().item() > 0)
        log(f"remat'd gradient {name} (ancestral T={GS_T}, kernels, "
            f"deterministic cuDNN): relative L2 to the held chain's "
            f"{rel:.4g} (limit: bit for bit), |grad| "
            f"{grads[False].norm().item():.4g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"remat'd gradient {name}: {rel:.4g}")
        del model, got, grads, chains, plain


# ---------------------------------------------------------------------------
# FID / IS / CLIP tracking


def seeded_clip_file(path: str) -> None:
    """A HuggingFace-layout CLIPModel state dict at the published ViT-B/32
    shape (``metrics.clip.CLIPConfig``'s defaults: vision 768 wide, 12
    layers, 12 heads, patch 32, image 224; text 512 wide, 12 layers, 8
    heads, vocab 49,408, context 77; projection 512) with seeded weights
    (linear and patch kernels N(0, 1/fan_in), embeddings N(0, 0.02^2),
    LayerNorm the identity, biases 0) and the position_ids buffers such
    files carry, saved to ``path``."""
    from itsd_tpu_torch.metrics.clip import CLIPConfig, CLIPModel

    cfg = CLIPConfig()
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in CLIPModel(cfg).state_dict().items()}
    gen = torch.Generator().manual_seed(17)
    sd = {}
    for k, shape in shapes.items():
        if k == "logit_scale":
            sd[k] = torch.tensor(float(np.log(1 / 0.07)))
        elif "norm" in k:
            sd[k] = (torch.ones(shape) if k.endswith("weight")
                     else torch.zeros(shape))
        elif k.endswith("bias"):
            sd[k] = torch.zeros(shape)
        elif "embedding" in k and "patch" not in k:
            sd[k] = torch.randn(shape, generator=gen) * 0.02
        else:
            sd[k] = torch.randn(shape, generator=gen) * float(
                np.prod(shape[1:])) ** -0.5
    sd["vision_model.embeddings.position_ids"] = torch.arange(
        (cfg.image_size // cfg.patch_size) ** 2 + 1)[None]
    sd["text_model.embeddings.position_ids"] = torch.arange(
        cfg.context_length)[None]
    torch.save(sd, path)


@contextlib.contextmanager
def watch_tracked():
    """Inside a tracked run: the batch of every attention call; each
    snapshot chain's wall seconds (synchronized before and after) and the
    synchronizing CUDA operations it makes, which PyTorch's sync debug mode
    reports (the chain promises none); each metric point's seconds,
    synchronized (its extractors on the card, one read back, the float64
    statistics on the host)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models import unet

    seen = dict(batches=[], chain_s=[], syncs=[], point_s=[])
    attention_fn = unet.spatial_attention
    chain_fn, point_fn = runner.sample_with_snapshots, runner._snapshot_metrics

    def attention(q, k, v, impl="auto"):
        seen["batches"].append(q.shape[0])
        return attention_fn(q, k, v, impl)

    def syncs(caught):
        return [str(w.message) for w in caught
                if "called a synchronizing" in str(w.message)]

    def chain(*a, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                torch.ones(1, device=DEVICE).item()
                if not syncs(caught):
                    fail("sync debug mode reported no sync for .item()")
                del caught[:]
                t0 = time.perf_counter()
                out = chain_fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seen["chain_s"].append(time.perf_counter() - t0)
        seen["syncs"].extend(syncs(caught))
        return out

    def point(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = point_fn(*a, **kw)
        torch.cuda.synchronize()
        seen["point_s"].append(time.perf_counter() - t0)
        return out

    with mock.patch.object(unet, "spatial_attention", attention), \
            mock.patch.object(runner, "sample_with_snapshots", chain), \
            mock.patch.object(runner, "_snapshot_metrics", point):
        yield seen


def tracked_run(what, fn, want_fn, batches_fn, card_line):
    """One tracked run ``fn()``, watched: its launches must equal
    ``want_fn(out)`` and its attention batches ``batches_fn(out)``, and no
    chain may synchronize. Returns (launches, stats)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with watch_tracked() as seen:
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if seen["syncs"]:
        fail(f"{what}: the snapshot chain made {len(seen['syncs'])} "
             f"synchronizing CUDA operations, the first: {seen['syncs'][0]}")
    want = want_fn(out)
    if launches != want:
        fail(f"{what}: launches {launches}, want {want}")
    batches = collections.Counter(seen["batches"])
    if batches != batches_fn(out):
        fail(f"{what}: attention batches {dict(batches)}, want "
             f"{dict(batches_fn(out))}")
    r = dict(wall_s=wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             chain_s=seen["chain_s"], point_s=seen["point_s"], out=out)
    log(f"{what}: {wall:.3f} s wall on {card_line}; chains "
        f"{[round(c, 3) for c in seen['chain_s']]} s, 0 syncs inside; "
        f"{len(seen['point_s'])} metric points, "
        f"{1e3 * np.mean(seen['point_s']):.1f} ms a point (median "
        f"{1e3 * np.median(seen['point_s']):.1f}); peak "
        f"{r['peak_gb']:.3f} GB; launches {launches}; attention batches "
        f"{dict(batches)}")
    return launches, r


def read_history(path, want_ts):
    """The rows of a metrics_history JSON; fails unless its timesteps are
    ``want_ts`` and every FID, IS and CLIP is finite."""
    with open(path) as f:
        rows = json.load(f)
    ts = [r["t"] for r in rows]
    bad = [r for r in rows if not all(np.isfinite(r[k])
                                      for k in ("fid", "is", "clip"))]
    if ts != list(want_ts) or bad:
        fail(f"{path}: timesteps {ts} (want {list(want_ts)}), rows with a "
             f"metric not finite: {bad}")
    return rows


def snapshot_ts(T, interval):
    return list(range(T - interval, -1, -interval)) + (
        [0] if T % interval else [])


def tracked_path(wdir, ckpt, cparams, params, clf, tmpdir, card_line,
                 timer):
    """Phase 17: FID / IS / CLIP tracking at full width, bf16, on the
    seeded extractors (random-weight Inception-V3 at 299, CLIP at the
    ViT-B/32 shape written in HuggingFace's layout and read through
    $ITSD_CLIP_WEIGHTS) and IS from the classifier of phase 15 (found by
    is_logit_source=auto under JAX's name). (a) ``inference-metrics`` on
    the unconditional UNet (``--config configs/cifar10_uncond.yaml``,
    shapes, T cut to TRACKED_T, eval batch 64) from ``wdir/ckpt``; (b)
    ``runner.train`` with tracked metrics every epoch for
    TRACKED_TRAIN_EPOCHS epochs of phase 7's configuration, evaluated at
    inference_T=TRACKED_T; (c) guided
    ``inference-metrics`` on the CFG UNet (``configs/cifar10_cfg.yaml``,
    w=1.8, T cut to CFG_SHORT_T as phase 9
    cuts it, dual batch 128); (d) random N=4 search over DDIM 50 with the
    ensemble and the clip verifiers. Exact launches, no sync inside a
    chain, finite metrics at every point. Returns ({run: launches},
    the CLIP file's path)."""
    import shutil

    from itsd_tpu_torch.cli import main as cli_main
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.metrics import (make_clip_feature_fn,
                                        make_inception_extractors)

    t0 = time.perf_counter()
    launches, T = {}, TRACKED_T
    clip_path = os.path.join(tmpdir, "clip_vit_b32.pt")
    c0 = time.perf_counter()
    seeded_clip_file(clip_path)
    log(f"CLIP ViT-B/32-shaped seeded weights written in "
        f"{time.perf_counter() - c0:.2f} s: {clip_path} "
        f"({os.path.getsize(clip_path) / 1e9:.3f} GB)")
    env = {"ITSD_CLIP_WEIGHTS": clip_path, "ITSD_INCEPTION_WEIGHTS": "",
           "ITSD_PIXEL_FEATURES": ""}

    def with_classifier(d):
        os.makedirs(d, exist_ok=True)
        shutil.copy(clf, os.path.join(d, "classifier_shapes32"))

    # extractor costs on the card: a batch of 64 of phase 3's 32x32 images
    feature_fn, _, _ = make_inception_extractors(device=DEVICE)
    with mock.patch.dict(os.environ, env):
        clip_fn = make_clip_feature_fn(device=DEVICE)
    x = torch.rand((TRACKED_BATCH, 32, 32, 3), device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(5))
    with torch.inference_mode():
        inc_ms, _ = timer(lambda: feature_fn.run_both(x), n=3, warmup=1)
        clip_ms, _ = timer(lambda: clip_fn(x), n=3, warmup=1)
    log(f"extractors at batch {TRACKED_BATCH} (32x32 in, f32, TF32 off) on "
        f"{card_line}: Inception-V3 (bilinear to 299, features and logits) "
        f"{inc_ms:.3f} ms = {inc_ms / TRACKED_BATCH:.4f} ms an image; CLIP "
        f"ViT-B/32 (bicubic to 224) {clip_ms:.3f} ms = "
        f"{clip_ms / TRACKED_BATCH:.4f} ms an image")

    one = route_counts(gn=51, fwd=6, fwd_mma=6)
    # (a) inference-metrics on the unconditional UNet
    with_classifier(wdir)
    mdir = os.path.join(tmpdir, "tracked", "metrics")
    argv = ["inference-metrics", "--config", UNCOND_YAML, "--device", DEVICE,
            "data.dataset=shapes", "seed=0", f"diffusion.T={T}",
            f"train.eval_metric_interval={TRACKED_INTERVAL}",
            f"save_weight_dir={wdir}", f"test_load_weight={ckpt}",
            f"sampled_dir={tmpdir}/tracked/sampled",
            f"metrics_save_dir={mdir}"]

    def cli():
        with mock.patch.dict(os.environ, env):
            rc = cli_main.main(argv)
        if rc != 0:
            fail(f"inference-metrics exited {rc}")

    launches["tracked_inference_metrics"], r = tracked_run(
        f"inference-metrics, T={T}, batch {TRACKED_BATCH}", cli,
        lambda _: scaled(one, T),
        lambda _: collections.Counter({TRACKED_BATCH: 6 * T}), card_line)
    rows = read_history(os.path.join(mdir, "metrics_history.json"),
                        snapshot_ts(T, TRACKED_INTERVAL))
    with open(os.path.join(mdir, "metrics_meta.json")) as f:
        meta = json.load(f)
    if (meta["feature_extractor"] != "random" or not meta["clip_tracking"]
            or not meta["is_logit_source"].startswith("classifier:")):
        fail(f"metrics_meta.json: {meta}")
    log(f"inference-metrics: chain {r['chain_s'][0] / T * 1e3:.3f} ms/step "
        f"at batch {TRACKED_BATCH}; history (t, FID, IS, CLIP): "
        + ", ".join(f"({h['t']}, {h['fid']:.3f}, {h['is']:.4f}, "
                    f"{h['clip']:.5f})" for h in rows))

    # (b) tracked training: TRACKED_TRAIN_EPOCHS epochs of phase 7's
    # configuration
    tdir = os.path.join(tmpdir, "tracked_train")
    with_classifier(os.path.join(tdir, "ckpt"))
    cfg = train_config(tmpdir, "bfloat16", "train.track_metrics=true",
                       "train.eval_freq=1", "train.model_save_freq=1",
                       f"train.epoch={TRACKED_TRAIN_EPOCHS}",
                       f"train.metric_interval={TRACKED_TRAIN_INTERVAL}",
                       f"diffusion.inference_T={T}",
                       f"save_weight_dir={tdir}/ckpt",
                       f"sampled_dir={tdir}/sampled",
                       f"metrics_save_dir={tdir}/metrics")
    E = TRACKED_TRAIN_EPOCHS

    def train():
        with mock.patch.dict(os.environ, env):
            return runner.train(cfg, device=DEVICE)

    def train_want(out):
        want = scaled(step_counts(51, 6, 6), out["steps"])
        return {k: n + E * T * one[k] for k, n in want.items()}

    launches["tracked_train"], r = tracked_run(
        f"tracked train, {E} epochs", train, train_want,
        lambda out: collections.Counter({TRAIN_BATCH: 6 * out["steps"],
                                         TRAIN_GRID_BATCH: E * 6 * T}),
        card_line)
    for e in range(E):
        rows = read_history(
            os.path.join(tdir, "metrics", f"metrics_history_epoch_{e}.json"),
            snapshot_ts(T, TRACKED_TRAIN_INTERVAL))
        log(f"tracked train epoch {e}: (t, FID, IS, CLIP) "
            + ", ".join(f"({h['t']}, {h['fid']:.3f}, {h['is']:.4f}, "
                        f"{h['clip']:.5f})" for h in rows))
    with open(os.path.join(tdir, "metrics", "train_metrics.jsonl")) as f:
        evals = [json.loads(line) for line in f if "eval_fid" in line]
    losses = np.asarray(r["out"]["losses"])
    if [e["epoch"] for e in evals] != list(range(E)) or not np.isfinite(
            losses).all():
        fail(f"tracked train: eval records {evals}, losses finite "
             f"{bool(np.isfinite(losses).all())}")
    chain_ms = [round(c / T * 1e3, 3) for c in r["chain_s"]]
    log(f"tracked train: {r['out']['steps']} steps, final loss "
        f"{losses[-1]:.5f}; eval chains {chain_ms} ms/step at batch "
        f"{TRAIN_GRID_BATCH}")

    # (c) guided inference-metrics on the CFG UNet
    gn, fwd, mma, wide = CFG_PER_FORWARD
    cone = route_counts(gn=gn, fwd=fwd, fwd_mma=mma, fwd_wide=wide)
    cdir = os.path.join(tmpdir, "cfg_tracked")
    with_classifier(cdir)
    p_short = dict(cparams)
    p_short["time_embedding.table"] = cparams[
        "time_embedding.table"][:CFG_SHORT_T].clone()
    torch.save(p_short, os.path.join(cdir, "cfg.pt"))
    del p_short
    cmdir = os.path.join(cdir, "metrics")
    cargv = ["inference-metrics", "--config", CFG_YAML, "--device", DEVICE,
             "data.dataset=shapes", "seed=0", f"diffusion.T={CFG_SHORT_T}",
             "diffusion.clip_denoised=true",
             f"train.eval_metric_interval={CFG_TRACKED_INTERVAL}",
             f"save_weight_dir={cdir}", "test_load_weight=cfg.pt",
             f"sampled_dir={cdir}/sampled", f"metrics_save_dir={cmdir}"]

    def cfg_cli():
        with mock.patch.dict(os.environ, env):
            rc = cli_main.main(cargv)
        if rc != 0:
            fail(f"guided inference-metrics exited {rc}")

    CT = CFG_SHORT_T
    launches["cfg_tracked_inference_metrics"], r = tracked_run(
        f"guided inference-metrics, CFG w=1.8, T={CT}, dual batch "
        f"{2 * TRACKED_BATCH}", cfg_cli, lambda _: scaled(cone, CT),
        lambda _: collections.Counter({2 * TRACKED_BATCH: fwd * CT}),
        card_line)
    rows = read_history(os.path.join(cmdir, "metrics_history.json"),
                        snapshot_ts(CT, CFG_TRACKED_INTERVAL))
    log(f"guided inference-metrics: chain {r['chain_s'][0] / CT * 1e3:.3f} "
        f"ms/step; history (t, FID, IS, CLIP): "
        + ", ".join(f"({h['t']}, {h['fid']:.3f}, {h['is']:.4f}, "
                    f"{h['clip']:.5f})" for h in rows))

    # (d) search with the ensemble and the clip verifiers
    N, n, B = TRACKED_SEARCH_N, FAST_STEPS, BATCH
    for verifier in ("ensemble", "clip"):
        cfg = eval_config(tmpdir, "bfloat16", f"search.verifier={verifier}",
                          f"search.n_candidates={N}", "data.dataset=shapes",
                          "diffusion.sampler=ddim",
                          f"diffusion.ddim_steps={n}")
        with mock.patch.dict(os.environ, env):
            launches[f"search_{verifier}"], res = search_run(
                f"random N={N}, DDIM {n}, {verifier} verifier", cfg, params,
                one, n, 0, collections.Counter({N * B: 6 * n}), N, card_line,
                verifier_syncs=verifier == "ensemble")
    phase_done(17, "FID / IS / CLIP tracking", t0)
    return launches, clip_path


def tracked_parity(params, clf, clip_path, tmpdir):
    """Phase 18, in f32: ``sample_with_metrics`` of the unconditional UNet
    at T=TRACKED_PARITY_T (batch 64, a point every 10 steps), kernel path
    against plain path, with the same extractors, real features and draws:
    every FID, IS and CLIP within METRIC_REL_TOL, relative. Then the
    random-weight Inception-V3 and the ViT-B/32-shaped CLIP on the card
    against the same modules on the CPU, on 8 of the shapes images:
    features (and Inception's logits) within EXTRACTOR_REL_TOL of the
    largest CPU value. Returns the kernel path's launches (simt in
    f32)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.metrics import (make_clip_feature_fn,
                                        make_inception_extractors)
    from itsd_tpu_torch.metrics.clip import load_clip
    from itsd_tpu_torch.metrics.features import (RANDOM_SEED,
                                                 clip_image_feature_fn)
    from itsd_tpu_torch.metrics.inception import (inception_from_state_dict,
                                                  init_random_params)
    from itsd_tpu_torch.models import load_classifier_extractors

    t0 = time.perf_counter()
    T = TRACKED_PARITY_T
    cfg = eval_config(tmpdir, "float32", f"diffusion.T={T}",
                      f"train.eval_batch_size={TRACKED_BATCH}",
                      f"train.eval_metric_interval={TRACKED_PARITY_INTERVAL}",
                      f"metrics_save_dir={tmpdir}/tracked_parity")
    feature_fn, _, _ = make_inception_extractors(device=DEVICE)
    _, logit_fn, _ = load_classifier_extractors(clf, DEVICE)
    clip_fn = make_clip_feature_fn(clip_path, device=DEVICE)
    images, _ = shapes_dataset(n=512, img_size=32, seed=0)
    unit = (images + 1.0) / 2.0
    real = runner.compute_real_features(unit, feature_fn, device=DEVICE)
    real_clip = runner.compute_real_features(unit, clip_fn, device=DEVICE)
    hist = {}
    for path in ("kernels", "plain"):
        reset_launches()
        with contextlib.ExitStack() as stack:
            if path == "plain":
                for p in plain_path():
                    stack.enter_context(p)
            out = runner.sample_with_metrics(
                cfg, params, feature_fn=feature_fn, logit_fn=logit_fn,
                real_features=real, clip_feature_fn=clip_fn,
                real_clip_features=real_clip, tag=path, device=DEVICE)
        hist[path] = out["history"]
        if path == "kernels":
            f32_launches = read_launches()
    worst = [0.0, 0.0, 0.0]
    for k, p in zip(hist["kernels"], hist["plain"]):
        if k[0] != p[0]:
            fail(f"tracked parity: timesteps {k[0]} and {p[0]}")
        for i in range(3):
            rel = abs(k[i + 1] - p[i + 1]) / abs(p[i + 1])
            worst[i] = max(worst[i], rel)
    log(f"tracked parity (f32, T={T}, batch {TRACKED_BATCH}, "
        f"{len(hist['plain'])} points): largest relative difference FID "
        f"{worst[0]:.3e}, IS {worst[1]:.3e}, CLIP {worst[2]:.3e} (limit "
        f"{METRIC_REL_TOL}); plain history "
        + ", ".join(f"({h[0]}, {h[1]:.4f}, {h[2]:.5f}, {h[3]:.6f})"
                    for h in hist["plain"]))
    if not all(np.isfinite(w) and w <= METRIC_REL_TOL for w in worst):
        fail(f"tracked parity: kernels against plain {worst}, limit "
             f"{METRIC_REL_TOL}")

    x = torch.from_numpy(unit[:8])
    inc = inception_from_state_dict(init_random_params(
        torch.Generator().manual_seed(RANDOM_SEED)))
    clip_cpu = clip_image_feature_fn(load_clip(clip_path))
    with torch.inference_mode():
        pairs = {"Inception features": (feature_fn.run_both(x.to(DEVICE))[0],
                                        inc(x)[0]),
                 "Inception logits": (feature_fn.run_both(x.to(DEVICE))[1],
                                      inc(x)[1]),
                 "CLIP features": (clip_fn(x.to(DEVICE)), clip_cpu(x))}
    for what, (card, cpu) in pairs.items():
        rel = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
        log(f"{what} on the card against the CPU: {rel:.3e} of the largest "
            f"(limit {EXTRACTOR_REL_TOL})")
        if not rel <= EXTRACTOR_REL_TOL:
            fail(f"{what}: card against CPU {rel}, limit "
                 f"{EXTRACTOR_REL_TOL}")
    phase_done(18, "tracked parity", t0)
    return f32_launches


# ---------------------------------------------------------------------------
# the T-extension fine-tune (phase 19) and the ViT (phase 20)


def ft_overrides(tmpdir: str, *extra):
    """The overrides of configs/fine_tune_config.yaml (the 256x256
    flagship, T=2000, lr 1e-5) that phase 19 runs: a table time embedding
    (so that the surgery runs), bf16 (as configs/imagenet256_uncond.yaml
    sets), batch FT_BATCH (the config's 64 does not fit) with remat, and
    the shapes dataset at 256x256 (no ImageNet folder offline): FT_STEPS
    batches of it, one epoch; the T=1000 checkpoint ``ckpt_T1000.pt`` to
    start from."""
    n_images = FT_STEPS * FT_BATCH
    return [
        "model.time_embed=table", "model.dtype=bfloat16",
        "data.dataset=shapes", "data.use_full_dataset=false",
        f"data.train_subset_ratio={n_images / max(FT_BATCH * 8, 2048)}",
        f"batch_size={FT_BATCH}", "train.epoch=1", f"model.remat={FT_REMAT}",
        "seed=0", "test_load_weight=ckpt_T1000.pt",
        f"train.eval_batch_size={FT_EVAL_BATCH}",
        f"save_weight_dir={tmpdir}/ft_ckpt",
        f"sampled_dir={tmpdir}/ft_sampled",
        f"metrics_save_dir={tmpdir}/ft_metrics", *extra]


def ft_config(tmpdir: str, *extra):
    from itsd_tpu_torch.utils import load_config

    return load_config(FT_YAML, ft_overrides(tmpdir, *extra))


def vit_config(tmpdir: str, *extra):
    """configs/imagenet256_uncond.yaml with model.backbone=vit (ViT-B/16
    at 256x256, bf16, the shapes dataset): VIT_STEPS batches of 16, one
    epoch, no grid; evals at batch 8."""
    from itsd_tpu_torch.utils import load_config

    n_images = VIT_STEPS * VIT_BATCH
    return load_config(IMAGENET_YAML, [
        "model.backbone=vit", "data.use_full_dataset=false",
        f"data.train_subset_ratio={n_images / max(VIT_BATCH * 8, 2048)}",
        f"batch_size={VIT_BATCH}", "train.epoch=1",
        "train.track_metrics=false", "train.eval_freq=1000000",
        "train.model_save_freq=1", "seed=0",
        f"train.eval_batch_size={VIT_EVAL_BATCH}",
        f"save_weight_dir={tmpdir}/vit_ckpt",
        f"sampled_dir={tmpdir}/vit_sampled",
        f"metrics_save_dir={tmpdir}/vit_metrics", *extra])


def vit_attention_shapes(cfg, batch, seq=1):
    """([], the [B*H, N, D] of every attention call of one ViT forward at
    ``batch``): the heads folded into the batch, in path_shapes' layout.
    With ``seq`` > 1, on the rows of one of ``seq`` ranks: each call's
    ``seq`` ring hops at the rank's N / seq tokens."""
    m = cfg.model
    n = (cfg.data.img_size // m.patch_size) ** 2
    return [], [(batch * m.num_heads, n // seq,
                 m.embed_dim // m.num_heads)] * (m.depth * seq)


def _peak_step_gb(cfg, params, batch, dev):
    """Peak device memory (GB) of one frozen fine-tune step of ``cfg``'s
    model from ``params`` at ``batch``."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.train import (OptimizerConfig, create_train_state,
                                      make_optimizer, make_train_step)
    from itsd_tpu_torch.train.surgery import freeze_except_time_embedding

    model, _ = runner.build_model(cfg)
    runner.load_weights(cfg, model, params)
    model.to(dev)
    tx = make_optimizer(OptimizerConfig(lr=cfg.train.fine_tune_lr,
                                        ema_decay=None),
                        freeze_except_time_embedding(model))
    state = create_train_state(model, tx, ema=False)
    step = make_train_step(runner.build_schedule(cfg, device=dev),
                           ema_decay=None)
    gen = torch.Generator(device=dev).manual_seed(41)
    size = cfg.data.img_size
    x = torch.randn((batch, size, size, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = step(state, {"image": x}, gen)["loss"].item()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, tx, state, x
    torch.cuda.empty_cache()
    if not np.isfinite(loss):
        fail(f"memory probe at batch {batch}: loss {loss}")
    return peak


def finetune_path(ft_params, ft_shapes, tmpdir, card_line):
    """Phase 19: ``finetune-t`` at the flagship's full width, as a user runs
    it (``python -m itsd_tpu_torch.cli.main finetune-t --config
    configs/fine_tune_config.yaml`` with the overrides of ``ft_config``),
    from a weights-only T=1000 checkpoint of seeded weights: FT_STEPS steps
    at batch FT_BATCH (remat on), the table extended to T=2000 by
    interpolation.
    Checks: every parameter outside the time embedding bit for bit the
    loaded one; 2000 rows, rows 0 and 1999 the old rows 0 and 999; the
    time embedding moved; a finite loss; exact launches a step (forward,
    remat's recompute, dq and dk/dv; every attention call on wide); the
    checkpoint restores. Then DDIM 20 at batch 8 from the fine-tuned
    checkpoint at T=2000 and from the T=1000 checkpoint at
    inference_T=2000 (the surgery at load). Reports ms a step, images/s,
    peak memory (and at batch FT_MEM_BATCH with and without remat) and
    the busy share. Returns {run: launches}."""
    from itsd_tpu_torch.cli import main as cli_main
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.data import shapes_dataset
    from itsd_tpu_torch.train import make_train_step
    from itsd_tpu_torch.train.checkpoint import restore_params
    from itsd_tpu_torch.train.surgery import extend_time_embedding

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = ft_config(tmpdir)
    T = cfg.diffusion.T
    os.makedirs(cfg.save_weight_dir, exist_ok=True)
    torch.save(ft_params, os.path.join(cfg.save_weight_dir,
                                       "ckpt_T1000.pt"))
    extended = extend_time_embedding(ft_params, T)
    old, new = (p["time_embedding.table"] for p in (ft_params, extended))
    if (tuple(new.shape) != (T, old.shape[1])
            or not torch.equal(new[0], old[0])
            or not torch.equal(new[-1], old[-1])):
        fail(f"the extended table: {tuple(new.shape)}, rows 0 and "
             f"{T - 1} equal to the old rows 0 and {FT_OLD_T - 1}: "
             f"{torch.equal(new[0], old[0])}, "
             f"{torch.equal(new[-1], old[-1])}")

    gn_fwd, attn = ft_shapes
    gn, n_attn = len(gn_fwd), len(attn)
    routes = {attention_route(C) for _, _, C in attn}
    if routes != {"wide"}:
        fail(f"the fine-tune's attention takes routes {routes}, want wide")
    k = 2 if FT_REMAT else 1
    # the forward, then remat's recompute of every ResBlock (all but the
    # tail's GroupNorm)
    per_step = route_counts(gn=k * gn - (k - 1), fwd=k * n_attn,
                            fwd_wide=k * n_attn, dq=n_attn, dq_wide=n_attn,
                            dkv=n_attn, dkv_wide=n_attn)
    argv = ["finetune-t", "--config", FT_YAML, "--device", DEVICE,
            *ft_overrides(tmpdir)]
    out = {}
    real = runner.finetune_extended_T

    def keep(*a, **kw):
        out.update(real(*a, **kw))
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s0 = time.perf_counter()
    with mock.patch.object(runner, "finetune_extended_T", keep):
        rc = cli_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - s0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        fail(f"finetune-t exited {rc}")
    steps = out["steps"]
    losses = np.asarray(out["losses"])
    got_per_step = {key: n / max(steps, 1) for key, n in launches.items()}
    log(f"finetune-t: {steps} steps of batch {FT_BATCH} (T {FT_OLD_T} -> "
        f"{T}, remat {FT_REMAT}) in {seconds:.2f} s (dataset, weights and "
        f"checkpoint included); ckpt T detected {out['ckpt_T_detected']}; "
        f"losses {[round(float(x), 5) for x in losses]}; launches "
        f"{launches}; "
        f"per step {got_per_step}")
    if got_per_step != per_step:
        fail(f"launches per fine-tune step {got_per_step}, want {per_step}")
    if (steps != FT_STEPS or out["ckpt_T_detected"] != FT_OLD_T
            or not np.isfinite(losses).all()):
        fail(f"fine-tune: {steps} steps, ckpt T {out['ckpt_T_detected']}, "
             f"losses {losses}")
    trained = {key: v.detach().cpu() for key, v in
               out["state"].model.state_dict().items()}
    changed = [key for key, v in trained.items()
               if not torch.equal(v, extended[key])]
    frozen_moved = [key for key in changed
                    if not key.startswith("time_embedding.")]
    if frozen_moved or len(changed) != 5:
        fail(f"fine-tune moved {changed}: want the 5 time-embedding "
             f"tensors only")
    ckpt = os.path.join(cfg.save_weight_dir, f"fine_tuned_T{T}_epoch_0")
    saved = restore_params(ckpt)
    if out["checkpoints"] != [ckpt] or saved.keys() != trained.keys() or \
            not all(torch.equal(saved[key], v) for key, v in trained.items()):
        fail(f"the checkpoint {out['checkpoints']} does not restore the "
             "fine-tuned weights")
    log(f"frozen: {len(trained) - 5} tensors bit for bit the loaded ones; "
        f"moved: {sorted(changed)}; table "
        f"{tuple(trained['time_embedding.table'].shape)}; {ckpt} restores")

    # the steady-state step, its busy share, and peak memory with and
    # without remat at a batch where both fit
    state = out["state"]
    del out, trained, saved
    step = make_train_step(runner.build_schedule(cfg, device=dev),
                           ema_decay=None)
    size = cfg.data.img_size
    images, _ = shapes_dataset(n=FT_BATCH, img_size=size, seed=43)
    batch = {"image": torch.from_numpy(images).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(44)
    walls = []
    for _ in range(FT_TIMED_STEPS):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - w0) * 1e3)
    step_ms = float(np.median(walls))
    kernels, prof_ms = profile_steps(step, state, batch, gen, n=1)
    dev_ms = sum(kernels.values())
    cats = collections.Counter()
    for name, v in kernels.items():
        cats[_category(name)] += v
    del state, batch, step
    torch.cuda.empty_cache()
    peaks = {remat: _peak_step_gb(ft_config(tmpdir, f"model.remat={remat}"),
                                  ft_params, FT_MEM_BATCH, dev)
             for remat in (False, True)}
    log(f"fine-tune step (batch {FT_BATCH}, bf16, remat {FT_REMAT}) on "
        f"{card_line}: median {step_ms:.2f} ms wall "
        f"({[round(w, 1) for w in walls]}), {FT_BATCH / step_ms * 1e3:.2f} "
        f"images/s; peak memory {peak_gb:.3f} GB over finetune-t; at batch "
        f"{FT_MEM_BATCH} one step peaks at {peaks[False]:.3f} GB without "
        f"remat, {peaks[True]:.3f} GB with")
    log(f"profiler: {dev_ms:.2f} ms of kernels a step ({prof_ms:.2f} ms "
        f"wall under the profiler): busy {100 * dev_ms / step_ms:.1f}% of "
        f"the median step; by category (ms): " + ", ".join(
            f"{c} {v:.2f}" for c, v in cats.most_common()))

    # DDIM 20 at batch 8: the fine-tuned checkpoint at T=2000, and the
    # T=1000 checkpoint at inference_T=2000 (the surgery at load)
    one = route_counts(gn=gn, fwd=n_attn, fwd_wide=n_attn)
    evals = {}
    for tag, extra in (
            ("finetune_eval", [f"test_load_weight=fine_tuned_T{T}_epoch_0"]),
            ("finetune_surgery_eval", [f"diffusion.T={FT_OLD_T}",
                                       f"diffusion.inference_T={T}"])):
        ecfg = ft_config(tmpdir, "diffusion.sampler=ddim",
                         f"diffusion.ddim_steps={FT_EVAL_STEPS}", *extra)
        reset_launches()
        with watch_sampling() as (batches, sampler_s, syncs):
            imgs = runner.evaluate(ecfg, device=DEVICE)["images"]
        evals[tag] = read_launches()
        if evals[tag] != scaled(one, FT_EVAL_STEPS) or syncs or \
                collections.Counter(batches) != {FT_EVAL_BATCH:
                                                 n_attn * FT_EVAL_STEPS}:
            fail(f"{tag}: launches {evals[tag]}, syncs {len(syncs)}, "
                 f"attention batches {collections.Counter(batches)}")
        if (imgs.shape != (FT_EVAL_BATCH, size, size, 3)
                or not np.isfinite(imgs).all()):
            fail(f"{tag}: images {imgs.shape}, finite "
                 f"{bool(np.isfinite(imgs).all())}")
        log(f"{tag}: DDIM {FT_EVAL_STEPS} at T={T}, batch {FT_EVAL_BATCH}: "
            f"sampler {sampler_s[0]:.3f} s = "
            f"{sampler_s[0] / FT_EVAL_STEPS * 1e3:.2f} ms a step; images "
            f"std {imgs.std():.3f}")
    phase_done(19, "T-extension fine-tune (finetune-t)", t0)
    return {"finetune": launches, **evals}


def attention_route(C):
    from itsd_tpu_torch.kernels import attention

    routes = {attention.route(torch.bfloat16, C, k)
              for k in attention.KERNELS}
    return routes.pop() if len(routes) == 1 else routes


def vit_path(tmpdir, card_line):
    """Phase 20: the ViT backbone at full width (ViT-B/16 at 256x256,
    bf16, seeded weights): ``runner.train`` for VIT_STEPS steps at batch
    16 (exactly 12 flash forwards, 12 dq and 12 dk/dv a step, all on mma
    at C=64, no GroupNorm), then ``runner.evaluate`` through DDIM 50 at
    batch 8 from its checkpoint (12 forwards a model evaluation on mma);
    finite loss and images; one f32 (simt) and one bf16 (mma) forward of
    the kernel path against the plain path ("xla") on the same weights.
    Returns ({run: launches}, the f32 forward's launches)."""
    from itsd_tpu_torch.cli import runner

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = vit_config(tmpdir)
    depth = cfg.model.depth
    if attention_route(cfg.model.embed_dim // cfg.model.num_heads) != "mma":
        fail("the ViT's attention does not route to mma")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s0 = time.perf_counter()
    out = runner.train(cfg, max_steps=VIT_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - s0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, losses = out["steps"], np.asarray(out["losses"])
    per_step = {k: n / max(steps, 1) for k, n in launches.items()}
    log(f"ViT train: {steps} steps of batch {VIT_BATCH} in {seconds:.2f} s "
        f"(dataset, model set-up and checkpoint included); losses "
        f"{[round(float(x), 5) for x in losses]}; peak {peak_gb:.3f} GB; "
        f"per step "
        f"{per_step}")
    if per_step != step_counts(0, depth, depth):
        fail(f"ViT launches a step {per_step}, want {depth} forwards, dq "
             "and dk/dv on mma, no GroupNorm")
    if steps != VIT_STEPS or not np.isfinite(losses).all():
        fail(f"ViT train: {steps} steps, losses {losses}")
    ecfg = vit_config(tmpdir, "test_load_weight=ckpt_0",
                      "diffusion.sampler=ddim",
                      f"diffusion.ddim_steps={VIT_EVAL_STEPS}")
    reset_launches()
    with watch_sampling() as (_, sampler_s, syncs):
        imgs = runner.evaluate(ecfg, device=DEVICE)["images"]
    eval_launches = read_launches()
    want = route_counts(fwd=depth * VIT_EVAL_STEPS,
                        fwd_mma=depth * VIT_EVAL_STEPS)
    if eval_launches != want or syncs:
        fail(f"ViT eval: launches {eval_launches}, want {want}; syncs "
             f"{len(syncs)}")
    size = cfg.data.img_size
    if imgs.shape != (VIT_EVAL_BATCH, size, size, 3) or \
            not np.isfinite(imgs).all():
        fail(f"ViT eval: images {imgs.shape}")
    log(f"ViT eval: DDIM {VIT_EVAL_STEPS}, batch {VIT_EVAL_BATCH}, on "
        f"{card_line}: sampler {sampler_s[0]:.3f} s = "
        f"{sampler_s[0] / VIT_EVAL_STEPS * 1e3:.2f} ms a step, "
        f"{VIT_EVAL_BATCH / sampler_s[0]:.3f} images/s; images std "
        f"{imgs.std():.3f}")

    # kernel path against plain path, one forward in f32 and in bf16
    params = {k: v.detach().cpu() for k, v in out["state"].model.state_dict(
    ).items()}
    del out
    gen = torch.Generator(device=dev).manual_seed(51)
    x = torch.randn((VIT_EVAL_BATCH, size, size, 3), generator=gen,
                    device=dev)
    t = torch.linspace(0, cfg.diffusion.T - 1, VIT_EVAL_BATCH,
                       device=dev).round().long()
    f32_launches = None
    for dtype in ("float32", "bfloat16"):
        outs = {}
        for impl in ("auto", "xla"):
            m, _ = runner.build_model(vit_config(
                tmpdir, f"model.dtype={dtype}",
                f"model.attention_impl={impl}"))
            m.load_state_dict(params)
            m.to(dev).eval()
            reset_launches()
            with torch.inference_mode():
                outs[impl] = m(x, t)
            torch.cuda.synchronize()
            n = read_launches()
            if impl == "auto":
                want = route_counts(fwd=depth, fwd_mma=depth * (
                    dtype == "bfloat16"))
                if n != want:
                    fail(f"ViT {dtype} kernel path launched {n}")
                if dtype == "float32":
                    f32_launches = n
            elif sum(n.values()):
                fail(f"ViT {dtype} plain path launched {n}")
        err = (outs["auto"] - outs["xla"]).abs().max().item()
        ok = np.isfinite(err) and err <= VIT_EPS_TOL[dtype]
        log(f"ViT path parity {dtype}: max_abs_err {err:.3g} (tol "
            f"{VIT_EPS_TOL[dtype]}), max |plain| "
            f"{outs['xla'].abs().max().item():.3f} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"ViT path parity {dtype}: {err:.3g}")
    phase_done(20, "ViT backbone (train, eval)", t0)
    return {"vit_train": launches, "vit_eval": eval_launches}, f32_launches


def cuda_tests():
    """Phase 8: the CUDA tests in a subprocess, against the library that
    phase 1 built (the same sources hash to the same build directory)."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
           "-p", "no:cacheprovider", "tests/test_torch_cuda.py"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log(f"{' '.join(cmd[1:])}: exit {proc.returncode}; {tail[0]}")
    if proc.returncode != 0:
        log(proc.stdout[-6000:] + proc.stderr[-2000:])
        fail(f"the CUDA tests failed (exit {proc.returncode})")
    phase_done(8, "CUDA tests", t0)


# The paths whose launches the kernels' JSON line carries: the bf16 runs of
# runner.evaluate, runner.train, runner.run_search, the tracked entry
# points, finetune-t, the ViT's train and eval, the torchrun train and the
# two-rank runs of the flagship, the CIFAR UNet and the ViT (phases 3, 7,
# 9, 12, 13, 15, 17, 19, 20, 21 and 22).
MAIN_PATHS = ("eval", "train", "cfg_eval", "cfg_interval_eval", "auto_eval",
              "cond_train", "ddim_eval", "ddim_eta1_eval", "dpm_eval",
              "restart_eval", "picard_eval",
              "cfg_ddim_eval", "cfg_dpm_interval_eval", "auto_ddim_eval",
              "cfg_picard_eval", "search_random", "search_random_chunked",
              "search_pruned", "search_path", "search_zero_order",
              "search_smc", "search_gradient_dpm", "search_gradient_remat",
              "cfg_search_random", "cfg_search_pruned",
              "cfg_search_gradient_dpm", "tracked_inference_metrics",
              "tracked_train", "cfg_tracked_inference_metrics",
              "search_ensemble", "search_clip", "finetune", "finetune_eval",
              "finetune_surgery_eval", "vit_train", "vit_eval", "dp_train",
              "dp_ring_train", "sp_flagship_train", "sp_flagship_ddim",
              "sp_cifar_train", "sp_vit_train", "sp_vit_ddim")
WORK = {"train": "one train step of configs/cifar10_uncond.yaml (batch 128, "
                 "bf16)",
        "cond_train": "one train step of configs/cifar10_cfg.yaml (batch "
                      "256, bf16)",
        "flagship_rows_k2": "one forward of configs/imagenet256_uncond.yaml "
                            "(batch 2, bf16) on the rows of one of 2 seq "
                            "ranks: its 51 GroupNorm calls"}
# name -> (source, the TPU kernel it replaces, the step its times sum over)
# The mma forward, dq and dk/dv are the Hopper kernels; the mma.sync
# kernels they replaced (EARLIER) are timed beside them in phases 2 and 5,
# and their times stand in those entries as "mma_sync_ms".
EARLIER = {
    "flash_attention_mma": ("flash_attention_mma_sync",
                            "itsd_tpu_torch/csrc/flash_attention_mma.cu"),
    "flash_bwd_dq_mma": ("flash_bwd_dq_mma_sync",
                         "itsd_tpu_torch/csrc/flash_attention_bwd_dq_mma.cu"),
    "flash_bwd_dkv_mma": ("flash_bwd_dkv_mma_sync",
                          "itsd_tpu_torch/csrc/flash_attention_bwd_mma.cu")}
# The stats kernel's entry carries beside its two-launch total (its "ms",
# "library_ms": torch.sum over the sum's launches, and "bound_ms"): the
# kernel over the sum's launches alone ("sum_ms", like for like with
# library_ms), the earlier stats kernel timed in turns with it in phase 2
# ("cluster_ms", "cluster_sum_ms") and an empty kernel on its grid
# ("empty_ms"): phase 2's rows of these names.
STATS_SPLITS = {"groupnorm_partial_stats_sum": "sum_ms",
                "groupnorm_partial_stats_cluster": "cluster_ms",
                "groupnorm_partial_stats_cluster_sum": "cluster_sum_ms",
                "groupnorm_partial_stats_empty": "empty_ms"}
KERNELS = {
    "groupnorm_swish": ("itsd_tpu_torch/csrc/groupnorm.cu",
                        "itsd_tpu/kernels/groupnorm.py:47", "train"),
    "groupnorm_partial_stats": ("itsd_tpu_torch/csrc/groupnorm.cu",
                                "itsd_tpu/kernels/groupnorm.py:47",
                                "flagship_rows_k2"),
    "groupnorm_apply": ("itsd_tpu_torch/csrc/groupnorm.cu",
                        "itsd_tpu/kernels/groupnorm.py:47",
                        "flagship_rows_k2"),
    "flash_attention_mma": ("itsd_tpu_torch/csrc/flash_attention_hopper.cu",
                            "itsd_tpu/kernels/attention.py:50", "train"),
    "flash_attention_wide": ("itsd_tpu_torch/csrc/flash_attention_wide.cu",
                             "itsd_tpu/kernels/attention.py:50",
                             "cond_train"),
    "flash_attention_simt": ("itsd_tpu_torch/csrc/flash_attention.cu",
                             "itsd_tpu/kernels/attention.py:50",
                             "cond_train"),
    "flash_bwd_dq_mma": (
        "itsd_tpu_torch/csrc/flash_attention_bwd_dq_hopper.cu",
        "itsd_tpu/kernels/attention.py:229", "train"),
    "flash_bwd_dq_wide": ("itsd_tpu_torch/csrc/flash_attention_bwd_dq_wide.cu",
                          "itsd_tpu/kernels/attention.py:229", "cond_train"),
    "flash_bwd_dq_simt": ("itsd_tpu_torch/csrc/flash_attention_bwd.cu",
                          "itsd_tpu/kernels/attention.py:229", "cond_train"),
    "flash_bwd_dkv_mma": (
        "itsd_tpu_torch/csrc/flash_attention_bwd_dkv_hopper.cu",
        "itsd_tpu/kernels/attention.py:260", "train"),
    "flash_bwd_dkv_wide": ("itsd_tpu_torch/csrc/flash_attention_bwd_wide.cu",
                           "itsd_tpu/kernels/attention.py:260",
                           "cond_train"),
    "flash_bwd_dkv_simt": ("itsd_tpu_torch/csrc/flash_attention_bwd.cu",
                           "itsd_tpu/kernels/attention.py:260",
                           "cond_train"),
}


def kernel_json(fwd, bwd, path_launches, f32_launches):
    """The kernels' JSON entries, each route's kernel an entry of its own.
    Times are summed over one train step at bf16 (the paths that run every
    function): the unconditional one for GroupNorm and the mma kernels,
    the conditional one for the wide and simt kernels at the CFG UNet's
    C=512 and C=1024 (the simt kernels there through forced calls on the
    same inputs); the sums over the other paths' steps stand beside them.
    ``launches`` sums the kernel's launches over the bf16 runs of
    runner.evaluate, runner.train, runner.run_search and the tracked entry
    points (``launches_by_path``); the simt forward, dq and dk/dv, which no
    bf16 path sends there, count their launches on the f32 kernel paths of
    the parity phases 4, 6, 10, 11, 14, 16 and 18
    (``launches_f32_parity``, kept for every kernel)."""
    entries = []
    for name, (source, replaces, work) in KERNELS.items():
        by_tag = fwd[name] if name in fwd else bwd[name]
        err = max(res[0] for res in by_tag.values())
        by_path = {p: path_launches[p][name] for p in MAIN_PATHS}
        launches, counted_on = sum(by_path.values()), "bf16 runner paths"
        if not launches and name in ("flash_attention_simt",
                                     "flash_bwd_dq_simt",
                                     "flash_bwd_dkv_simt"):
            launches = f32_launches[name]
            counted_on = ("f32 kernel paths of phases 4, 6, 10, 11, 14, 16, "
                          "18, 20, 22")
        if not launches:
            fail(f"{name} was not launched on its paths")
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=launches,
                     max_abs_err=err, **rows_entry(by_tag[work][1]))
        entry["work"] = WORK[work]
        entry["launches_counted_on"] = counted_on
        entry["launches_by_path"] = by_path
        entry["launches_f32_parity"] = f32_launches[name]
        for tag, (_, rows) in by_tag.items():
            if tag != work and rows:
                key = ("flagship_batch1" if tag == "flagship"
                       else f"{tag}_step")
                entry[key] = rows_entry(rows)
        if name in EARLIER:
            earlier, earlier_source = EARLIER[name]
            sync = fwd[earlier] if earlier in fwd else bwd[earlier]
            entry["mma_sync_source"] = earlier_source
            entry["mma_sync_ms"] = rows_entry(sync[work][1])["ms"]
            for tag, (_, rows) in sync.items():
                if tag != work and rows:
                    entry[f"{tag}_step"]["mma_sync_ms"] = rows_entry(
                        rows)["ms"]
        if name not in fwd:
            entry["library"] = ("one SDPA backward, which computes dq, dk "
                                "and dv together")
        if name == "groupnorm_partial_stats":
            entry["library"] = ("torch.sum over each span in f32, for the "
                                "sum's launches; the squared deviations' "
                                "have no single PyTorch call")
            entry["cluster_source"] = "itsd_tpu_torch/csrc/groupnorm.cu"
            for split, key in STATS_SPLITS.items():
                entry[key] = rows_entry(fwd[split][work][1])["ms"]
                for tag, (_, rows) in fwd[split].items():
                    if tag != work and rows:
                        entry[f"{tag}_step"][key] = rows_entry(rows)["ms"]
        if name == "groupnorm_apply":
            # no PyTorch call normalizes with given statistics
            entry["library_ms"] = None
            for key, value in entry.items():
                if key.endswith("_step") and isinstance(value, dict):
                    value["library_ms"] = None
        entries.append(entry)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import itsd_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--cli"]:
        return cli_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--spatial"]:
        return spatial_worker(sys.argv[2:])
    dev = torch.device(DEVICE)
    name, smi_line = card()
    build()
    if sys.argv[1:2] == ["--sp-control"]:
        return sp_control(smi_line)
    with tempfile.TemporaryDirectory(prefix="itsd_chip_smoke_") as tmpdir:
        cfg = eval_config(tmpdir)
        params = seeded_params(cfg)
        (eval_shapes, train_shapes, picard_shapes, search_shapes,
         tracked_shapes) = path_shapes(
            cfg, params, dev, (BATCH, TRAIN_BATCH, FAST_STEPS * BATCH,
                               SEARCH_FOLD * BATCH, TRACKED_BATCH))
        ccfg = cfg_config(tmpdir)
        cparams = seeded_params(ccfg)
        (cfg_shapes, cfg_b8_shapes, cond_shapes, cfg_picard_shapes,
         cfg_search_shapes, cfg_pruned_shapes,
         cfg_tracked_shapes) = path_shapes(
            ccfg, cparams, dev,
            (2 * CFG_BATCH, CFG_BATCH, ccfg.train.batch_size,
             2 * FAST_STEPS * CFG_BATCH, 2 * CFG_SEARCH_N * CFG_BATCH,
             2 * CFG_SEARCH_KEEP * CFG_BATCH, 2 * TRACKED_BATCH))
        # the fine-tune's shapes (the flagship at batch FT_BATCH, 256x256) and
        # the ViT's (heads folded into the batch)
        ft_params = seeded_params(ft_config(tmpdir,
                                            f"diffusion.T={FT_OLD_T}"))
        (ft_shapes,) = path_shapes(
            ft_config(tmpdir, f"diffusion.T={FT_OLD_T}"), ft_params, dev,
            (FT_BATCH,))
        vcfg = vit_config(tmpdir)
        vit_train_shapes = vit_attention_shapes(vcfg, VIT_BATCH)
        vit_eval_shapes = vit_attention_shapes(vcfg, VIT_EVAL_BATCH)
        # phase 22's ViT on the rows of one of 2 seq ranks: each call's
        # two ring hops at a rank's tokens
        vit_rows_shapes = vit_attention_shapes(vcfg, SP_FLAG_BATCH,
                                               SP_RANKS)
        from itsd_tpu_torch.kernels import attention
        fwd_routes = collections.Counter(
            attention.route(torch.bfloat16, C, "forward")
            for _, _, C in cfg_shapes[1])
        per_forward = (len(cfg_shapes[0]), len(cfg_shapes[1]),
                       fwd_routes["mma"], fwd_routes["wide"])
        if per_forward != CFG_PER_FORWARD:
            fail(f"one forward of the CFG UNet makes {per_forward} GroupNorm "
                 f"calls, attention calls, mma ones and wide ones, want "
                 f"{CFG_PER_FORWARD}")
        timer = DeviceTimer()
        # calls a timing repetition (halved, to 10 and 5 from 20 and 10,
        # when the data-parallel phase came)
        fwd = check_forward_kernels({
            "eval": (eval_shapes, 10, False),
            "train": (train_shapes, 5, True),
            "cfg_eval": (cfg_shapes, 10, False),
            "cfg_eval_b8": (cfg_b8_shapes, 10, False),
            "cond_train": (cond_shapes, 5, True),
            "picard": (picard_shapes, 5, False),
            "cfg_picard": (cfg_picard_shapes, 5, False),
            "search": (search_shapes, 5, False),
            "cfg_search": (cfg_search_shapes, 5, False),
            "cfg_search_pruned": (cfg_pruned_shapes, 5, False),
            "tracked": (tracked_shapes, 5, False),
            "cfg_tracked": (cfg_tracked_shapes, 5, False),
            "flagship": (FLAGSHIP_ATTENTION, 10, True),
            "finetune": (ft_shapes, 1, True),
            "vit_train": (vit_train_shapes, 5, True),
            "vit_eval": (vit_eval_shapes, 5, False),
            "vit_rows2": (vit_rows_shapes, 5, True)}, {
            "flagship_rows": (ft_shapes[0], SP_FLAG_BATCH),
            "cifar_rows": (train_shapes[0], SP_CIFAR_BATCH)}, dev, timer)
        # the attention batches phase 2 held, for phase 15's search runs
        held = {model: {B for _, attn in paths for B, _, _ in attn}
                for model, paths in (
                    ("uncond", (eval_shapes, train_shapes, picard_shapes,
                                search_shapes, tracked_shapes)),
                    ("cfg", (cfg_shapes, cfg_b8_shapes, cond_shapes,
                             cfg_picard_shapes, cfg_search_shapes,
                             cfg_pruned_shapes, cfg_tracked_shapes)))}
        eval_launches = eval_path(
            params, tmpdir, smi_line, len(eval_shapes[0]),
            len(eval_shapes[1]), timer)
        paths = {"eval": eval_launches}
        f32 = [eval_parity(params, tmpdir)]
        bwd = check_backward_kernels({
            "train": (train_shapes, [(8, 256, 128)]),
            # also Picard's CFG fold, where only the forward runs on a
            # path: dk/dv held and timed there beside mma.sync
            "cond_train": (cond_shapes, [(800, 1024, 128)]),
            "grad_search": (([], eval_shapes[1]), []),
            "cfg_grad_search": (([], cfg_shapes[1]), []),
            "flagship": (FLAGSHIP_ATTENTION, []),
            # attention only: the fine-tune's GroupNorm backward (a plain
            # recompute, no kernel) is timed whole in phase 19's profile
            "finetune": (([], ft_shapes[1]), [], 1),
            "vit_train": (vit_train_shapes, []),
            "vit_rows2": (vit_rows_shapes, [])}, dev, timer)
        f32.append(train_parity(tmpdir)[1])
        paths["train"], _ = train_path(tmpdir, smi_line)
        paths["dp_train"], paths["dp_ring_train"] = dp_path(tmpdir,
                                                            smi_line)
        paths.update(spatial_path(
            tmpdir, ((len(ft_shapes[0]), len(ft_shapes[1])),
                     (len(train_shapes[0]), len(train_shapes[1])),
                     (0, len(vit_train_shapes[1]))),
            smi_line))
        f32.append(paths.pop("sp_flagship_ddim_f32"))
        f32.append(paths.pop("sp_vit_ddim_f32"))
        guided, _ = guided_eval_path(cparams, tmpdir, smi_line)
        paths.update(guided)
        f32.append(guided_parity(cparams, tmpdir)[0])
        f32.append(cond_train_parity(cparams, tmpdir)[1])
        fast, _ = fast_sampler_path(params, cparams, tmpdir, smi_line)
        paths.update(fast)
        f32.append(fast_sampler_parity(params, cparams, tmpdir)[1])
        clf, searched, _ = search_path(params, cparams, tmpdir, smi_line,
                                       held)
        paths.update(searched)
        f32.append(search_parity(params, cparams, clf, tmpdir))
        tracked, clip_path = tracked_path(
            os.path.join(tmpdir, "ckpt"), f"ckpt_{TRAIN_EPOCHS - 1}",
            cparams, params, clf, tmpdir, smi_line, timer)
        paths.update(tracked)
        f32.append(tracked_parity(params, clf, clip_path, tmpdir))
        del params, cparams
        paths.update(finetune_path(ft_params, ft_shapes, tmpdir, smi_line))
        del ft_params
        vit, vit_f32 = vit_path(tmpdir, smi_line)
        paths.update(vit)
        f32.append(vit_f32)
        paths["cond_train"] = cond_train_path(tmpdir, smi_line)
    cuda_tests()
    f32_launches = {k: sum(n[k] for n in f32) for k in f32[0]}
    log(smi_line)
    log(json.dumps({"kernels": kernel_json(fwd, bwd, paths, f32_launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
