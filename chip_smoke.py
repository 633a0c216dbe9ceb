#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it computes.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each ending with one line that carries its elapsed seconds:

0. card: the device name and the power limit ``nvidia-smi`` reports;
1. build: the port's kernels, compiled from ``itsd_tpu_torch/csrc`` by one
   nvcc per source, all started together, and a link (its time and the
   ``-Xptxas -v`` registers and spills; a spill fails the run);
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
   the tensor-core one at every shape. The flash forward also at the
   256x256 flagship's attention, [1, 4096, 384] (bf16: wide).
   GroupNorm also at the 256x256 flagship's largest spans (batch 1, spans
   of up to 786,432 elements, split over a thread-block cluster): forward
   and backward in f32 and bf16, two launches equal bit for bit, timed;
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
   the flagship's C=384) against their plain versions at both train
   paths' shapes, one more C and the flagship's [1, 4096, 384], in bf16
   and f32, with a nonzero dlse once, timed beside the plain versions, the
   backward of ``F.scaled_dot_product_attention`` and their bound; every
   dq and dk/dv must take the route ``route`` names; the GroupNorm
   backward (autograd through the plain recompute) checked and timed;
6. train-step parity: 3 steps of the kernel path against the plain path at
   full width and batch 128 (dropout 0, the same params, batches, t and
   noise), in f32 (simt) and bf16 (mma): loss, pre-clip gradient norm, max
   |dparam|;
7. train path: ``runner.train`` at the configuration of
   ``configs/cifar10_uncond.yaml`` on the shapes dataset (batch 128, lr
   2e-4, dropout 0.1, bf16) for 160 steps; exactly 6/6/6/51 launches a step
   of flash forward / dq / dk-dv / GroupNorm, the forwards, dq and dk/dv all
   on the mma route; a finite, falling loss; the checkpoint restored for one
   more step and for an eval; ms per step, images/s, peak memory and the
   device's busy share (``torch.profiler``);
8. CUDA tests: ``python -m pytest --noconftest -m cuda -q
   tests/test_torch_cuda.py`` in a subprocess, against the library built in
   phase 1; its pass count is printed and a failure fails the run (it runs
   after phase 12);
9. guided eval path: ``runner.evaluate`` of the conditional UNet at the
   full width of ``configs/cifar10_cfg.yaml`` (ch 128, ch_mult
   1,4,8,8,4,2, 548 M parameters, bf16) on seeded weights, batch 8: CFG
   w=1.8 over the config's whole T=3000 chain, CFG on 30 <= t < 70 and
   autoguidance (a second seeded weight file) over a chain cut to T=100;
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
    (batch 256, bf16, no tracked metrics or representation extraction) for
    200 steps; exactly 78/13/13/13 launches a step (the forward, dq and
    dk/dv each 5 on mma, 8 on wide and none on simt); a finite, falling
    loss; the checkpoint restored
    for one more step and, through the eval loader, for 100 guided steps
    of its T=3000 chain; ms per step, images/s, peak memory and the
    device's busy share.

Then it prints the ``nvidia-smi`` line, one JSON line describing the
kernels, and last ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result. It also exits non-zero
when there is no CUDA device or no ``itsd_tpu_torch`` beside it.

Launch counts: every count is set to 0 just before a path is driven and
read just after. The bf16 eval and train paths of the unconditional UNet
(phases 3 and 7) run the mma kernels and GroupNorm; those of the CFG UNet
(phases 9 and 12) the mma and wide kernels. The kernels' JSON line carries
each kernel's launches summed over these paths, and per path; the simt
forward, dq and dk/dv, which no bf16 path runs, carry their launches on
the f32 kernel paths of phases 4, 6, 10 and 11.
"""

from __future__ import annotations

import collections
import contextlib
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
TRAIN_EPOCHS = 10           # 16 steps an epoch on the 2048 shapes images
TRAIN_SAVE_FREQ = 5
TRAIN_GRID_BATCH = 8        # the epoch grid: T=1000 steps at batch 8
TRAIN_PARITY_STEPS = 3
# The guided path (configs/cifar10_cfg.yaml). One forward of its UNet makes
# 78 GroupNorm calls and 13 attention calls, all on the tensor cores in
# bf16: 5 on the mma route (C=128 at 32x32, C=256 at 1x1) and 8 on the wide
# route (C=512 at 16x16 and 2x2, C=1024 at 8x8 and 4x4). A train step's dq
# and dk/dv take the same routes.
CFG_PER_FORWARD = (78, 13, 5, 8)
CFG_BATCH = 8               # train.eval_batch_size of the guided evals
CFG_SHORT_T = 100           # the interval-CFG and autoguidance chains
CFG_INTERVAL = (30, 70)     # 40 of their 100 steps guided
COND_TRAIN_EPOCHS = 25      # 8 steps an epoch: 2048 shapes images, batch 256
COND_PARITY_BATCH = 128
COND_LOSS_FALL = 0.5        # the last epoch's mean loss below this share
                            # of the first epoch's (measured: 0.04)
RESTORED_EVAL_STEPS = 100   # guided steps from the restored checkpoint
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

    def __call__(self, fn, n: int = 50, warmup: int = 3, reps: int = 3):
        """(device ms per call, host us to launch one call: median)."""
        for _ in range(warmup):
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
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
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
    phase_done(1, "build", t0, "(no spills)" if kernels.built else "")


def eval_config(tmpdir: str, dtype: str = "bfloat16"):
    from itsd_tpu_torch.utils import load_config

    return load_config(None, [
        f"channel={WIDTH}", "channel_mult=[1,2,2,2]", "attn=[1]",
        "num_res_blocks=2", "dropout=0.1", f"T={T_STEPS}", "img_size=32",
        f"model.dtype={dtype}", f"train.eval_batch_size={BATCH}", "seed=0",
        f"sampled_dir={tmpdir}"])


def train_config(tmpdir: str, dtype: str = "bfloat16", *extra):
    """configs/cifar10_uncond.yaml's model and train settings on the shapes
    dataset (the repository's stand-in for CIFAR-10)."""
    from itsd_tpu_torch.utils import load_config

    return load_config(None, [
        f"channel={WIDTH}", "channel_mult=[1,2,2,2]", "attn=[1]",
        "num_res_blocks=2", "dropout=0.1", f"T={T_STEPS}", "img_size=32",
        f"model.dtype={dtype}", f"batch_size={TRAIN_BATCH}", "lr=2e-4",
        "data.dataset=shapes", "train.track_metrics=false", "seed=0",
        f"train.epoch={TRAIN_EPOCHS}",
        f"train.model_save_freq={TRAIN_SAVE_FREQ}",
        f"train.eval_freq={TRAIN_EPOCHS}",
        f"train.eval_batch_size={TRAIN_GRID_BATCH}",
        f"save_weight_dir={tmpdir}/ckpt", f"sampled_dir={tmpdir}/sampled",
        f"metrics_save_dir={tmpdir}/metrics", *extra])


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
    for batch in batches:
        x = torch.randn((batch, 32, 32, 3), device=dev)
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


def check_flash_forward(attn_calls, dev, timer, n, with_lse):
    """The flash forward kernels (with and without lse) against their plain
    version at every [B, N, C] of ``attn_calls``: the route's kernel in
    bf16 (mma or wide) and in f32 (simt), and the simt kernel on the bf16
    inputs too. Times at bf16 of the route's kernel and of the simt kernel
    on the same inputs (the variant with lse when ``with_lse``, as on a
    train path). Rows: the route's kernel at each shape, and the simt
    kernel's forced calls where bf16 takes wide (the calls bf16 sent to
    simt before the wide kernels). Returns {kernel: (max error, rows)}."""
    from itsd_tpu_torch.kernels import attention

    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("flash_attention_mma", "flash_attention_wide",
             "flash_attention_simt")
    worst = dict.fromkeys(names, 0.0)
    rows = {k: [] for k in names}
    log("flash_attention: [B,N,C] x calls/step route | max_abs_err o: route "
        "bf16, simt bf16 f32; lse | ms (bf16): route simt plain sdpa bound | "
        "host us/call route simt")

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
                o, lse = forward(
                    lambda *a: attention._flash_simt(*a, emit_lse=True),
                    lambda *a: attention._flash_simt(*a, emit_lse=False),
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
        r_ms = r_host = nan
        if bf16_route != "simt":
            r_ms, r_host = timer(
                (lambda: attention.attention_with_lse(q, k, v, scale))
                if with_lse else (lambda: attention.spatial_attention(q, k,
                                                                      v)),
                n=n)
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
            f"{errs['simt', torch.float32]:.3g}; {lse_err:.3g} | "
            f"{r_ms:.5f} {s_ms:.5f} {p_ms:.5f} {l_ms:.5f} "
            f"{max(by_bytes, by_ops):.5f} | {r_host:.1f} {s_host:.1f}")
        rows[f"flash_attention_{bf16_route}"].append(
            (calls, r_ms if bf16_route != "simt" else s_ms, p_ms, l_ms,
             by_bytes, by_ops))
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


def check_forward_kernels(paths, dev, timer):
    """Phase 2: both forward kernels at the shapes of each path of
    ``paths`` (tag -> ((gn_calls, attn_calls), timing reps, with lse)).
    Returns {kernel: {tag: (err, rows)}}."""
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
    phase_done(2, "forward kernels against their plain versions", t0,
               "(all within tolerance)")
    return out


def check_backward_kernels(paths, dev, timer):
    """Phase 5: the dq and dk/dv kernels against their plain versions at
    the attention shapes of each train path of ``paths`` (tag ->
    ((gn_calls, attn_calls), more shapes)), in bf16 and f32 (with a random
    dO, and a nonzero dlse at a path's first shape), and, where bf16 routes
    either to a tensor-core kernel, the simt dq and dk/dv kernels on the
    bf16 inputs too; times at bf16 of the route's kernels and the simt
    ones, on the same inputs, beside the plain versions, the backward of
    SDPA and the bound (rows: the route's kernels, and the simt dq's and
    dk/dv's forced calls where bf16 takes wide). Then the GroupNorm
    backward at each path's shapes. Returns {kernel: {tag: (max error,
    rows)}}."""
    from itsd_tpu_torch.kernels import attention

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    kernels = ("flash_bwd_dq_mma", "flash_bwd_dq_wide", "flash_bwd_dq_simt",
               "flash_bwd_dkv_mma", "flash_bwd_dkv_wide",
               "flash_bwd_dkv_simt")
    out = {k: {} for k in kernels}
    log("flash backward: [B,N,C] x calls/step routes | max_abs_err dq dk dv "
        "bf16 (routes), dq dk dv bf16 simt, dq dk dv f32 (simt) | ms (bf16): "
        "dq route simt plain bound, dkv route simt plain bound | sdpa bwd ms "
        "| host us/call dq route simt, dkv route simt")
    log(f"  tolerance: f32 {BWD_F32_TOL}; bf16 2^-7*max|plain| + "
        f"2^-7*|plain| + the f32 summation-order bound of dq and dk")

    def check_grads(what, got, want, dtype, bounds):
        e = []
        for name, g, w, bound in zip(("dq", "dk", "dv"), got, want, bounds):
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
    for tag, ((gn_calls, attn_calls), more) in paths.items():
        log(f"-- shapes of one {tag} step")
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
            if bf16_routes == ("simt", "simt"):
                errs["simt"] = errs[torch.bfloat16]
            q, k, v, do = (_rand((B, N, C), gen, dev, torch.bfloat16)
                           for _ in range(4))
            o, lse = attention.attention_with_lse(q, k, v, scale)
            dd = attention.row_dd(o, do).contiguous()
            args = (q, k, v, do, lse, dd, scale)
            n = 10
            dq_ms, dq_host = (timer(lambda: attention.flash_bwd_dq(*args),
                                    n=n)
                              if bf16_routes[0] != "simt" else nan)
            dq_simt_ms, dq_simt_host = timer(
                lambda: attention._flash_bwd_dq_simt(*args), n=n)
            dkv_ms, dkv_host = (timer(lambda: attention.flash_bwd_dkv(*args),
                                      n=n)
                                if bf16_routes[1] != "simt" else nan)
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
                f"{' '.join(f'{x:.3g}' for x in errs[torch.float32])} | "
                f"dq {dq_ms:.5f} {dq_simt_ms:.5f} {dq_plain:.5f} "
                f"{max(b_dq):.5f}, dkv {dkv_ms:.5f} {simt_ms:.5f} "
                f"{dkv_plain:.5f} {max(b_dkv):.5f} | {sdpa_ms:.5f} | "
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
            if dq_route == "wide":
                rows["flash_bwd_dq_simt"].append(
                    (calls, dq_simt_ms, dq_plain, sdpa_ms, *b_dq))
            if dkv_route == "wide":
                rows["flash_bwd_dkv_simt"].append(
                    (calls, simt_ms, dkv_plain, sdpa_ms, *b_dkv))
        for k in kernels:
            out[k][tag] = (worst[k], rows[k])
        if gn_calls:
            check_groupnorm_backward(tag, gn_calls, gen, dev, timer)
    phase_done(5, "backward kernels against their plain versions", t0,
               "(all within tolerance)")
    return out


def check_groupnorm_backward(tag, gn_calls, gen, dev, timer):
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
            n=5)

        def lib():
            y = F.group_norm(x, G, w.to(x.dtype), b.to(x.dtype), 1e-5)
            return torch.autograd.grad(F.silu(y) if act else y, (x, w, b),
                                       gy)

        l_ms, _ = timer(lib, n=5)
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
    attention.launches = attention.mma_launches = 0
    attention.wide_launches = 0
    attention.dq_launches = attention.dq_mma_launches = 0
    attention.dq_wide_launches = 0
    attention.dkv_launches = attention.dkv_mma_launches = 0
    attention.dkv_wide_launches = 0


def read_launches() -> dict:
    """Launches so far: the totals of each function (every route) and, for
    the flash forward, dq and dk/dv, of each route's kernel."""
    from itsd_tpu_torch.kernels import attention, groupnorm

    a = attention
    return route_counts(
        gn=groupnorm.launches, fwd=a.launches, fwd_mma=a.mma_launches,
        fwd_wide=a.wide_launches, dq=a.dq_launches,
        dq_mma=a.dq_mma_launches, dq_wide=a.dq_wide_launches,
        dkv=a.dkv_launches, dkv_mma=a.dkv_mma_launches,
        dkv_wide=a.dkv_wide_launches)


def route_counts(gn=0, fwd=0, fwd_mma=0, fwd_wide=0, dq=0, dq_mma=0,
                 dq_wide=0, dkv=0, dkv_mma=0, dkv_wide=0):
    """Launch counts in the layout of ``read_launches``: each function's
    total and each route's kernel (simt: what the others leave)."""
    return {"groupnorm_swish": gn, "flash_attention": fwd,
            "flash_attention_mma": fwd_mma,
            "flash_attention_wide": fwd_wide,
            "flash_attention_simt": fwd - fwd_mma - fwd_wide,
            "flash_bwd_dq": dq, "flash_bwd_dq_mma": dq_mma,
            "flash_bwd_dq_wide": dq_wide,
            "flash_bwd_dq_simt": dq - dq_mma - dq_wide,
            "flash_bwd_dkv": dkv,
            "flash_bwd_dkv_mma": dkv_mma, "flash_bwd_dkv_wide": dkv_wide,
            "flash_bwd_dkv_simt": dkv - dkv_mma - dkv_wide}


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

    def plain_attention(q, k, v):
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
            ("flash_fwd mma (ours)", ("flash_fwd_mma_kernel",)),
            ("flash_fwd wide (ours)", ("flash_fwd_wide_kernel",)),
            ("flash_fwd simt (ours)", ("flash_fwd_kernel",)),
            ("flash_bwd_dq mma (ours)", ("flash_bwd_dq_mma_kernel",)),
            ("flash_bwd_dq wide (ours)", ("flash_bwd_dq_wide_kernel",)),
            ("flash_bwd_dq simt (ours)", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv mma (ours)", ("flash_bwd_dkv_mma_kernel",)),
            ("flash_bwd_dkv wide (ours)", ("flash_bwd_dkv_wide_kernel",)),
            ("flash_bwd_dkv simt (ours)", ("flash_bwd_dkv_kernel",)),
            ("groupnorm (ours)", ("groupnorm_swish_kernel",)),
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
    cfg = train_config(tmpdir)
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
    grid_steps = grids * T_STEPS  # each grid: T=1000 sampler steps
    grid_launches = route_counts(gn=51 * grid_steps, fwd=6 * grid_steps,
                                 fwd_mma=6 * grid_steps)
    per_step = {k: (n - grid_launches[k]) / steps
                for k, n in launches.items()}
    log(f"train: {steps} steps of batch {TRAIN_BATCH} in {seconds:.2f} s "
        f"(dataset, checkpoints and {grids} sample grid(s) of T={T_STEPS} at "
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
# the guided path: configs/cifar10_cfg.yaml


def cfg_config(tmpdir: str, dtype: str = "bfloat16", *extra):
    """configs/cifar10_cfg.yaml (ch 128, ch_mult 1,4,8,8,4,2, 10 labels,
    table time embedding, T=3000, w=1.8, batch 256, lr 5e-5, sum/B^2 loss)
    in ``dtype``, on the shapes dataset (the repository's stand-in for
    CIFAR-10) with its 10 labels, no tracked metrics and no representation
    extraction (neither is ported), guided evals at batch 8."""
    from itsd_tpu_torch.utils import load_config

    return load_config(CFG_YAML, [
        f"model.dtype={dtype}", "seed=0", "data.dataset=shapes",
        "train.track_metrics=false", "train.extract_representation_freq=0",
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
    debug mode reports (the sampler promises none: the host never waits on
    the device within a step)."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models import unet

    batches, seconds, syncs = [], [], []
    attention_fn, sampler_fn = unet.spatial_attention, runner.run_sampler

    def attention(q, k, v):
        batches.append(q.shape[0])
        return attention_fn(q, k, v)

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
    by w=1.8: CFG over the whole T=3000 chain; CFG restricted to the
    interval CFG_INTERVAL; autoguidance against a second seeded weight
    file. The last two run a chain of CFG_SHORT_T steps (diffusion.T
    overridden, the time table cut to its first rows), to stay inside the
    script's time limit. Every guided eval clips the implied x_0 at each
    step (diffusion.clip_denoised), as long extrapolative-CFG chains need:
    on random weights the unclipped chain grows by ~1/sqrt(alpha_bar_T),
    ~1e9 at T=3000. Returns {run: launches}, {run: result}."""
    from itsd_tpu_torch.cli import runner

    t0 = time.perf_counter()
    gn, fwd, mma, wide = CFG_PER_FORWARD
    one = route_counts(gn=gn, fwd=fwd, fwd_mma=mma, fwd_wide=wide)
    launches, results = {}, {}
    B = CFG_BATCH

    cfg = cfg_config(tmpdir, "bfloat16", "diffusion.clip_denoised=true")
    T = cfg.diffusion.T
    launches["cfg_eval"], results["cfg_eval"] = guided_eval(
        f"CFG w={cfg.diffusion.w}", cfg, cparams, [(T, one)],
        {2 * B: fwd * T}, card_line)

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
    per_step = {k: n / steps for k, n in launches.items()}
    gn, fwd, mma, wide = CFG_PER_FORWARD
    log(f"cond train: {steps} steps of batch {B} in {seconds:.2f} s "
        f"(dataset, model set-up and checkpoint included); launches "
        f"{launches}; per step {per_step}")
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
    log(f"cond train step (batch {B}, bf16) on {card_line}: median "
        f"{step_ms:.2f} ms wall (steps 3-12: "
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
# runner.evaluate and runner.train (phases 3, 7, 9 and 12).
MAIN_PATHS = ("eval", "train", "cfg_eval", "cfg_interval_eval", "auto_eval",
              "cond_train")
WORK = {"train": "one train step of configs/cifar10_uncond.yaml (batch 128, "
                 "bf16)",
        "cond_train": "one train step of configs/cifar10_cfg.yaml (batch "
                      "256, bf16)"}
# name -> (source, the TPU kernel it replaces, the step its times sum over)
KERNELS = {
    "groupnorm_swish": ("itsd_tpu_torch/csrc/groupnorm.cu",
                        "itsd_tpu/kernels/groupnorm.py:47", "train"),
    "flash_attention_mma": ("itsd_tpu_torch/csrc/flash_attention_mma.cu",
                            "itsd_tpu/kernels/attention.py:50", "train"),
    "flash_attention_wide": ("itsd_tpu_torch/csrc/flash_attention_wide.cu",
                             "itsd_tpu/kernels/attention.py:50",
                             "cond_train"),
    "flash_attention_simt": ("itsd_tpu_torch/csrc/flash_attention.cu",
                             "itsd_tpu/kernels/attention.py:50",
                             "cond_train"),
    "flash_bwd_dq_mma": ("itsd_tpu_torch/csrc/flash_attention_bwd_dq_mma.cu",
                         "itsd_tpu/kernels/attention.py:229", "train"),
    "flash_bwd_dq_wide": ("itsd_tpu_torch/csrc/flash_attention_bwd_dq_wide.cu",
                          "itsd_tpu/kernels/attention.py:229", "cond_train"),
    "flash_bwd_dq_simt": ("itsd_tpu_torch/csrc/flash_attention_bwd.cu",
                          "itsd_tpu/kernels/attention.py:229", "cond_train"),
    "flash_bwd_dkv_mma": ("itsd_tpu_torch/csrc/flash_attention_bwd_mma.cu",
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
    runner.evaluate and runner.train (``launches_by_path``); the simt
    forward, dq and dk/dv, which no bf16 path sends there, count their
    launches on the f32 kernel paths of the parity phases 4, 6, 10 and 11
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
            counted_on = "f32 kernel paths of phases 4, 6, 10 and 11"
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
        if name not in fwd:
            entry["library"] = ("one SDPA backward, which computes dq, dk "
                                "and dv together")
        entries.append(entry)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import itsd_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    name, smi_line = card()
    build()
    with tempfile.TemporaryDirectory(prefix="itsd_chip_smoke_") as tmpdir:
        cfg = eval_config(tmpdir)
        params = seeded_params(cfg)
        eval_shapes, train_shapes = path_shapes(cfg, params, dev,
                                                (BATCH, TRAIN_BATCH))
        ccfg = cfg_config(tmpdir)
        cparams = seeded_params(ccfg)
        cfg_shapes, cfg_b8_shapes, cond_shapes = path_shapes(
            ccfg, cparams, dev,
            (2 * CFG_BATCH, CFG_BATCH, ccfg.train.batch_size))
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
        fwd = check_forward_kernels({
            "eval": (eval_shapes, 50, False),
            "train": (train_shapes, 10, True),
            "cfg_eval": (cfg_shapes, 50, False),
            "cfg_eval_b8": (cfg_b8_shapes, 50, False),
            "cond_train": (cond_shapes, 10, True),
            "flagship": (FLAGSHIP_ATTENTION, 10, True)}, dev, timer)
        paths = {"eval": eval_path(params, tmpdir, smi_line,
                                   len(eval_shapes[0]),
                                   len(eval_shapes[1]), timer)}
        f32 = [eval_parity(params, tmpdir)]
        bwd = check_backward_kernels({
            "train": (train_shapes, [(8, 256, 128)]),
            "cond_train": (cond_shapes, []),
            "flagship": (FLAGSHIP_ATTENTION, [])}, dev, timer)
        f32.append(train_parity(tmpdir)[1])
        paths["train"], _ = train_path(tmpdir, smi_line)
        del params
        guided, _ = guided_eval_path(cparams, tmpdir, smi_line)
        paths.update(guided)
        f32.append(guided_parity(cparams, tmpdir)[0])
        f32.append(cond_train_parity(cparams, tmpdir)[1])
        del cparams
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
