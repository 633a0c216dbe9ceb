#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it computes.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each ending with one line that carries its elapsed seconds:

0. card: the device name and the power limit ``nvidia-smi`` reports;
1. build: the port's kernels, compiled from ``itsd_tpu_torch/csrc`` by one
   nvcc call (its time and the ``-Xptxas -v`` registers and spills; a
   spill fails the run);
2. forward kernels: GroupNorm+swish and flash attention against their
   plain PyTorch versions at every shape the eval path (batch 8) and the
   train path (batch 128) give them, in bf16 and f32, timed beside the
   plain version, one PyTorch library call and the least time the card
   could take. The flash forward has two kernels: the tensor-core one
   ("mma", the route of bf16 at C=256) and the CUDA-core one ("simt", the
   route of f32); both are checked and timed on the same bf16 inputs.
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
5. backward: the dq and dk/dv kernels (each on both routes, as in phase
   2) against their plain versions at the train path's shapes and one more
   C, in bf16 and f32, with a nonzero dlse once, timed beside the plain
   versions, the backward of ``F.scaled_dot_product_attention`` and their
   bound; every bf16 dq and dk/dv must take the mma route; the GroupNorm
   backward (autograd through the plain recompute) checked and timed;
6. train-step parity: 3 steps of the kernel path against the plain path at
   full width and batch 128 (dropout 0, the same params, batches, t and
   noise), in f32 (simt) and bf16 (mma): loss, pre-clip gradient norm, max
   |dparam|;
7. train path: ``runner.train`` at the configuration of
   ``configs/cifar10_uncond.yaml`` on the shapes dataset (batch 128, lr
   2e-4, dropout 0.1, bf16) for 320 steps; exactly 6/6/6/51 launches a step
   of flash forward / dq / dk-dv / GroupNorm, the forwards, dq and dk/dv all
   on the mma route; a finite, falling loss; the checkpoint restored for one
   more step and for an eval; ms per step, images/s, peak memory and the
   device's busy share (``torch.profiler``);
8. CUDA tests: ``python -m pytest --noconftest -m cuda -q
   tests/test_torch_cuda.py`` in a subprocess, against the library built in
   phase 1; its pass count is printed and a failure fails the run.

Then it prints the ``nvidia-smi`` line, one JSON line describing the
kernels, and last ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result. It also exits non-zero
when there is no CUDA device or no ``itsd_tpu_torch`` beside it.

Launch counts: every count is set to 0 just before a path is driven and
read just after. The bf16 eval and train paths (phases 3 and 7) run the
mma kernels and GroupNorm; the simt kernels are the f32 route, driven
by the float32 kernel path of phases 4 and 6, whose counts their entries
in the kernels' JSON line carry.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (NVIDIA data sheet; dense rates at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

DEVICE = "cuda"
WIDTH = 128
T_STEPS = 1000
BATCH = 8
PARITY_STEPS = 20
TRAIN_BATCH = 128
TRAIN_EPOCHS = 20           # 16 steps an epoch on the 2048 shapes images
TRAIN_SAVE_FREQ = 10
TRAIN_GRID_BATCH = 8        # the epoch grid: T=1000 steps at batch 8
TRAIN_PARITY_STEPS = 3
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
        log(f"nvcc: {kernels.nvcc_seconds:.2f} s, one call, "
            f"{len(_build.sources())} sources -> {kernels.path}")
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


def path_shapes(cfg, params, dev, batch):
    """The (shape, act) of every GroupNorm call and the [B, N, C] of every
    attention call in one UNet forward at ``batch``, in order."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models.unet import AttnBlock, GNAct

    model, _ = runner.build_model(cfg)
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
    x = torch.randn((batch, 32, 32, 3), device=dev)
    t = torch.full((batch,), 500, device=dev, dtype=torch.int64)
    with torch.inference_mode():
        model(x, t)
    torch.cuda.synchronize()
    return gn, attn


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


def check_close(what, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    over = (err - atol - rtol * want.float().abs()).max().item()
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


def check_flash_forward(attn_calls, dev, timer, n):
    """Both flash forward kernels (with and without lse) against their
    plain version at every [B, N, C] of ``attn_calls``: the route's kernel
    in bf16 and f32, and the simt kernel on the bf16 inputs too. Times of
    both kernels at bf16, on the same inputs (the variant with lse where
    ``B`` is the train batch). Returns {kernel: (max error, rows)}."""
    from itsd_tpu_torch.kernels import attention

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"flash_attention_mma": 0.0, "flash_attention_simt": 0.0}
    rows = {"flash_attention_mma": [], "flash_attention_simt": []}
    log("flash_attention: [B,N,C] x calls/step | max_abs_err o: mma bf16, "
        "simt bf16 f32; lse | ms (bf16): mma simt plain sdpa bound | host "
        "us/call mma simt")

    def forward(fn_lse, fn, q, k, v, scale, what):
        o, lse = fn_lse(q, k, v, scale)
        o2 = fn(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.equal(o, o2):
            fail(f"{what}: the lse variant and the plain forward disagree")
        return o, lse

    for (B, N, C), calls in collections.Counter(attn_calls).items():
        scale = C ** -0.5
        if attention.route(torch.bfloat16, C) != "mma":
            fail(f"flash_attention {(B, N, C)}: bf16 does not route to mma")
        errs, lse_err = {}, 0.0
        for dtype, which in ((torch.bfloat16, "mma"),
                             (torch.bfloat16, "simt"),
                             (torch.float32, "simt")):
            what = f"flash_attention {which} {(B, N, C)} {dtype}"
            q, k, v = (_rand((B, N, C), gen, dev, dtype) for _ in range(3))
            n0 = read_launches()
            if dtype == torch.float32 or which == "mma":
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
            if (n1["flash_attention_mma"] - n0["flash_attention_mma"]
                    != (2 if which == "mma" else 0)):
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
        with_lse = B == TRAIN_BATCH
        m_ms, m_host = timer(
            (lambda: attention.attention_with_lse(q, k, v, scale)) if with_lse
            else (lambda: attention.spatial_attention(q, k, v)), n=n)
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
        log(f"  {[B, N, C]} x{calls}{' (with lse)' if with_lse else ''} | "
            f"{errs['mma', torch.bfloat16]:.3g}, "
            f"{errs['simt', torch.bfloat16]:.3g} "
            f"{errs['simt', torch.float32]:.3g}; {lse_err:.3g} | "
            f"{m_ms:.5f} {s_ms:.5f} {p_ms:.5f} {l_ms:.5f} "
            f"{max(by_bytes, by_ops):.5f} | {m_host:.1f} {s_host:.1f}")
        rows["flash_attention_mma"].append((calls, m_ms, p_ms, l_ms, by_bytes,
                                            by_ops))
        rows["flash_attention_simt"].append((calls, s_ms, p_ms, l_ms,
                                             by_bytes, by_ops))
    return {k: (worst[k], rows[k]) for k in rows}


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


def check_forward_kernels(eval_shapes, train_shapes, dev, timer):
    """Phase 2: both forward kernels at the eval path's and the train
    path's shapes. Returns {kernel: {"eval": (err, rows), "train": ...}}."""
    t0 = time.perf_counter()
    log(f"  tolerance GroupNorm: |err| <= atol + rtol*|plain|, bf16 atol "
        f"{GN_TOL[torch.bfloat16][0]} rtol 2^-7, f32 atol "
        f"{GN_TOL[torch.float32][0]}; attention: o f32 {ATTN_F32_TOL}, o bf16 "
        f"2^-7*max|v| + 2^-7*|plain|, lse {LSE_TOL}")
    out = collections.defaultdict(dict)
    for tag, (gn_calls, attn_calls), n in (("eval", eval_shapes, 50),
                                           ("train", train_shapes, 10)):
        log(f"-- shapes of one {tag} step")
        out["groupnorm_swish"][tag] = check_groupnorm(gn_calls, dev, timer, n)
        for name, res in check_flash_forward(attn_calls, dev, timer,
                                             n).items():
            out[name][tag] = res
    out["groupnorm_swish"]["flagship"] = check_flagship_groupnorm(dev, timer)
    phase_done(2, "forward kernels against their plain versions", t0,
               "(all within tolerance)")
    return out


def check_backward_kernels(attn_calls, gn_calls, dev, timer):
    """Phase 5: the dq and dk/dv kernels against their plain versions at
    the train path's attention shapes and [8, 256, 128], in bf16 and f32
    (with a random dO, and a nonzero dlse at the first shape), and the simt
    dq and dk/dv kernels on the bf16 inputs too; times at bf16 of both
    kernels of each on the same inputs, beside the plain versions, the
    backward of SDPA and the bound. Then the GroupNorm backward at the
    train path's shapes."""
    from itsd_tpu_torch.kernels import attention, groupnorm
    from itsd_tpu_torch.models.unet import _groups

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    counts = collections.Counter(attn_calls)
    shapes = list(counts) + [(8, 256, 128)]
    worst = {"flash_bwd_dq_mma": 0.0, "flash_bwd_dq_simt": 0.0,
             "flash_bwd_dkv_mma": 0.0, "flash_bwd_dkv_simt": 0.0}
    rows = {k: [] for k in worst}
    log("flash backward: [B,N,C] x calls/step | max_abs_err dq dk dv bf16 "
        "(mma), dq dk dv bf16 simt, dq dk dv f32 (simt) | ms (bf16): dq mma "
        "simt plain bound, dkv mma simt plain bound | sdpa bwd ms | host "
        "us/call dq mma simt, dkv mma simt")
    log(f"  tolerance: f32 {BWD_F32_TOL}; bf16 2^-7*max|plain| + "
        f"2^-7*|plain|")

    def check_grads(what, got, want, dtype):
        e = []
        for name, g, w in zip(("dq", "dk", "dv")[3 - len(got):], got, want):
            if dtype == torch.float32:
                atol, rtol = BWD_F32_TOL, 0.0
            else:
                atol = BWD_BF16_RTOL * w.float().abs().max().item()
                rtol = BWD_BF16_RTOL
            e.append(check_close(f"{what} {name}", g, w, atol, rtol))
        return e

    for i, (B, N, C) in enumerate(shapes):
        scale = C ** -0.5
        if attention.route(torch.bfloat16, C) != "mma":
            fail(f"flash backward {(B, N, C)}: bf16 does not route to mma")
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            what = f"flash backward {(B, N, C)} {dtype}"
            q, k, v, do = (_rand((B, N, C), gen, dev, dtype)
                           for _ in range(4))
            o, lse = attention.attention_with_lse(q, k, v, scale)
            dlse = (torch.randn((B, N), generator=gen, device=dev)
                    if i == 0 else None)
            n0 = read_launches()
            got = attention.attention_bwd(q, k, v, o, lse, do, scale, dlse)
            n1 = read_launches()
            want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale,
                                                 dlse)
            torch.cuda.synchronize()
            which = "mma" if dtype == torch.bfloat16 else "simt"
            for fn in ("flash_bwd_dq", "flash_bwd_dkv"):
                if (n1[f"{fn}_{which}"] - n0[f"{fn}_{which}"] != 1
                        or n1[fn] - n0[fn] != 1):
                    fail(f"{what}: {fn} not on the {which} route")
            e = check_grads(f"{what} dlse={dlse is not None}", got, want,
                            dtype)
            errs[dtype] = e
            worst[f"flash_bwd_dq_{which}"] = max(
                worst[f"flash_bwd_dq_{which}"], e[0])
            worst[f"flash_bwd_dkv_{which}"] = max(
                worst[f"flash_bwd_dkv_{which}"], *e[1:])
            if dtype == torch.bfloat16:  # the simt kernels, same inputs
                dd = attention.row_dd(o, do, dlse).contiguous()
                got = (attention._flash_bwd_dq_simt(q, k, v, do, lse, dd,
                                                    scale),
                       *attention._flash_bwd_dkv_simt(q, k, v, do, lse, dd,
                                                      scale))
                torch.cuda.synchronize()
                errs["simt"] = check_grads(f"{what} simt", got, want, dtype)
                worst["flash_bwd_dq_simt"] = max(worst["flash_bwd_dq_simt"],
                                                 errs["simt"][0])
                worst["flash_bwd_dkv_simt"] = max(
                    worst["flash_bwd_dkv_simt"], *errs["simt"][1:])
        q, k, v, do = (_rand((B, N, C), gen, dev, torch.bfloat16)
                       for _ in range(4))
        o, lse = attention.attention_with_lse(q, k, v, scale)
        dd = attention.row_dd(o, do).contiguous()
        args = (q, k, v, do, lse, dd, scale)
        n = 10
        dq_ms, dq_host = timer(lambda: attention.flash_bwd_dq(*args), n=n)
        dq_simt_ms, dq_simt_host = timer(
            lambda: attention._flash_bwd_dq_simt(*args), n=n)
        dkv_ms, dkv_host = timer(lambda: attention.flash_bwd_dkv(*args), n=n)
        simt_ms, simt_host = timer(
            lambda: attention._flash_bwd_dkv_simt(*args), n=n)
        dq_plain, _ = timer(lambda: attention.flash_bwd_dq_plain(*args), n=n)
        dkv_plain, _ = timer(lambda: attention.flash_bwd_dkv_plain(*args),
                             n=n)
        qs, ks, vs = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        sdpa_ms, _ = timer(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do[:, None], retain_graph=True), n=n)
        b_dq = attn_bound_ms(B, N, C, 2, tensors=5, products=3)
        b_dkv = attn_bound_ms(B, N, C, 2, tensors=6, products=4)
        calls = counts.get((B, N, C), 0)
        log(f"  {[B, N, C]} x{calls} | "
            f"{' '.join(f'{x:.3g}' for x in errs[torch.bfloat16])}, "
            f"{' '.join(f'{x:.3g}' for x in errs['simt'])}, "
            f"{' '.join(f'{x:.3g}' for x in errs[torch.float32])} | "
            f"dq {dq_ms:.5f} {dq_simt_ms:.5f} {dq_plain:.5f} "
            f"{max(b_dq):.5f}, dkv {dkv_ms:.5f} {simt_ms:.5f} "
            f"{dkv_plain:.5f} {max(b_dkv):.5f} | {sdpa_ms:.5f} | "
            f"{dq_host:.1f} {dq_simt_host:.1f}, {dkv_host:.1f} "
            f"{simt_host:.1f}")
        if calls:
            rows["flash_bwd_dq_mma"].append((calls, dq_ms, dq_plain, sdpa_ms,
                                             *b_dq))
            rows["flash_bwd_dq_simt"].append((calls, dq_simt_ms, dq_plain,
                                              sdpa_ms, *b_dq))
            rows["flash_bwd_dkv_mma"].append((calls, dkv_ms, dkv_plain,
                                              sdpa_ms, *b_dkv))
            rows["flash_bwd_dkv_simt"].append((calls, simt_ms, dkv_plain,
                                               sdpa_ms, *b_dkv))

    # GroupNorm backward: the kernel path's autograd.Function (kernel
    # forward, plain recompute in the backward) against autograd of the
    # plain version, and its time beside F.group_norm's autograd.
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
    log(f"groupnorm fwd+bwd, one train step ({len(gn_calls)} calls): kernel "
        f"path {gn_ms:.3f} ms, F.group_norm(+silu) autograd {gn_lib_ms:.3f} "
        "ms")
    phase_done(5, "backward kernels against their plain versions", t0,
               "(all within tolerance)")
    return {k: (worst[k], rows[k]) for k in rows}


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
    attention.dq_launches = attention.dq_mma_launches = 0
    attention.dkv_launches = attention.dkv_mma_launches = 0


def read_launches() -> dict:
    """Launches so far: the totals of each function (both routes) and, for
    the flash forward, dq and dk/dv, of each route's kernel."""
    from itsd_tpu_torch.kernels import attention, groupnorm

    return {"groupnorm_swish": groupnorm.launches,
            "flash_attention": attention.launches,
            "flash_attention_mma": attention.mma_launches,
            "flash_attention_simt": attention.launches
            - attention.mma_launches,
            "flash_bwd_dq": attention.dq_launches,
            "flash_bwd_dq_mma": attention.dq_mma_launches,
            "flash_bwd_dq_simt": attention.dq_launches
            - attention.dq_mma_launches,
            "flash_bwd_dkv": attention.dkv_launches,
            "flash_bwd_dkv_mma": attention.dkv_mma_launches,
            "flash_bwd_dkv_simt": attention.dkv_launches
            - attention.dkv_mma_launches}


def per_route(totals: dict, mma: bool) -> dict:
    """The launch counts ``read_launches`` gives when every flash forward,
    dq and dk/dv of ``totals`` (function -> count) took the mma route (or,
    with ``mma`` False, the simt route)."""
    out = dict(totals)
    for fn in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"):
        n = totals.get(fn, 0)
        out[fn + "_mma"], out[fn + "_simt"] = (n, 0) if mma else (0, n)
    return out


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
    want = per_route({"groupnorm_swish": gn_per_step * T_STEPS,
                      "flash_attention": attn_per_step * T_STEPS,
                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, mma=True)
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
        want_n = per_route({
            "groupnorm_swish": 51 * (1 + PARITY_STEPS),
            "flash_attention": 6 * (1 + PARITY_STEPS), "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}, mma=dtype == torch.bfloat16)
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
        if per != per_route({"groupnorm_swish": 51, "flash_attention": 6,
                             "flash_bwd_dq": 6, "flash_bwd_dkv": 6},
                            mma=dtype == torch.bfloat16):
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
            ("flash_fwd simt (ours)", ("flash_fwd_kernel",)),
            ("flash_bwd_dq mma (ours)", ("flash_bwd_dq_mma_kernel",)),
            ("flash_bwd_dq simt (ours)", ("flash_bwd_dq_kernel",)),
            ("flash_bwd_dkv mma (ours)", ("flash_bwd_dkv_mma_kernel",)),
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
    grid_launches = per_route({"groupnorm_swish": 51 * grid_steps,
                               "flash_attention": 6 * grid_steps}, mma=True)
    per_step = {k: (n - grid_launches.get(k, 0)) / steps
                for k, n in launches.items()}
    log(f"train: {steps} steps of batch {TRAIN_BATCH} in {seconds:.2f} s "
        f"(dataset, checkpoints and {grids} sample grid(s) of T={T_STEPS} at "
        f"batch {TRAIN_GRID_BATCH} included); launches {launches}; per train "
        f"step {per_step}")
    if per_step != per_route({"flash_attention": 6, "flash_bwd_dq": 6,
                              "flash_bwd_dkv": 6, "groupnorm_swish": 51},
                             mma=True):
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


def kernel_json(fwd, bwd, eval_launches, train_launches, per_step,
                f32_launches):
    """The kernels' JSON entries, each route's kernel an entry of its own:
    times summed over one train step at bf16 (the path that runs every
    function), the forward kernels' eval-step times beside them. The mma
    kernels and GroupNorm carry their launches on the bf16 train path
    (``runner.train``, its T=1000 sample grid included); the simt kernels,
    the f32 route, carry theirs on the float32 kernel path of phases 4 and
    6 (20 eval steps and one forward, 3 train steps)."""
    meta = {
        "groupnorm_swish": ("itsd_tpu_torch/csrc/groupnorm.cu",
                            "itsd_tpu/kernels/groupnorm.py:47"),
        "flash_attention_mma": ("itsd_tpu_torch/csrc/flash_attention_mma.cu",
                                "itsd_tpu/kernels/attention.py:50"),
        "flash_attention_simt": ("itsd_tpu_torch/csrc/flash_attention.cu",
                                 "itsd_tpu/kernels/attention.py:50"),
        "flash_bwd_dq_mma": (
            "itsd_tpu_torch/csrc/flash_attention_bwd_dq_mma.cu",
            "itsd_tpu/kernels/attention.py:229"),
        "flash_bwd_dq_simt": ("itsd_tpu_torch/csrc/flash_attention_bwd.cu",
                              "itsd_tpu/kernels/attention.py:229"),
        "flash_bwd_dkv_mma": ("itsd_tpu_torch/csrc/flash_attention_bwd_mma.cu",
                              "itsd_tpu/kernels/attention.py:260"),
        "flash_bwd_dkv_simt": ("itsd_tpu_torch/csrc/flash_attention_bwd.cu",
                               "itsd_tpu/kernels/attention.py:260"),
    }
    entries = []
    for name, (source, replaces) in meta.items():
        if name in fwd:
            err = max(res[0] for res in fwd[name].values())
            rows = fwd[name]["train"][1]
        else:
            err, rows = bwd[name]
        simt = name.endswith("_simt")
        launches = (f32_launches if simt else train_launches)[name]
        if not launches:
            fail(f"{name} was not launched on its path")
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=launches,
                     max_abs_err=err, **rows_entry(rows))
        entry["launches_on"] = (
            "float32 kernel path, phases 4 and 6" if simt
            else "bf16 train path, runner.train (phase 7)")
        if not simt:
            entry["launches_per_train_step"] = per_step[name]
            entry["launches_by_path"] = {"eval": eval_launches[name],
                                         "train": train_launches[name]}
        entry["work"] = "one train step (batch 128, bf16)"
        if "flagship" in fwd.get(name, {}):
            entry["flagship_batch1"] = rows_entry(fwd[name]["flagship"][1])
        if name in fwd:
            entry["eval_step"] = rows_entry(fwd[name]["eval"][1])
        else:
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
        eval_shapes = path_shapes(cfg, params, dev, BATCH)
        train_shapes = path_shapes(cfg, params, dev, TRAIN_BATCH)
        timer = DeviceTimer()
        fwd = check_forward_kernels(eval_shapes, train_shapes, dev, timer)
        eval_launches = eval_path(params, tmpdir, smi_line,
                                  len(eval_shapes[0]), len(eval_shapes[1]),
                                  timer)
        f32_eval = eval_parity(params, tmpdir)
        bwd = check_backward_kernels(train_shapes[1], train_shapes[0], dev,
                                     timer)
        _, f32_train = train_parity(tmpdir)
        train_launches, per_step = train_path(tmpdir, smi_line)
    cuda_tests()
    f32_launches = {k: f32_eval[k] + f32_train[k] for k in f32_eval}
    log(smi_line)
    log(json.dumps({"kernels": kernel_json(fwd, bwd, eval_launches,
                                           train_launches, per_step,
                                           f32_launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
