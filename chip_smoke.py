#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what it computes.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each ending with one line that carries its elapsed seconds:

0. card: the device name and the power limit ``nvidia-smi`` reports;
1. build: the port's kernels, compiled from ``itsd_tpu_torch/csrc`` by one
   nvcc call (its time and the ``-Xptxas -v`` registers and spills);
2. kernels: each CUDA kernel against its plain PyTorch version at every
   shape the main path gives it, in bf16 and f32, timed beside the plain
   version, one PyTorch library call and the least time the card could take;
3. main path: ``runner.evaluate`` at the full width of the CIFAR-10 UNet
   (ch 128, ch_mult 1,2,2,2, attention at 16x16, batch 8, 32x32, bf16,
   T=1000) on seeded weights; the kernels' launch counts must be exactly
   51 and 6 per step and the images finite;
4. path parity: kernel path against plain path, in f32 and in bf16: one
   full-width UNet forward (eps) at timesteps across the chain, and 20
   denoising steps from one x_T with one fed noise sequence.

Then it prints the ``nvidia-smi`` line, one JSON line describing the
kernels, and last ``{"ok": true, "device": {...}}``. Any failure raises:
the script then exits non-zero and prints no result. It also exits non-zero
when there is no CUDA device or no ``itsd_tpu_torch`` beside it.
"""

from __future__ import annotations

import collections
import json
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
    for fn, regs, spill_st, spill_ld in kernels.ptxas:
        log(f"  ptxas {fn}: {regs} registers, spill stores {spill_st} B, "
            f"spill loads {spill_ld} B")
    phase_done(1, "build", t0)


def eval_config(tmpdir: str, dtype: str = "bfloat16"):
    from itsd_tpu_torch.utils import load_config

    return load_config(None, [
        f"channel={WIDTH}", "channel_mult=[1,2,2,2]", "attn=[1]",
        "num_res_blocks=2", "dropout=0.1", f"T={T_STEPS}", "img_size=32",
        f"model.dtype={dtype}", f"train.eval_batch_size={BATCH}", "seed=0",
        f"sampled_dir={tmpdir}"])


def seeded_params(cfg):
    """Seeded weights with the near-zero output layers (residual conv2,
    attention proj, tail conv) scaled up to Xavier size, so that every
    branch moves the output."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models.embeddings import TINY_GAIN

    model, _ = runner.build_model(cfg)
    params = runner.init_params(cfg, model)
    for k, v in params.items():
        if k.endswith(("conv2.weight", "attn.proj.weight",
                       "tail_conv.weight")):
            v.mul_(1.0 / TINY_GAIN)
    return params


def main_path_shapes(cfg, params, dev):
    """The (shape, act) of every GroupNorm call and the [B, N, C] of every
    attention call in one UNet forward, in order."""
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
    x = torch.randn((BATCH, 32, 32, 3), device=dev)
    t = torch.full((BATCH,), 500, device=dev, dtype=torch.int64)
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


def attn_bound_ms(B, N, C, itemsize):
    bytes_ = 4 * B * N * C * itemsize
    flops = 4 * B * N * N * C
    peak = BF16_TENSOR_FLOPS if itemsize == 2 else F32_FLOPS
    return (bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3)


def kernel_entry(name, source, replaces, worst, rows, work):
    """The JSON entry of one kernel: its times summed over one UNet step.
    ``rows``: (calls a step, kernel ms, plain ms, library ms, bytes-bound
    ms, operations-bound ms) per shape."""
    def total(i):
        return sum(r[0] * r[i] for r in rows)

    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=worst, ms=total(1), plain_ms=total(2),
        bound_ms=sum(r[0] * max(r[4], r[5]) for r in rows),
        bound_by="bytes" if total(4) >= total(5) else "operations",
        library_ms=total(3), work=work)


def check_kernels(gn_calls, attn_calls, dev, timer):
    """Phase 2: every kernel against its plain version at every main-path
    shape (bf16 and f32), and timings at the main path's bf16."""
    from itsd_tpu_torch.kernels import attention, groupnorm
    from itsd_tpu_torch.models.unet import _groups

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    # GroupNorm+swish
    counts = collections.Counter(gn_calls)
    worst, rows = 0.0, []
    log("groupnorm_swish: shape [B,C,H,W] act x calls/step | max_abs_err "
        "bf16 f32 | kernel plain library bound ms (bf16) | host us/call")
    log(f"  tolerance: |err| <= atol + rtol*|plain|, bf16 atol "
        f"{GN_TOL[torch.bfloat16][0]} rtol 2^-7, f32 atol "
        f"{GN_TOL[torch.float32][0]}")
    for (shape, act), n in counts.items():
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
            err = (got.float() - want.float()).abs()
            atol, rtol = GN_TOL[dtype]
            over = (err - atol - rtol * want.float().abs()).max().item()
            errs[dtype] = err.max().item()
            if not np.isfinite(errs[dtype]) or over > 0:
                fail(f"groupnorm_swish {shape} act={act} {dtype}: max err "
                     f"{errs[dtype]:.3g} beyond atol {atol} rtol {rtol}")
            worst = max(worst, errs[dtype])
        x = _rand(shape, gen, dev, torch.bfloat16, 0.5, 2.0)
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        lib = ((lambda: F.silu(F.group_norm(x, G, wl, bl, 1e-5))) if act
               else (lambda: F.group_norm(x, G, wl, bl, 1e-5)))
        k_ms, host_us = timer(
            lambda: groupnorm.groupnorm_swish(x, w, b, G, act=act))
        p_ms, _ = timer(
            lambda: groupnorm.groupnorm_swish_plain(x, w, b, G, act=act))
        l_ms, _ = timer(lib)
        by_bytes, by_ops = gn_bound_ms(shape, 2, act)
        log(f"  {list(shape)} act={int(act)} x{n} | "
            f"{errs[torch.bfloat16]:.3g} {errs[torch.float32]:.3g} | "
            f"{k_ms:.5f} {p_ms:.5f} {l_ms:.5f} {max(by_bytes, by_ops):.5f} "
            f"| {host_us:.1f}")
        rows.append((n, k_ms, p_ms, l_ms, by_bytes, by_ops))
    summary["groupnorm_swish"] = kernel_entry(
        "groupnorm_swish", "itsd_tpu_torch/csrc/groupnorm.cu",
        "itsd_tpu/kernels/groupnorm.py:47", worst, rows,
        f"one UNet step: {len(gn_calls)} calls at {len(counts)} shapes, bf16")

    # flash attention
    counts = collections.Counter(attn_calls)
    worst, rows = 0.0, []
    log("flash_attention: [B,N,C] x calls/step | max_abs_err o bf16 f32, lse "
        "| kernel plain sdpa bound ms (bf16) | host us/call")
    log(f"  tolerance: o f32 {ATTN_F32_TOL}; o bf16 2^-7*max|v| + "
        f"2^-7*|plain|; lse {LSE_TOL}")
    for (B, N, C), n in counts.items():
        scale = C ** -0.5
        errs, lse_err = {}, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (_rand((B, N, C), gen, dev, dtype) for _ in range(3))
            o, lse = attention.attention_with_lse(q, k, v, scale)
            o2 = attention.spatial_attention(q, k, v)
            want_o, want_lse = attention.attention_plain_stats(q, k, v,
                                                               scale)
            torch.cuda.synchronize()
            if not torch.equal(o, o2):
                fail(f"flash_attention {(B, N, C)} {dtype}: the lse variant "
                     "and the plain forward disagree")
            err = (o.float() - want_o.float()).abs()
            if dtype == torch.float32:
                atol, rtol = ATTN_F32_TOL, 0.0
            else:
                atol = ATTN_BF16_RTOL * v.float().abs().max().item()
                rtol = ATTN_BF16_RTOL
            over = (err - atol - rtol * want_o.float().abs()).max().item()
            errs[dtype] = err.max().item()
            e_lse = (lse - want_lse).abs().max().item()
            lse_err = max(lse_err, e_lse)
            if not (over <= 0 and e_lse <= LSE_TOL):
                fail(f"flash_attention {(B, N, C)} {dtype}: max err o "
                     f"{errs[dtype]:.3g} (atol {atol:.3g} rtol {rtol:.3g}), "
                     f"lse {e_lse:.3g} (tol {LSE_TOL})")
            worst = max(worst, errs[dtype], e_lse)
        q, k, v = (_rand((B, N, C), gen, dev, torch.bfloat16)
                   for _ in range(3))
        k_ms, host_us = timer(lambda: attention.spatial_attention(q, k, v))
        p_ms, _ = timer(lambda: attention.attention_plain(q, k, v, scale))
        l_ms, _ = timer(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None]))
        by_bytes, by_ops = attn_bound_ms(B, N, C, 2)
        log(f"  {[B, N, C]} x{n} | {errs[torch.bfloat16]:.3g} "
            f"{errs[torch.float32]:.3g}, {lse_err:.3g} | {k_ms:.5f} "
            f"{p_ms:.5f} {l_ms:.5f} {max(by_bytes, by_ops):.5f} | "
            f"{host_us:.1f}")
        rows.append((n, k_ms, p_ms, l_ms, by_bytes, by_ops))
    summary["flash_attention"] = kernel_entry(
        "flash_attention", "itsd_tpu_torch/csrc/flash_attention.cu",
        "itsd_tpu/kernels/attention.py:50", worst, rows,
        f"one UNet step: {len(attn_calls)} calls at {len(counts)} shapes, "
        "bf16")
    phase_done(2, "kernels against their plain versions", t0,
               "(all within tolerance)")
    return summary


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


def main_path(params, tmpdir, card_line, gn_per_step, attn_per_step, timer):
    """Phase 3: runner.evaluate at full width; returns the launch counts."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.kernels import attention, groupnorm

    t0 = time.perf_counter()
    cfg = eval_config(tmpdir)
    groupnorm.launches = 0
    attention.launches = 0
    out = runner.evaluate(cfg, params, device=DEVICE)
    launches = {"groupnorm_swish": groupnorm.launches,
                "flash_attention": attention.launches}
    seconds = time.perf_counter() - t0
    imgs = out["images"]
    want = {"groupnorm_swish": gn_per_step * T_STEPS,
            "flash_attention": attn_per_step * T_STEPS}
    if (gn_per_step, attn_per_step) != (51, 6) or launches != want:
        fail(f"launch counts {launches}, want 51 and 6 per step x {T_STEPS} "
             f"(one forward made {gn_per_step} and {attn_per_step})")
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
    phase_done(3, "main path (runner.evaluate)", t0)
    return launches


def path_parity(params, tmpdir):
    """Phase 4: the kernel path against the plain path, in f32 and bf16:
    one full-width UNet forward (eps) at timesteps spread over the chain,
    then 20 denoising steps from one x_T with one fed noise sequence."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.core import denoise_segment
    from itsd_tpu_torch.kernels import attention, groupnorm
    from itsd_tpu_torch.models import unet

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    x_T = torch.randn((BATCH, 32, 32, 3), generator=gen, device=dev)
    noise = [torch.randn((BATCH, 32, 32, 3), generator=gen, device=dev)
             for _ in range(PARITY_STEPS)]
    t_eps = torch.linspace(0, T_STEPS - 1, BATCH, device=dev).round().long()

    def plain_attention(q, k, v):
        return attention.attention_plain(q, k, v, q.shape[-1] ** -0.5)

    def check(what, name, got, want, tol):
        err = (got - want).abs().max().item()
        ok = np.isfinite(err) and err <= tol
        log(f"path parity {name} {what}: max_abs_err {err:.3g} (tol {tol}), "
            f"max |plain| {want.abs().max().item():.3f} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"path parity {name} {what}: {err:.3g} > {tol}")
        return err

    results = {}
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

        n0 = (groupnorm.launches, attention.launches)
        got_eps, got = run()
        if (groupnorm.launches - n0[0], attention.launches - n0[1]) != (
                51 * (1 + PARITY_STEPS), 6 * (1 + PARITY_STEPS)):
            fail("the kernel path did not launch the kernels")
        n1 = (groupnorm.launches, attention.launches)
        with mock.patch.object(unet, "groupnorm_swish",
                               groupnorm.groupnorm_swish_plain), \
                mock.patch.object(unet, "spatial_attention", plain_attention):
            want_eps, want = run()
        if (groupnorm.launches, attention.launches) != n1:
            fail("the plain path launched a kernel")
        results[name] = (
            check("eps (one forward)", name, got_eps, want_eps,
                  EPS_TOL[dtype]),
            check(f"x ({PARITY_STEPS} steps)", name, got, want,
                  PATH_TOL[dtype]))
    phase_done(4, "path parity", t0)
    return results


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
        gn_calls, attn_calls = main_path_shapes(cfg, params, dev)
        timer = DeviceTimer()
        summary = check_kernels(gn_calls, attn_calls, dev, timer)
        launches = main_path(params, tmpdir, smi_line, len(gn_calls),
                             len(attn_calls), timer)
        path_parity(params, tmpdir)
    for key, n in launches.items():
        summary[key]["launches"] = n
    log(smi_line)
    log(json.dumps({"kernels": list(summary.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
