#!/usr/bin/env python3
"""The f32 forward's tensor-core kernel ("tf32x3") on one card, without
the rest of ``chip_smoke.py``:

    python3 chip_tf32x3_probe.py [--check-only] [--tests] [--inference]

Builds the kernels and checks them as ``chip_smoke.py``'s phase 1 does
(ptxas spills; HGMMA and UTMALDG in every Hopper kernel; HMMA with the
TF32 modifier in every tf32x3 kernel), then holds the tf32x3 forward (with
and without lse, two launches bit for bit) and the simt forward it
replaced (a forced call) against the plain version over a sweep of widths
and token counts, at the f32 limits (o and lse within 2e-5). Every failure
is printed, and the run fails at the end if there was one. Unless
``--check-only``, it then times, with ``chip_smoke.py``'s own functions,
the f32 forward at the attention calls of the unconditional and the CFG
UNet's train steps (with lse) and of configs/inference_config.yaml's
forward at batch 64 (without): the tf32x3 kernel in turns with the simt
one, the plain version, SDPA in f32, the 3xTF32 and the f32 bounds; it
prints each tag's sums and, last, one JSON line of them. ``--tests`` also
runs the CUDA tests ``-k tf32x3``. ``--inference`` (after the sweep, with
``--check-only`` too) takes configs/inference_config.yaml's model (f32,
seeded weights, batch 64, as ``chip_smoke.py``'s phase 4) through one eps
forward on the plain path, then on the kernels with the attention forward
on each of its kernels (tf32x3; simt, forced; the plain version, beside
the GroupNorm kernel), and prints each one's largest |eps - plain eps|,
and each attention call's error on the plain path's own inputs. Needs a
CUDA device.

Before the sweep it measures the card's mma.sync rate apart from any
kernel of the library: a small source compiled here by nvcc (not part of
the port) runs back-to-back independent m16n8k8 TF32 and m16n8k16 bf16
products at 1, 2, 4 and 8 warps a sub-partition (clocks a product on a
sub-partition, TFLOP/s over 132 SMs), and its SASS shows what
``cvt.rna.tf32.f32`` becomes beside the integer rounding the kernel uses.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
SWEEP = ([(3, N, C) for C in (4, 12, 100, 128, 256, 384, 512, 520, 1020,
                              1024)
          for N in (1, 4, 16, 63, 64, 65, 256)]
         + [(1, 4096, 384), (2, 1024, 512), (256, 16, 1024), (256, 4, 512),
            (300, 7, 384), (133, 2, 64), (1000, 3, 128)])


def sweep(dev) -> list:
    """The tf32x3 and simt forwards at every shape of SWEEP; the
    failures."""
    from itsd_tpu_torch.kernels import attention

    bad = []
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = {"tf32x3": 0.0, "simt": 0.0}
    for B, N, C in SWEEP:
        what = f"[{B}, {N}, {C}]"
        q, k, v = (torch.randn((B, N, C), generator=gen, device=dev)
                   for _ in range(3))
        scale = C ** -0.5
        try:
            want_o, want_lse = attention.attention_plain_stats(q, k, v,
                                                               scale)
            n0 = attention.tf32x3_launches
            o, lse = attention.attention_with_lse(q, k, v, scale)
            o2 = attention.spatial_attention(q, k, v)
            o3 = attention.spatial_attention(q, k, v)
            s_o, s_lse = attention._flash_simt(q, k, v, scale, True)
            torch.cuda.synchronize()
            if attention.tf32x3_launches - n0 != 3:
                cs.fail(f"{what}: {attention.tf32x3_launches - n0} tf32x3 "
                        "launches, want 3")
            if not (torch.equal(o, o2) and torch.equal(o2, o3)):
                cs.fail(f"{what}: o with and without lse, or two launches, "
                        "differ")
            errs = [cs.check_close(f"{what} o", o, want_o, cs.ATTN_F32_TOL,
                                   0.0),
                    cs.check_close(f"{what} lse", lse, want_lse, cs.LSE_TOL,
                                   0.0),
                    cs.check_close(f"{what} o (simt)", s_o, want_o,
                                   cs.ATTN_F32_TOL, 0.0),
                    cs.check_close(f"{what} lse (simt)", s_lse, want_lse,
                                   cs.LSE_TOL, 0.0)]
            worst["tf32x3"] = max(worst["tf32x3"], *errs[:2])
            worst["simt"] = max(worst["simt"], *errs[2:])
            cs.log(f"  {what}: tf32x3 o {errs[0]:.3g} lse {errs[1]:.3g}; "
                   f"simt o {errs[2]:.3g} lse {errs[3]:.3g}")
        except (SystemExit, RuntimeError) as e:
            bad.append(what)
            cs.log(f"  {what}: FAILED {e}")
    cs.log(f"sweep: largest errors (o or lse) tf32x3 {worst['tf32x3']:.3g}, "
           f"simt {worst['simt']:.3g} (limits {cs.ATTN_F32_TOL}, "
           f"{cs.LSE_TOL})")
    return bad


MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// back-to-back products into 8 independent accumulators a warp
template <int kKind>
__global__ void mma_rate(float* out, long long* cycles, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  float c[8][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kKind == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  const long long t1 = clock64();
  float sum = 0.f;
  for (int i = 0; i < 8; ++i) sum += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if ((threadIdx.x & 31) == 0)
    cycles[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}
// one TF32 rounding a value: by cvt.rna.tf32.f32, or on the bits
__global__ void round_cvt(const float* x, uint32_t* y) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x[threadIdx.x]));
  y[threadIdx.x] = r;
}
__global__ void round_int(const float* x, uint32_t* y) {
  y[threadIdx.x] = (__float_as_uint(x[threadIdx.x]) + 0x1000u) & 0xffffe000u;
}
extern "C" int mma_rate_launch(void* out, void* cycles, int iters, int kind,
                               int blocks, int threads) {
  if (kind == 0)
    mma_rate<0><<<blocks, threads>>>((float*)out, (long long*)cycles, iters);
  else
    mma_rate<1><<<blocks, threads>>>((float*)out, (long long*)cycles, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(tmpdir: str) -> dict:
    """The card's mma.sync rate (see the module docstring) and the SASS of
    the two TF32 roundings; returns {kind: {warps a sub-partition: TFLOP/s}}
    and prints clocks a product."""
    from itsd_tpu_torch.kernels import _build

    src, lib_path = Path(tmpdir, "mma_rate.cu"), Path(tmpdir, "mma_rate.so")
    src.write_text(MMA_RATE_SOURCE)
    nvcc = _build.find_nvcc()
    subprocess.run([nvcc, *_build.ARCH_FLAGS, "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True).stdout
    fn, ops = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        if m := _build._SASS_FN.match(line):
            fn = m.group(1)
        elif fn and "round_" in fn and "/*" in line:
            words = [w for w in line.split("*/", 1)[-1].split(";", 1)[0].split()
                     if not w.startswith("@")]
            if words:
                ops[fn][words[0].split(".")[0]] += 1
    for fn, counts in sorted(ops.items()):
        cs.log(f"  SASS of {fn}: {sum(counts.values())} instructions, "
               f"{dict(counts.most_common())}")
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int)
    rates, iters, sms = {}, 2000, 132
    for kind, name, flop in ((0, "tf32 m16n8k8", 2048),
                             (1, "bf16 m16n8k16", 4096)):
        for warps in (1, 2, 4, 8):  # a sub-partition
            threads = 128 * warps
            out = torch.empty(sms * threads, device="cuda")
            cyc = torch.zeros(sms * threads // 32, dtype=torch.int64,
                              device="cuda")
            for _ in range(2):  # a warm-up launch, then the timed one
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                if lib.mma_rate_launch(out.data_ptr(), cyc.data_ptr(), iters,
                                       kind, sms, threads):
                    cs.fail("mma_rate: launch failed")
                end.record()
                end.synchronize()
            n = iters * 8
            clocks = cyc.double().mean().item() / n / warps
            ms = start.elapsed_time(end)
            tflops = flop * n * sms * threads / 32 / ms / 1e9
            rates.setdefault(name, {})[warps] = tflops
            cs.log(f"  mma.sync {name}, {warps} warps a sub-partition: "
                   f"{clocks:.2f} clocks a product on a sub-partition, "
                   f"{tflops:.1f} TFLOP/s")
    return rates


def inference_errors(dev) -> dict:
    """``--inference`` (see the module docstring); returns the largest
    |eps - plain eps| by attention kernel."""
    from unittest import mock

    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.kernels import attention
    from itsd_tpu_torch.models import unet

    with tempfile.TemporaryDirectory(prefix="itsd_probe_") as tmpdir:
        cfg = cs.inference_config(tmpdir)
    model, _ = runner.build_model(cfg)
    model.load_state_dict(cs.seeded_params(cfg))
    model.to(dev).eval()
    size = cfg.data.img_size
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((cs.INFERENCE_BATCH, size, size, 3), generator=gen,
                    device=dev)
    t = torch.linspace(0, cfg.diffusion.T - 1, cs.INFERENCE_BATCH,
                       device=dev).round().long()
    calls = []

    def plain(q, k, v, impl="auto"):
        calls.append((q, k, v))
        return attention.attention_plain(q, k, v, q.shape[-1] ** -0.5)

    def forced_simt(q, k, v, impl="auto"):
        return attention._flash_simt(q, k, v, q.shape[-1] ** -0.5, False)

    def run(*patches):
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            with torch.inference_mode():
                return model(x, t)

    p_gn, _ = cs.plain_path()
    want = run(p_gn, mock.patch.object(unet, "spatial_attention", plain))
    on_plain = calls[:]
    errs = {}
    for name, patches in (
            ("tf32x3", ()),
            ("simt", (mock.patch.object(unet, "spatial_attention",
                                        forced_simt),)),
            ("plain", (mock.patch.object(unet, "spatial_attention",
                                         plain),))):
        errs[name] = (run(*patches) - want).abs().max().item()
        cs.log(f"  inference config eps, attention on {name}, GroupNorm "
               f"kernel: max |eps - plain eps| {errs[name]:.3g} (phase 4's "
               f"limit {cs.EPS_TOL[torch.float32]}; max |plain| "
               f"{want.abs().max().item():.3f})")
    for i, (q, k, v) in enumerate(on_plain):
        scale = q.shape[-1] ** -0.5
        ref = attention.attention_plain(q, k, v, scale)
        got = {"tf32x3": attention.spatial_attention(q, k, v),
               "simt": attention._flash_simt(q, k, v, scale, False)}
        cs.log(f"  attention call {i} {list(q.shape)} on the plain path's "
               f"inputs (max |q| {q.abs().max().item():.3g}, |k| "
               f"{k.abs().max().item():.3g}, |v| {v.abs().max().item():.3g},"
               f" |o| {ref.abs().max().item():.3g}): max err "
               + ", ".join(f"{n} {(o - ref).abs().max().item():.3g}"
                           for n, o in got.items()))
    del model, x, want, calls, on_plain
    torch.cuda.empty_cache()
    return errs


def sums(by_tag: dict, key: str = "ms") -> dict:
    return {tag: cs.rows_entry(rows)[key] for tag, rows in by_tag.items()
            if rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tf32x3_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    _, smi_line = cs.card()
    cs.build()
    with tempfile.TemporaryDirectory(prefix="itsd_mma_rate_") as tmpdir:
        rates = mma_rate(tmpdir)
    bad = sweep(dev)
    cs.log(f"sweep: {len(SWEEP) - len(bad)} of {len(SWEEP)} shapes passed"
           + (f"; failed: {bad}" if bad else ""))
    if "--tests" in sys.argv[1:]:
        cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
               "-q", "-p", "no:cacheprovider", "-k", "tf32x3",
               "tests/test_torch_cuda.py"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900)
        cs.log(proc.stdout[-6000:] + proc.stderr[-2000:])
        if proc.returncode != 0:
            bad.append("CUDA tests")
    if "--inference" in sys.argv[1:]:
        inference_errors(dev)
    if "--check-only" in sys.argv[1:]:
        return 1 if bad else 0
    with tempfile.TemporaryDirectory(prefix="itsd_probe_") as tmpdir:
        cfg = cs.train_config(tmpdir)
        (train_shapes,) = cs.path_shapes(cfg, cs.seeded_params(cfg), dev,
                                         (cs.TRAIN_BATCH,))
        ccfg = cs.cfg_config(tmpdir)
        (cond_shapes,) = cs.path_shapes(ccfg, cs.seeded_params(ccfg), dev,
                                        (ccfg.train.batch_size,))
    timer = cs.DeviceTimer()
    tags = {"train": (train_shapes[1], 5, True),
            "cond_train": (cond_shapes[1], 5, True)}
    tags.update({tag: ([shape] * calls, 1 if tag == "infer384" else 3,
                       False)
                 for tag, (shape, calls) in cs.INFERENCE_ATTENTION.items()})
    rows = {"tf32x3": {}, "simt": {}}
    for tag, (calls, n, with_lse) in tags.items():
        cs.log(f"-- the f32 forward at the shapes of one {tag} step")
        got = cs.check_f32_forward(calls, dev, timer, n, with_lse)
        rows["tf32x3"][tag] = got["flash_attention_tf32x3"][1]
        rows["simt"][tag] = got["flash_attention_simt_f32"][1]
    out = {"card": smi_line, "mma_sync_tflops": rates,
           "tf32x3": sums(rows["tf32x3"]), "simt": sums(rows["simt"]),
           "plain": sums(rows["tf32x3"], "plain_ms"),
           "sdpa_f32": sums(rows["tf32x3"], "library_ms"),
           "bound_3xtf32": sums(rows["tf32x3"], "bound_ms"),
           "bound_f32": sums(rows["simt"], "bound_ms")}
    cs.log(smi_line)
    cs.log(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
