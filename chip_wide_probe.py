#!/usr/bin/env python3
"""The wide route's Hopper forward and dk/dv on one card, without the rest
of ``chip_smoke.py``:

    python3 chip_wide_probe.py [--check-only] [--tests]

Builds the kernels and checks them as ``chip_smoke.py``'s phase 1 does
(ptxas spills; HGMMA and UTMALDG in every Hopper kernel), then holds the
wide forward (with and without lse) and dk/dv against their plain versions
and against the mma.sync kernels they replaced (forced calls) over a sweep
of widths and token counts, packed batches past 132 samples among them,
and two launches of dk/dv bit for bit. Every failure is printed, and the
run fails at the end if there was one. Unless ``--check-only``, it then
runs, with ``chip_smoke.py``'s own functions, phase 2's and phase 5's
checks and timings at the wide route's tags (the CFG UNet's train step,
guided eval, Picard fold, search folds, tracked batch and gradient search,
the flagship's [1, 4096, 384] and the fine-tune's shapes: the Hopper
kernels in turns with the mma.sync ones, SDPA and the bound) and prints
each tag's sums and, last, one JSON line of them. ``--tests`` also runs the
CUDA tests ``-k "wide and hopper or plain_route"``. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
SWEEP = ([(2, N, C) for C in (272, 384, 400, 512, 528, 768, 1008, 1024)
          for N in (1, 4, 16, 63, 64, 65, 200, 256, 1024)]
         + [(1, 4096, 384), (2, 4096, 384), (16, 256, 512), (256, 64, 1024),
            (256, 16, 1024), (256, 4, 512), (300, 7, 384), (800, 16, 1024),
            (1000, 3, 512), (133, 64, 512)])


def sweep(dev) -> list:
    """The forward and dk/dv at every shape of SWEEP; the failures."""
    from itsd_tpu_torch.kernels import attention

    bad = []
    gen = torch.Generator(device=dev).manual_seed(11)
    for B, N, C in SWEEP:
        what = f"[{B}, {N}, {C}]"
        q, k, v, do = (torch.randn((B, N, C), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        dlse = torch.randn((B, N), generator=gen, device=dev)
        scale = C ** -0.5
        try:
            o, lse = attention.attention_with_lse(q, k, v, scale)
            o2 = attention.spatial_attention(q, k, v)
            o_sync, _ = attention._flash_wide_sync(q, k, v, scale, True)
            want_o, want_lse = attention.attention_plain_stats(q, k, v,
                                                               scale)
            torch.cuda.synchronize()
            atol = cs.ATTN_BF16_RTOL * v.float().abs().max().item()
            e_o = cs.check_close(f"{what} o", o, want_o, atol,
                                 cs.ATTN_BF16_RTOL)
            cs.check_close(f"{what} o (mma.sync)", o_sync, want_o, atol,
                           cs.ATTN_BF16_RTOL)
            e_l = cs.check_close(f"{what} lse", lse, want_lse, cs.LSE_TOL,
                                 0.0)
            if not torch.equal(o, o2):
                cs.fail(f"{what}: o with and without lse differ")
            errs = [e_o, e_l]
            bound = cs.sum_order_bounds(q, k, v, do, lse, scale)[1]
            for dl in (None, dlse):
                dd = attention.row_dd(o, do, dl).contiguous()
                args = (q, k, v, do, lse, dd, scale)
                got = attention.flash_bwd_dkv(*args)
                again = attention.flash_bwd_dkv(*args)
                sync = attention._flash_bwd_dkv_wide_sync(*args)
                want = attention.flash_bwd_dkv_plain(*args)
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, again)):
                    cs.fail(f"{what}: two dk/dv launches differ")
                for name, g, s_, w, b in zip(("dk", "dv"), got, sync, want,
                                             (bound, None)):
                    a = cs.BWD_BF16_RTOL * w.float().abs().max().item()
                    errs.append(cs.check_close(
                        f"{what} {name} dlse={dl is not None}", g, w, a,
                        cs.BWD_BF16_RTOL, b))
                    cs.check_close(f"{what} {name} (mma.sync)", s_, w, a,
                                   cs.BWD_BF16_RTOL, b)
            cs.log(f"  {what}: o {errs[0]:.3g} lse {errs[1]:.3g} dk dv "
                   f"{' '.join(f'{e:.3g}' for e in errs[2:])}")
        except (SystemExit, RuntimeError) as e:
            bad.append(what)
            cs.log(f"  {what}: FAILED {e}")
    return bad


def sums(by_tag: dict, name: str, key: str = "ms") -> dict:
    return {tag: cs.rows_entry(rows)[key]
            for tag, (_, rows) in by_tag.get(name, {}).items() if rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_wide_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    _, smi_line = cs.card()
    cs.build()
    bad = sweep(dev)
    cs.log(f"sweep: {len(SWEEP) - len(bad)} of {len(SWEEP)} shapes passed"
           + (f"; failed: {bad}" if bad else ""))
    if "--tests" in sys.argv[1:]:
        cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
               "-q", "-p", "no:cacheprovider", "-k",
               "wide and hopper or plain_route", "tests/test_torch_cuda.py"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900)
        cs.log(proc.stdout[-6000:] + proc.stderr[-2000:])
        if proc.returncode != 0:
            bad.append("CUDA tests")
    if "--check-only" in sys.argv[1:]:
        return 1 if bad else 0
    with tempfile.TemporaryDirectory(prefix="itsd_probe_") as tmpdir:
        ccfg = cs.cfg_config(tmpdir)
        cparams = cs.seeded_params(ccfg)
        (cfg_shapes, cfg_b8_shapes, cond_shapes, cfg_picard_shapes,
         cfg_search_shapes, cfg_tracked_shapes) = cs.path_shapes(
            ccfg, cparams, dev,
            (2 * cs.CFG_BATCH, cs.CFG_BATCH, ccfg.train.batch_size,
             2 * cs.FAST_STEPS * cs.CFG_BATCH,
             2 * cs.CFG_SEARCH_N * cs.CFG_BATCH, 2 * cs.TRACKED_BATCH))
        del cparams
        ft_cfg = cs.ft_config(tmpdir, f"diffusion.T={cs.FT_OLD_T}")
        (ft_shapes,) = cs.path_shapes(ft_cfg, cs.seeded_params(ft_cfg), dev,
                                      (cs.FT_BATCH,))

    def wide(paths):  # the wide route's attention calls only
        return ([], [s for s in paths[1]
                     if cs.attention_route(s[2]) == "wide"])

    timer = cs.DeviceTimer()
    fwd = {}
    for tag, (shapes, n, with_lse) in {
            "cfg_eval": (cfg_shapes, 10, False),
            "cfg_eval_b8": (cfg_b8_shapes, 10, False),
            "cond_train": (cond_shapes, 5, True),
            "cfg_picard": (cfg_picard_shapes, 5, False),
            "cfg_search": (cfg_search_shapes, 5, False),
            "cfg_tracked": (cfg_tracked_shapes, 5, False),
            "flagship": (cs.FLAGSHIP_ATTENTION, 10, True),
            "finetune": (ft_shapes, 1, True)}.items():
        cs.log(f"-- shapes of one {tag} step")
        for name, res in cs.check_flash_forward(wide(shapes)[1], dev, timer,
                                                n, with_lse, tag).items():
            fwd.setdefault(name, {})[tag] = res
    bwd = cs.check_backward_kernels({
        "cond_train": (wide(cond_shapes), []),
        "cfg_grad_search": (wide(([], cfg_shapes[1])), []),
        "flagship": (cs.FLAGSHIP_ATTENTION, []),
        "finetune": (wide(([], ft_shapes[1])), [], 1)}, dev, timer)
    out = {"card": smi_line, "forward": {}, "dkv": {}}
    for name in ("flash_attention_wide", "flash_attention_wide_sync"):
        out["forward"][name] = sums(fwd, name)
    out["forward"]["sdpa"] = sums(fwd, "flash_attention_wide", "library_ms")
    out["forward"]["bound"] = sums(fwd, "flash_attention_wide", "bound_ms")
    for name in ("flash_bwd_dkv_wide", "flash_bwd_dkv_wide_sync",
                 "flash_bwd_dq_wide"):
        out["dkv"][name] = sums(bwd, name)
    out["dkv"]["sdpa_bwd"] = sums(bwd, "flash_bwd_dkv_wide", "library_ms")
    out["dkv"]["bound"] = sums(bwd, "flash_bwd_dkv_wide", "bound_ms")
    cs.log(smi_line)
    cs.log(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
