#!/usr/bin/env python3
"""The mma route's dq and the row-shard statistics kernel on one card,
without the rest of ``chip_smoke.py``:

    python3 chip_kernel_probe.py [--no-tests]

Builds the kernels and checks them as ``chip_smoke.py``'s phase 1 does
(ptxas spills; HGMMA and UTMALDG in every Hopper kernel), runs their CUDA
tests (``-k "hopper and dq or stats or mma_sync"``, unless
``--no-tests``), then, with ``chip_smoke.py``'s own functions, phase 2's
GroupNorm checks over row shards (the flagship's and the CIFAR UNet's
forwards on one of 2 or 4 seq ranks' rows: the stats kernel against its
plain version, timed in turns with the earlier stats kernel, beside an
empty kernel on its grid and ``torch.sum``) and phase 5's backward checks
at the train steps' and gradient search's attention shapes (the Hopper dq
timed in turns with the mma.sync dq, beside SDPA's backward). Prints each
step tag's sums (ms, NVIDIA's card name and power limit first) and, last,
one JSON line of them. Needs a CUDA device.
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


def cuda_tests() -> None:
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
           "-p", "no:cacheprovider", "-k",
           "hopper and dq or stats or mma_sync", "tests/test_torch_cuda.py"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    cs.log(proc.stdout[-4000:] + proc.stderr[-2000:])
    if proc.returncode != 0:
        cs.fail(f"the CUDA tests failed (exit {proc.returncode})")


def sums(by_tag: dict, name: str) -> dict:
    return {tag: cs.rows_entry(rows)["ms"]
            for tag, (_, rows) in by_tag.get(name, {}).items() if rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(cs.DEVICE)
    _, smi_line = cs.card()
    cs.build()
    if "--no-tests" not in sys.argv[1:]:
        cuda_tests()
    with tempfile.TemporaryDirectory(prefix="itsd_probe_") as tmpdir:
        cfg = cs.eval_config(tmpdir)
        params = cs.seeded_params(cfg)
        eval_shapes, train_shapes = cs.path_shapes(
            cfg, params, dev, (cs.BATCH, cs.TRAIN_BATCH))
        ccfg = cs.cfg_config(tmpdir)
        cparams = cs.seeded_params(ccfg)
        cfg_shapes, cond_shapes = cs.path_shapes(
            ccfg, cparams, dev, (2 * cs.CFG_BATCH, ccfg.train.batch_size))
        del params, cparams
        ft_cfg = cs.ft_config(tmpdir, f"diffusion.T={cs.FT_OLD_T}")
        (ft_shapes,) = cs.path_shapes(ft_cfg, cs.seeded_params(ft_cfg), dev,
                                      (cs.SP_FLAG_BATCH,))
        vcfg = cs.vit_config(tmpdir)
        vit_train = cs.vit_attention_shapes(vcfg, cs.VIT_BATCH)
        vit_rows = cs.vit_attention_shapes(vcfg, cs.SP_FLAG_BATCH,
                                           cs.SP_RANKS)
    timer = cs.DeviceTimer()
    stats = {}
    for tag, (gn_calls, batch) in {
            "flagship_rows": (ft_shapes[0], cs.SP_FLAG_BATCH),
            "cifar_rows": (train_shapes[0], cs.SP_CIFAR_BATCH)}.items():
        for K in cs.ROWS_K:
            for name, res in cs.check_groupnorm_rows(gn_calls, batch, K, dev,
                                                     timer, 5).items():
                stats.setdefault(name, {})[f"{tag}_k{K}"] = res
    bwd = cs.check_backward_kernels({
        "train": (train_shapes, [(8, 256, 128)]),
        "cond_train": (cond_shapes, [(800, 1024, 128)]),
        "grad_search": (([], eval_shapes[1]), []),
        "cfg_grad_search": (([], cfg_shapes[1]), []),
        "vit_train": (vit_train, []),
        "vit_rows2": (vit_rows, [])}, dev, timer)
    out = {"card": smi_line, "stats": {}, "dq": {}}
    for name in ("groupnorm_partial_stats", "groupnorm_partial_stats_sum",
                 "groupnorm_partial_stats_cluster",
                 "groupnorm_partial_stats_cluster_sum",
                 "groupnorm_partial_stats_empty"):
        out["stats"][name] = sums(stats, name)
    out["stats"]["library_sum"] = {
        tag: cs.rows_entry(rows)["library_ms"]
        for tag, (_, rows) in stats["groupnorm_partial_stats_sum"].items()}
    out["stats"]["bound"] = {
        tag: cs.rows_entry(rows)["bound_ms"]
        for tag, (_, rows) in stats["groupnorm_partial_stats"].items()}
    for name in ("flash_bwd_dq_mma", "flash_bwd_dq_mma_sync",
                 "flash_bwd_dkv_mma"):
        out["dq"][name] = sums(bwd, name)
    out["dq"]["sdpa_bwd"] = {
        tag: cs.rows_entry(rows)["library_ms"]
        for tag, (_, rows) in bwd["flash_bwd_dq_mma"].items() if rows}
    out["dq"]["bound"] = {
        tag: cs.rows_entry(rows)["bound_ms"]
        for tag, (_, rows) in bwd["flash_bwd_dq_mma"].items() if rows}
    cs.log(smi_line)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
