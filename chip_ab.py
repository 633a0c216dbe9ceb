#!/usr/bin/env python3
"""Time the port's host-bound paths in several checkouts, on one card.

    python3 chip_ab.py DIR [DIR ...]
    python3 chip_ab.py --interleaved DIR_A DIR_B

The first form runs phases 3, 7 and 9 of each checkout's own
``chip_smoke.py`` (the unconditional ``runner.evaluate``, ``runner.train``
and the guided ``runner.evaluate`` of the CFG UNet, with their checks),
one process a DIR, in the order given, so that two versions compare within
one machine: give them as parent, change, change, parent. Each process
builds its checkout's kernels (into that checkout's ``build/``), warms the
UNet's forward up, then drives the three phases. Prints one JSON line a
run and a summary; the full output of each run goes to
``build/chip_ab/run_<i>.log``.

The second form imports both checkouts' ``itsd_tpu_torch`` into one
process (under other names; the package imports itself only relatively),
so that process-wide conditions (its cores, its memory) are the same for
both, and alternates between them: BLOCKS blocks, each timing
TRAIN_STEPS train steps of the unconditional UNet at phase 7's
configuration (batch 128, bf16; each step ended by a synchronize) and
EVAL_STEPS ancestral eval steps at phase 3's (batch 8, bf16), A then B in
even blocks and B then A in odd ones. Prints each side's per-block
medians, their medians, how many blocks B won and the card's ``nvidia-smi``
name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("eval_ms_per_step", "forward_device_ms", "forward_host_ms",
        "train_median_ms", "train_busy_pct", "cfg_ms_per_step",
        "cfg_interval_ms_per_step", "auto_ms_per_step")
PATTERNS = {
    "eval_ms_per_step": r"evaluate: T=\d+ batch \d+ bf16 in [\d.]+ s = "
                        r"[\d.]+ images/s \(([\d.]+) ms/step\)",
    "forward_device_ms": r"one UNet forward: device ([\d.]+) ms",
    "forward_host_ms": r"one UNet forward: device [\d.]+ ms, host launch "
                       r"([\d.]+) ms",
    "train_median_ms": r"train step \(batch \d+, bf16\) on .*?: median "
                       r"([\d.]+) ms wall",
    "train_busy_pct": r"the device is busy ([\d.]+)%",
}


def run_one(root: str) -> dict:
    """Phases 3, 7 and 9 of ``root``'s chip_smoke.py, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    import itsd_tpu_torch

    for mod in (cs, itsd_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {root}")
    lines = []
    log = cs.log

    def captured(msg):
        lines.append(msg)
        log(msg)

    cs.log = captured
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, smi = cs.card()
    cs.build()
    with tempfile.TemporaryDirectory(prefix="itsd_chip_ab_") as tmp:
        params = cs.seeded_params(cs.eval_config(tmp))
        timer = cs.DeviceTimer()
        cs.forward_split(params, tmp, timer)  # warm-up, not read
        cs.eval_path(params, tmp, smi, 51, 6, timer)
        del params
        cs.train_path(tmp, smi)
        cparams = cs.seeded_params(cs.cfg_config(tmp))
        _, guided = cs.guided_eval_path(cparams, tmp, smi)
    text = "\n".join(lines)
    out = {"root": root, "card": smi}
    for key, pattern in PATTERNS.items():
        found = re.findall(pattern, text)
        # the last match: phase 7's restore repeats no such line
        out[key] = float(found[-1]) if found else None
    out["cfg_ms_per_step"] = guided["cfg_eval"]["ms_per_step"]
    out["cfg_interval_ms_per_step"] = guided["cfg_interval_eval"][
        "ms_per_step"]
    out["auto_ms_per_step"] = guided["auto_eval"]["ms_per_step"]
    return out


BLOCKS = 30
TRAIN_STEPS = 10
EVAL_STEPS = 50


def load_package(root: str, alias: str):
    """``root``'s ``itsd_tpu_torch`` imported as ``alias``."""
    pkg = os.path.join(os.path.abspath(root), "itsd_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def interleaved(roots) -> dict:
    """Phase 7's train step and phase 3's eval step of each checkout in
    ``roots``, alternated in one process (see the module docstring)."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sides = []
    for i, root in enumerate(roots):
        alias = f"itsd_tpu_torch_ab{i}"
        load_package(root, alias)
        mod = {m: importlib.import_module(f"{alias}.{m}") for m in (
            "cli.runner", "core", "data", "kernels._build", "train",
            "utils")}
        runner, train = mod["cli.runner"], mod["train"]
        if not mod["cli.runner"].__file__.startswith(
                os.path.abspath(root) + os.sep):
            raise RuntimeError(f"{alias} came from {mod['cli.runner']}")
        mod["kernels._build"].load()
        cfg = mod["utils"].load_config(None, [
            "channel=128", "channel_mult=[1,2,2,2]", "attn=[1]",
            "num_res_blocks=2", "dropout=0.1", "T=1000", "img_size=32",
            "model.dtype=bfloat16", "batch_size=128", "lr=2e-4",
            "seed=0"])
        model, _ = runner.build_model(cfg)
        model.load_state_dict(runner.init_params(cfg, model))
        model.to(dev)
        tx = train.make_optimizer(train.OptimizerConfig(
            lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
            grad_clip=cfg.train.grad_clip, multiplier=cfg.train.multiplier,
            epochs=10, steps_per_epoch=16), model.parameters())
        state = train.create_train_state(model, tx)
        sched = runner.build_schedule(cfg, device=dev)
        step = train.make_train_step(sched, ema_decay=cfg.train.ema_decay)
        images, _ = mod["data"].shapes_dataset(n=128, seed=11)
        batch = {"image": torch.from_numpy(images).to(dev)}
        gen = torch.Generator(device=dev).manual_seed(12)
        x_T = torch.randn((8, 32, 32, 3), generator=gen, device=dev)
        segment = mod["core"].denoise_segment
        sides.append(dict(root=root, model=model, state=state, step=step,
                          batch=batch, gen=gen, sched=sched, x_T=x_T,
                          segment=segment, train_ms=[], eval_ms=[]))

    def run(side, record=True):
        walls = []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            side["step"](side["state"], side["batch"], side["gen"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        side["model"].eval()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            side["segment"](side["sched"], side["model"], side["x_T"],
                            EVAL_STEPS, 0, generator=side["gen"])
        torch.cuda.synchronize()
        if record:
            side["train_ms"].append(float(np.median(walls)))
            side["eval_ms"].append((time.perf_counter() - t0) * 1e3
                                   / EVAL_STEPS)

    for side in sides:  # warm-up: cuDNN's choices, the allocator
        run(side, record=False)
    for b in range(BLOCKS):
        for side in (sides if b % 2 == 0 else sides[::-1]):
            run(side)
    a, b = sides
    out = {}
    for key in ("train_ms", "eval_ms"):
        out[key] = {os.path.basename(s["root"]) + f"_{i}":
                    dict(median=float(np.median(s[key])),
                         quartiles=[float(q) for q in
                                    np.percentile(s[key], [25, 75])],
                         blocks=[round(v, 3) for v in s[key]])
                    for i, s in enumerate(sides)}
        out[key]["blocks_B_faster"] = int(sum(
            y < x for x, y in zip(a[key], b[key])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out.update(blocks=BLOCKS, train_steps=TRAIN_STEPS,
               eval_steps=EVAL_STEPS, roots=list(roots),
               card=smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
               else None)
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--interleaved":
        print(json.dumps(interleaved(argv[1:])), flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--one":
        print("CHIP_AB " + json.dumps(run_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.join(HERE, "build", "chip_ab")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, root in enumerate(argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, timeout=1200)
        with open(os.path.join(out_dir, f"run_{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("CHIP_AB ")]
        if proc.returncode != 0 or not found:
            print(proc.stdout[-3000:] + proc.stderr[-3000:])
            print(f"chip_ab: run {i} ({root}) failed, exit "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        res = json.loads(found[-1][len("CHIP_AB "):])
        res.update(run=i, seconds=round(time.perf_counter() - t0, 1))
        runs.append(res)
        print(json.dumps(res), flush=True)
    print("summary (run: " + ", ".join(KEYS) + "):")
    for res in runs:
        print(f"  {res['run']} {os.path.basename(res['root'])}: "
              + ", ".join(str(res[k]) for k in KEYS))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
