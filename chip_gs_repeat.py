#!/usr/bin/env python3
"""Repeat the gradient_search parity check of ``chip_smoke.py``'s phase 16.

    python3 chip_gs_repeat.py [REPEATS]

On one NVIDIA card, from the root of a checkout: builds the kernels, makes
phase 16's seeded unconditional UNet and then, REPEATS times (default 12),
trains the classifier verifier anew (as each ``chip_smoke.py`` run does:
its training is not deterministic, so each repeat scores with slightly
other weights) and runs ``gradient_search_parity``: the kernel path's
gradient_search against the plain path at its iterates, f32 and bf16,
with its worst-element report; then, from the gradients it returns, the
kernels' Adam updates against Adam on the plain gradients at the same
iterates (``adam_report``). A repeat that fails its limit is recorded and
the next one runs. Prints one JSON line a repeat and a summary line last;
exits non-zero when there is no card, never because a repeat failed.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
import tempfile
import time

import torch

import chip_smoke as S

SCORE = re.compile(r"gradient_search parity (float32|bfloat16): .*max "
                   r"\|score err\| ([0-9.e+-]+).*relative err ([0-9.e+-]+)"
                   r".*gradients relative L2 ([0-9.e+ -]+) \(limit")
WORST = re.compile(r"gradient_search parity (float32|bfloat16), worst "
                   r"element: (.*)")


def adam_report(noises, grads, lr) -> str:
    """What Adam makes of the plain path's gradients (``grads``, of the
    loss, at the kernel path's iterates ``noises``) against the kernel
    path's own updates (the differences of its iterates): each update is
    ~lr * g / (|g| + 1e-8) element by element, so where |g| is near Adam's
    eps or the paths' f32 difference, the two updates differ by up to
    2 lr. Per update: the largest difference, in units of lr, the plain
    gradient and both updates at that element, and how many elements have
    |g| < 1e-7."""
    from itsd_tpu_torch.search import algorithms as A

    parts = []
    mu = nu = torch.zeros_like(grads[0])
    for it, g in enumerate(grads[:-1]):
        u, mu, nu = A._adam_step(g, mu, nu, it + 1, lr)
        uk = noises[it + 1] - noises[it]
        d = (uk - u).abs()
        i = int(torch.argmax(d))
        parts.append(
            f"update {it}: max |diff| {float(d.flatten()[i]) / lr:.3g} lr at "
            f"g {float(g.flatten()[i]):.3g} (kernels "
            f"{float(uk.flatten()[i]) / lr:.3g} lr, plain "
            f"{float(u.flatten()[i]) / lr:.3g} lr), "
            f"{int((g.abs() < 1e-7).sum())} elements with |g| < 1e-7")
    return "; ".join(parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gs_repeat: no CUDA device is available", file=sys.stderr)
        return 1
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi_line = S.card()
    S.build()
    failed = 0
    with tempfile.TemporaryDirectory(prefix="itsd_gs_repeat_") as tmpdir:
        params = S.seeded_params(S.eval_config(tmpdir))
        for r in range(repeats):
            t0 = time.perf_counter()
            clf = S.train_search_classifier(tmpdir)
            out = io.StringIO()
            error, records = None, {}
            with contextlib.redirect_stdout(out):
                try:
                    S.gradient_search_parity(params, clf, tmpdir, {},
                                             records)
                except RuntimeError as e:
                    error = str(e)
            text = out.getvalue()
            print(text, end="", flush=True)
            rec = {"repeat": r, "ok": error is None, "error": error,
                   "seconds": round(time.perf_counter() - t0, 2)}
            for m in SCORE.finditer(text):
                rec[m.group(1)] = {"score_err": float(m.group(2)),
                                   "norm_rel_err": float(m.group(3)),
                                   "grad_rel_l2": m.group(4)}
            for m in WORST.finditer(text):
                rec.setdefault(m.group(1), {})["worst"] = m.group(2)
            for dt, r in records.items():
                rec.setdefault(dt, {})["adam"] = adam_report(
                    r["iterates"], r["plain_grads"], 0.01)
            failed += error is not None
            print(json.dumps(rec), flush=True)
    print(json.dumps({"repeats": repeats, "failed": failed, "card": name,
                      "nvidia_smi": smi_line,
                      "limits": {"score": S.GS_SCORE_TOL,
                                 "norm_rel": S.GS_NORM_REL_TOL,
                                 "grad_rel_l2": S.GS_GRAD_REL_TOL}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
