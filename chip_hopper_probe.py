#!/usr/bin/env python3
"""Clock stamps inside the loop of the mma route's Hopper forward, on one
card:

    python3 chip_hopper_probe.py

Compiles a copy of ``csrc/flash_attention_hopper.cu`` with ``clock64()``
stamps at the steps of the forward's pipelined loop (the turn, the issue
of s of the next tile and of p.v, the wait for s, the softmax, the wait
for p.v), into ``build/hopper_probe/``, runs it at three shapes and
prints, for block (0, 0), each consumer warpgroup's clocks a step for
every key tile: where a tile's time goes, which ``ncu`` (it does not run
on the card's machine) would otherwise say. The stamps are placed by text
edits of the source, which fail loudly when the source has moved on.
Needs a CUDA device; prints the card's ``nvidia-smi`` name and power
limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

STAMP_SHAPES = [(16, 1024, 128), (256, 1024, 128), (128, 256, 256)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


STAMP_HEADER = '''
__device__ long long g_stamps[2][64][8];
#define STAMP(k) do { if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    (threadIdx.x & 127) == 0 && wg < 2 && j < 64) \\
    g_stamps[wg][j][k] = clock64(); } while (0)
extern "C" int probe_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int probe_clear_stamps() {
  static long long zeros[2][64][8];
  return (int)cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros));
}
'''
# (text, the same text with a stamp) inside step(): 0 before the turn, 1
# after it, 2 after s of tile j + 1 and p.v of tile j are issued, 3 after
# the wait for s, 4 after the softmax, 5 after the wait for p.v
STAMP_EDITS = [
    ("    take_turn();\n    issue_s(sc, j + 1);\n",
     "    STAMP(0);\n    take_turn();\n    STAMP(1);\n"
     "    issue_s(sc, j + 1);\n"),
    ("    hand_over(false);\n    hopper::wgmma_wait<1>();",
     "    hand_over(false);\n    STAMP(2);\n    hopper::wgmma_wait<1>();"),
    ("    hopper::fence_regs(sc);\n    if (lane == 0) hopper::mbar_arrive("
     "&k_empty[(j + 1) % nst]);\n    softmax(sc, j + 1, corr, nxt);\n",
     "    hopper::fence_regs(sc);\n    STAMP(3);\n    if (lane == 0) "
     "hopper::mbar_arrive(&k_empty[(j + 1) % nst]);\n"
     "    softmax(sc, j + 1, corr, nxt);\n    STAMP(4);\n"),
    ("    hopper::fence_regs(cur);\n    if (lane == 0) hopper::mbar_arrive("
     "&v_empty[j % nst]);\n  };\n  // the last tile's p.v",
     "    hopper::fence_regs(cur);\n    STAMP(5);\n    if (lane == 0) "
     "hopper::mbar_arrive(&v_empty[j % nst]);\n  };\n"
     "  // the last tile's p.v"),
]


def stamps() -> None:
    from itsd_tpu_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_hopper.cu").read_text()
    src = src.replace("namespace {\n", STAMP_HEADER + "namespace {\n", 1)
    for old, new in STAMP_EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"stamps: the source has moved on; no single "
                             f"place for:\n{old}")
        src = src.replace(old, new)
    src = src.replace('extern "C" int itsd_flash_attention_mma(',
                      'extern "C" int probe_flash_attention(')
    out = os.path.join(ROOT, "build", "hopper_probe")
    os.makedirs(out, exist_ok=True)
    cu, lib_path = (os.path.join(out, "fwd_stamps.cu"),
                    os.path.join(out, "libfwd_stamps.so"))
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", lib_path, cu], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_flash_attention.argtypes = (P, P, P, P, P, I, I, I, F, I, P)
    dev = torch.device("cuda")
    for B, N, C in STAMP_SHAPES:
        q, k, v = (torch.randn((B, N, C), device=dev).to(torch.bfloat16)
                   for _ in range(3))
        o, lse = torch.empty_like(q), torch.empty((B, N), device=dev)
        if lib.probe_clear_stamps():
            raise SystemExit("clearing the stamps failed")
        for _ in range(3):  # the last launch's stamps are read
            rc = lib.probe_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, N, C, C ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
        buf = np.zeros((2, 64, 8), dtype=np.int64)
        if lib.probe_read_stamps(buf.ctypes.data):
            raise SystemExit("reading the stamps failed")
        print(f"forward {[B, N, C]} with lse, block (0, 0): clocks a step "
              "of each key tile j (the last tile's p.v is not stamped): "
              "turn, issue s(j+1) and p.v(j), wait s, softmax, wait p.v")
        for wg in range(2):
            for j in range(64):
                row = buf[wg, j, :6]
                if not row[0]:
                    break
                d = np.diff(row)
                print(f"  warpgroup {wg} tile {j}: " +
                      " ".join(f"{x:6d}" for x in d) +
                      f" | {row[5] - row[0]:6d}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_hopper_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(card_line(), flush=True)
    stamps()
    return 0


if __name__ == "__main__":
    sys.exit(main())
