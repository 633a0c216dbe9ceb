"""Build the port's CUDA kernels at first use and bind them with ctypes.

All of ``itsd_tpu_torch/csrc/*.cu`` go through ONE ``nvcc`` call into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds, not minutes). The library lands in ``build/`` at the root of
the checkout (listed in ``.gitignore``), in a directory named by a hash of
the sources and the flags, so an edited source builds anew and an unchanged
one loads what is there. The library is written under a temporary name and
renamed into place: there is no lock file to leave behind.

A failed build raises with nvcc's own error output. Nothing falls back to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
LIB_NAME = "libitsd_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu): name -> argtypes
SIGNATURES = {
    # x, weight, bias, y, B, C, HW, G, eps, act, dtype, stream
    "itsd_groupnorm_swish": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, o, lse, B, N, C, scale, dtype, stream
    "itsd_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "itsd_flash_attention_mma": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                 _P),
    # q, k, v, dout, lse, dd, dq, B, N, C, scale, dtype, stream
    "itsd_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                          _P),
    "itsd_flash_bwd_dq_mma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                              _I, _P),
    # q, k, v, dout, lse, dd, dk, dv, B, N, C, scale, dtype, stream
    "itsd_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                           _I, _P),
    "itsd_flash_bwd_dkv_mma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _F, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library and what its build reported."""
    lib: ctypes.CDLL
    path: Path
    built: bool            # False when an earlier build was loaded
    nvcc_seconds: float    # 0.0 when nothing was built
    ptxas: tuple           # (function, registers, spill stores, spill loads)


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels cannot be built")
    return found


def nvcc_command(nvcc: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(stderr: str) -> tuple:
    """(function, registers, spill stores, spill loads) per kernel, from
    the ``-Xptxas -v`` report."""
    rows, fn, spill = [], None, (0, 0)
    for line in stderr.splitlines():
        if m := _PTXAS_FN.search(line):
            fn, spill = m.group(1), (0, 0)
        elif m := _PTXAS_SPILL.search(line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _PTXAS_REGS.search(line)) and fn is not None:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    return tuple(rows)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.itsd_error_string.argtypes = (ctypes.c_int,)
    lib.itsd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> Kernels:
    """Build (if needed) and load the kernels' shared library, once per
    process."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    path = out_dir / LIB_NAME
    if path.is_file():
        return Kernels(_bind(path), path, False, 0.0, ())
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp-{os.getpid()}-{LIB_NAME}"
    cmd = nvcc_command(find_nvcc(), tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, path)
    return Kernels(_bind(path), path, True, seconds,
                   parse_ptxas(proc.stderr + proc.stdout))


def check(kernels: Kernels, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        text = kernels.lib.itsd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({text}) at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
