"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each of ``itsd_tpu_torch/csrc/*.cu`` is compiled by an ``nvcc -c`` of its
own, all started together, and one more ``nvcc`` links the objects into a
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds, not minutes). The library lands in ``build/`` at the root of
the checkout (listed in ``.gitignore``), in a directory named by a hash of
the sources and the flags, so an edited source builds anew and an unchanged
one loads what is there. Objects and library are written in a temporary
directory and the library is renamed into place: there is no lock file to
leave behind.

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu): name -> argtypes
SIGNATURES = {
    # x, weight, bias, y, B, C, HW, G, eps, act, dtype, stream
    "itsd_groupnorm_swish": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, mean (or null), out, B, C, HW, G, dtype, stream
    "itsd_groupnorm_partial_stats": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "itsd_groupnorm_partial_stats_cluster": (_P, _P, _P, _I, _I, _I, _I, _I,
                                             _P),
    # x, B, C, HW, G, dtype, stream
    "itsd_groupnorm_stats_floor": (_P, _I, _I, _I, _I, _I, _P),
    # x, mean, rstd, weight, bias, y, B, C, HW, G, act, dtype, stream
    "itsd_groupnorm_apply": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
    # q, k, v, o, lse, B, N, C, scale, dtype, stream
    "itsd_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "itsd_flash_attention_mma": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                 _P),
    "itsd_flash_attention_mma_sync": (_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                      _I, _P),
    "itsd_flash_attention_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                  _P),
    "itsd_flash_attention_wide_sync": (_P, _P, _P, _P, _P, _I, _I, _I, _F,
                                       _I, _P),
    "itsd_flash_attention_tf32x3": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                                    _P),
    # q, k, v, dout, lse, dd, dq, B, N, C, scale, dtype, stream
    "itsd_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                          _P),
    "itsd_flash_bwd_dq_mma": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                              _I, _P),
    "itsd_flash_bwd_dq_mma_sync": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _F, _I, _P),
    "itsd_flash_bwd_dq_wide": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                               _I, _P),
    # q, k, v, dout, lse, dd, dk, dv, B, N, C, scale, dtype, stream
    "itsd_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                           _I, _P),
    "itsd_flash_bwd_dkv_mma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _F, _I, _P),
    "itsd_flash_bwd_dkv_mma_sync": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _F, _I, _P),
    "itsd_flash_bwd_dkv_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _F, _I, _P),
    "itsd_flash_bwd_dkv_wide_sync": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _F, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library and what its build reported."""
    lib: ctypes.CDLL
    path: Path
    built: bool            # False when an earlier build was loaded
    nvcc_seconds: float    # wall time of the build; 0.0 when none ran
    ptxas: tuple           # (function, registers, spill stores, spill loads)


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
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


def compile_commands(nvcc: str, obj_dir: Path) -> list:
    """One ``nvcc -c`` per source, writing ``<stem>.o`` under ``obj_dir``."""
    return [[nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj_dir / f"{p.stem}.o"),
             str(p)] for p in sources()]


def link_command(nvcc: str, obj_dir: Path, out: Path) -> list:
    """The ``nvcc -shared`` that links the objects into ``out``."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *(str(obj_dir / f"{p.stem}.o") for p in sources())]


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


_SASS_FN = re.compile(r"^\s*Function : (\S+)")


def sass_counts(path: Path, opcodes=("HGMMA", "UTMALDG"),
                functions=None) -> dict:
    """{kernel: {opcode: count}} of the built library's SASS, from
    ``cuobjdump -sass``: how many instructions of each opcode each kernel
    holds (see ``parse_sass``); only the kernels named in ``functions``
    (mangled names), when given. Raises when cuobjdump fails."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    only = ["-fun", ",".join(functions)] if functions else []
    proc = subprocess.run([str(cuobjdump), "-sass", *only, str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed (exit {proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
    return parse_sass(proc.stdout, opcodes)


def _matches(mnemonic: str, op: str) -> bool:
    """An opcode names an instruction and, after dots, modifiers it must
    carry: ``HGMMA`` matches every ``HGMMA.64x...``, ``HMMA.TF32`` every
    ``HMMA`` with a ``TF32`` modifier (``HMMA.1688.F32.TF32``)."""
    name, *mods = mnemonic.split(".")
    op_name, *op_mods = op.split(".")
    return name == op_name and all(m in mods for m in op_mods)


def parse_sass(text: str, opcodes) -> dict:
    """The counts of ``sass_counts`` from cuobjdump's text."""
    counts, fn = {}, None
    ops = tuple(opcodes)
    for line in text.splitlines():
        if m := _SASS_FN.match(line):
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None and "/*" in line:
            # "        /*0a40*/                   HGMMA.64x64x16.F32.BF16 ..."
            body = line.split("*/", 1)[-1].split(";", 1)[0].split()
            for word in body:
                if word.startswith("@"):
                    continue  # a predicate guard
                for op in ops:
                    if _matches(word, op):
                        counts[fn][op] += 1
                break
    return counts


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.itsd_error_string.argtypes = (ctypes.c_int,)
    lib.itsd_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds: list) -> str:
    """Run ``cmds`` side by side; return their joined output, or raise with
    the output of the first that failed. Every process is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{out}")
    return "".join(outs)


@functools.cache
def load() -> Kernels:
    """Build (if needed) and load the kernels' shared library, once per
    process."""
    out_dir = BUILD_ROOT / f"kernels-{source_hash()}"
    path = out_dir / LIB_NAME
    if path.is_file():
        return Kernels(_bind(path), path, False, 0.0, ())
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp-{os.getpid()}"
    tmp.mkdir()
    nvcc = find_nvcc()
    try:
        t0 = time.perf_counter()
        report = _run_all(compile_commands(nvcc, tmp))
        _run_all([link_command(nvcc, tmp, tmp / LIB_NAME)])
        seconds = time.perf_counter() - t0
        os.replace(tmp / LIB_NAME, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Kernels(_bind(path), path, True, seconds, parse_ptxas(report))


def check(kernels: Kernels, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        text = kernels.lib.itsd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({text}) at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
