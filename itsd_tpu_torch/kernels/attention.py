"""Single-head spatial self-attention over H*W tokens.

Counterpart of ``itsd_tpu/kernels/attention.py``: ``attention_plain`` is
``_attention_xla``, ``attention_plain_stats`` adds the per-row log-sum-exp of
``_attention_flash_stats``, and the CUDA kernel (``csrc/flash_attention.cu``)
replaces the Pallas ``_flash_fwd_kernel``.

``spatial_attention`` and ``attention_with_lse`` dispatch on where their
inputs lie: CPU tensors go to the plain versions, CUDA tensors to the kernel,
and anything the kernel does not take raises.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches so far (both entry points); a run resets it to check what
# went through the kernel.
launches = 0

MAX_C = 512  # csrc/flash_attention.cu: kMaxC


def _scores(q, k, scale):
    # f32 products of the inputs' values, f32 accumulation
    return torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * scale


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """[B, N, C] attention through the explicit score matrix; the softmax
    weights are cast to ``v.dtype`` before the product, as
    ``_attention_xla``."""
    w = torch.softmax(_scores(q, k, scale), dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkc->bqc", w.float(), v.float()).to(v.dtype)


def attention_plain_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """``attention_plain`` plus the f32 per-row log-sum-exp ``[B, N]`` of
    the scaled scores."""
    s = _scores(q, k, scale)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", w.float(), v.float()).to(v.dtype)
    return o, torch.logsumexp(s, dim=-1)


def _check(q, k, v):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "attention: q, k, v must share one [B, N, C] shape, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("attention: kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype} {k.dtype} {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("attention: q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k, v must be 16-byte aligned (the "
                         "kernel loads 4 elements at once)")
    C = q.shape[-1]
    if C % 4 or C > MAX_C:
        raise ValueError(f"attention: kernel takes C % 4 == 0, C <= {MAX_C}; "
                         f"got C={C}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("attention: the kernel has no backward yet; call "
                           "it under torch.no_grad()")


def _flash(q, k, v, scale, emit_lse):
    global launches
    _check(q, k, v)
    B, N, C = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, N), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    kernels = _build.load()
    with torch.cuda.device(q.device):
        rc = kernels.lib.itsd_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if emit_lse else None, B, N, C, scale,
            _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(kernels, rc, "flash_attention")
    launches += 1
    return (o, lse) if emit_lse else o


def _on_cpu(q) -> bool:
    """True for the plain version (CPU), False for the kernel (CUDA)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no path for device {q.device}")
    return q.device.type == "cpu"


def spatial_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Single-head attention over ``[B, N, C]`` tokens with scale
    ``C ** -0.5``, as the reference's AttnBlock."""
    scale = float(q.shape[-1]) ** -0.5
    if _on_cpu(q):
        return attention_plain(q, k, v, scale)
    return _flash(q, k, v, scale, emit_lse=False)


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float):
    """(o, lse): attention plus the f32 per-row log-sum-exp ``[B, N]`` that
    the blockwise backward and the ring merge need."""
    if _on_cpu(q):
        return attention_plain_stats(q, k, v, scale)
    return _flash(q, k, v, scale, emit_lse=True)
