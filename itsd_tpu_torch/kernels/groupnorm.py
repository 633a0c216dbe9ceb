"""Fused GroupNorm(+swish), the UNet's per-block prologue.

Counterpart of ``itsd_tpu/kernels/groupnorm.py``. The port keeps activations
in NCHW, where one (sample, group) pair is one contiguous span of memory:
the CUDA kernel (``csrc/groupnorm.cu``) gives each span one block.

``groupnorm_swish`` dispatches on where its input lies: a CPU tensor goes to
``groupnorm_swish_plain``, a CUDA tensor to the kernel, and anything the
kernel does not take raises.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches so far; a run resets it to check what went through the
# kernel.
launches = 0


def groupnorm_swish_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, groups: int, eps: float = 1e-5,
                          act: bool = True) -> torch.Tensor:
    """NCHW GroupNorm (+swish) with two-pass f32 statistics, cast back to
    ``x.dtype``: the counterpart of ``groupnorm_swish_xla``."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    var = (xf - mean).square().mean(dim=2, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, -1)
    y = y * weight.float()[:, None] + bias.float()[:, None]
    if act:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _check(x, weight, bias, groups):
    if x.dim() != 4:
        raise ValueError(
            f"groupnorm_swish: want NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(
            f"groupnorm_swish: kernel takes f32 or bf16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_swish: x must be contiguous NCHW")
    C = x.shape[1]
    if groups <= 0 or C % groups:
        raise ValueError(
            f"groupnorm_swish: {groups} groups do not divide C={C}")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.shape != (C,) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(
                f"groupnorm_swish: {name} must be contiguous f32 [{C}] on "
                f"{x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("groupnorm_swish: the kernel has no backward yet; "
                           "call it under torch.no_grad()")


def groupnorm_swish(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float = 1e-5,
                    act: bool = True) -> torch.Tensor:
    """GroupNorm over NCHW ``x`` with f32 ``weight``/``bias`` [C], then swish
    when ``act``; returns ``x.dtype``."""
    global launches
    if x.device.type == "cpu":
        return groupnorm_swish_plain(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_swish: no path for device {x.device}")
    _check(x, weight, bias, groups)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    kernels = _build.load()
    with torch.cuda.device(x.device):
        rc = kernels.lib.itsd_groupnorm_swish(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            B, C, H * W, groups, eps, int(act), _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x))
    _build.check(kernels, rc, "groupnorm_swish")
    launches += 1
    return y
