"""Fused GroupNorm(+swish), the UNet's per-block prologue.

Counterpart of ``itsd_tpu/kernels/groupnorm.py``. The port keeps activations
in NCHW, where one (sample, group) pair is one contiguous span of memory:
the CUDA kernel (``csrc/groupnorm.cu``) reads each span once, gives small
spans a few threads, mid-sized ones a block, and splits the largest over a
thread-block cluster; it picks that plan from the shape alone.

``groupnorm_swish`` dispatches on where its input lies: a CPU tensor goes to
``groupnorm_swish_plain``, a CUDA tensor to the kernel, and anything the
kernel does not take raises. When a gradient is wanted it goes through an
``autograd.Function`` whose backward recomputes through the plain version,
as ``_gn_diff_bwd`` recomputes through ``groupnorm_swish_xla`` with
``jax.vjp``: the JAX package has no Pallas backward for GroupNorm.

Over row shards (``parallel.spatial``: each seq rank holds some rows of an
image) a span's statistics need every rank's rows. ``groupnorm_swish_rows``
takes them in the two passes ``groupnorm_swish_plain`` takes over the whole
image: this rank's partial sums (the stats kernel,
``itsd_groupnorm_partial_stats``), an all-reduce over the seq ranks, the
mean; the partial sums of squared deviations around it, an all-reduce, the
rstd; then the normalization, affine and swish (the apply kernel,
``itsd_groupnorm_apply``). Its backward recomputes through the same
sequence in PyTorch (``groupnorm_swish_rows_plain``), whose all-reduce is
differentiable. The stats kernel has a launch plan of its own, made for a
streaming reduction; the earlier one, on the fused kernel's plan, stays in
the library as its yardstick (``itsd_groupnorm_partial_stats_cluster``),
which only the forced call ``_groupnorm_partial_stats_cluster`` reaches
(tests and ``chip_smoke.py``); ``_groupnorm_stats_floor`` launches an
empty kernel on the new plan's grid: what a launch costs whatever it does.
"""

from __future__ import annotations

import torch

from ..parallel.spatial import all_reduce_sum
from . import _build

# Kernel launches so far: the fused kernel, the stats and apply kernels of
# row shards, and the forced calls of the earlier stats kernel; a run resets
# them to check what went through the kernels.
launches = 0
stats_launches = 0
apply_launches = 0
stats_cluster_launches = 0


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
    _check_x(x, groups)
    C = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.shape != (C,) or p.dtype != torch.float32
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(
                f"groupnorm_swish: {name} must be contiguous f32 [{C}] on "
                f"{x.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")


def _check_x(x, groups):
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


def _forward(x, weight, bias, groups, eps, act):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
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


class _GroupNormSwish(torch.autograd.Function):
    """Forward through ``_forward`` (saving only its inputs); backward
    through the plain version, recomputed under ``enable_grad``. The grads
    of weight and bias come back in f32, the grad of x in ``x.dtype``."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (groups, eps, act)
        return _forward(x, weight, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = groupnorm_swish_plain(*inputs, *ctx.args)
        gx, gw, gb = torch.autograd.grad(y, inputs, gy)
        return gx, gw, gb, None, None, None


def groupnorm_swish(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float = 1e-5,
                    act: bool = True) -> torch.Tensor:
    """GroupNorm over NCHW ``x`` with f32 ``weight``/``bias`` [C], then swish
    when ``act``; returns ``x.dtype``. Differentiable in x, weight and
    bias."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSwish.apply(x, weight, bias, groups, eps, act)
    return _forward(x, weight, bias, groups, eps, act)


# ---------------------------------------------------------------------------
# GroupNorm over row shards


def groupnorm_partial_stats_plain(x: torch.Tensor, groups: int,
                                  mean=None) -> torch.Tensor:
    """[B, G] f32: each (sample, group) span's sum of ``x``, or, given
    ``mean`` [B, G], its sum of ``(x - mean)^2``."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    if mean is None:
        return xf.sum(dim=2)
    return (xf - mean[..., None]).square().sum(dim=2)


def groupnorm_apply_plain(x: torch.Tensor, mean: torch.Tensor,
                          rstd: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, groups: int,
                          act: bool = True) -> torch.Tensor:
    """``x`` normalized with the given [B, G] mean and rstd, then the
    affine and swish (when ``act``), in f32, cast back to ``x.dtype``."""
    B, C = x.shape[:2]
    xf = x.float().reshape(B, groups, -1)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(B, C, -1)
    y = y * weight.float()[:, None] + bias.float()[:, None]
    if act:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def _check_stats(t, x, groups, what):
    B = x.shape[0]
    if (t.shape != (B, groups) or t.dtype != torch.float32
            or t.device != x.device or not t.is_contiguous()):
        raise ValueError(f"groupnorm: {what} must be contiguous f32 "
                         f"[{B}, {groups}] on {x.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch_stats(x, groups, mean, entry):
    """The stats kernel ``entry`` of csrc/groupnorm.cu on a CUDA ``x``."""
    _check_x(x, groups)
    if mean is not None:
        _check_stats(mean, x, groups, "mean")
    B, C, H, W = x.shape
    out = torch.empty((B, groups), dtype=torch.float32, device=x.device)
    kernels = _build.load()
    with torch.cuda.device(x.device):
        rc = getattr(kernels.lib, entry)(
            x.data_ptr(), None if mean is None else mean.data_ptr(),
            out.data_ptr(), B, C, H * W, groups,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(kernels, rc, entry.removeprefix("itsd_"))
    return out


def groupnorm_partial_stats(x: torch.Tensor, groups: int,
                            mean=None) -> torch.Tensor:
    """``groupnorm_partial_stats_plain`` for a CPU tensor, the stats kernel
    for a CUDA one; not differentiable."""
    global stats_launches
    if x.device.type == "cpu":
        return groupnorm_partial_stats_plain(x, groups, mean)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm: no path for device {x.device}")
    out = _launch_stats(x, groups, mean, "itsd_groupnorm_partial_stats")
    stats_launches += 1
    return out


def _require_cuda(x, what):
    """Raise unless ``x`` lies on a CUDA device: a forced call has no plain
    version to fall back to."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: launches a CUDA kernel; it takes CUDA "
                         f"tensors only, got {x.device}")


def _groupnorm_partial_stats_cluster(x: torch.Tensor, groups: int,
                                     mean=None) -> torch.Tensor:
    """``groupnorm_partial_stats`` through the earlier stats kernel, on the
    fused kernel's launch plan, so that the two can be held and timed on
    the same inputs. No path of the program calls it."""
    global stats_cluster_launches
    _require_cuda(x, "_groupnorm_partial_stats_cluster")
    out = _launch_stats(x, groups, mean,
                        "itsd_groupnorm_partial_stats_cluster")
    stats_cluster_launches += 1
    return out


def _groupnorm_stats_floor(x: torch.Tensor, groups: int) -> None:
    """Launch an empty kernel on the grid ``groupnorm_partial_stats`` would
    launch for ``x``: the least time any kernel of that plan takes on the
    card. A measurement only; no path of the program calls it."""
    _require_cuda(x, "_groupnorm_stats_floor")
    _check_x(x, groups)
    B, C, H, W = x.shape
    kernels = _build.load()
    with torch.cuda.device(x.device):
        rc = kernels.lib.itsd_groupnorm_stats_floor(
            x.data_ptr(), B, C, H * W, groups, _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x))
    _build.check(kernels, rc, "groupnorm_stats_floor")


def groupnorm_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, groups: int,
                    act: bool = True) -> torch.Tensor:
    """``groupnorm_apply_plain`` for a CPU tensor, the apply kernel for a
    CUDA one; not differentiable."""
    global apply_launches
    if x.device.type == "cpu":
        return groupnorm_apply_plain(x, mean, rstd, weight, bias, groups, act)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm: no path for device {x.device}")
    _check(x, weight, bias, groups)
    _check_stats(mean, x, groups, "mean")
    _check_stats(rstd, x, groups, "rstd")
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    kernels = _build.load()
    with torch.cuda.device(x.device):
        rc = kernels.lib.itsd_groupnorm_apply(
            x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), B, C, H * W, groups, int(act),
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(kernels, rc, "groupnorm_apply")
    apply_launches += 1
    return y


def _rows_count(x, groups, mesh) -> int:
    """The elements of a span over the whole image: each of the mesh's
    seq ranks holds as many rows."""
    return x[0].numel() // groups * mesh.seq


def groupnorm_swish_rows_plain(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, groups: int, eps: float,
                               act: bool, mesh) -> torch.Tensor:
    """GroupNorm (+swish) of the images whose rows ``mesh``'s seq ranks
    split, on this rank's rows: ``groupnorm_swish_plain``'s two passes with
    their sums all-reduced over the seq ranks, differentiable."""
    n = _rows_count(x, groups, mesh)
    group = mesh.seq_group
    mean = all_reduce_sum(groupnorm_partial_stats_plain(x, groups),
                          group) / n
    var = all_reduce_sum(groupnorm_partial_stats_plain(x, groups, mean),
                         group) / n
    return groupnorm_apply_plain(x, mean, torch.rsqrt(var + eps), weight,
                                 bias, groups, act)


def _rows_forward(x, weight, bias, groups, eps, act, mesh):
    """The plain version for a CPU tensor, the stats and apply kernels for
    a CUDA one."""
    if x.device.type == "cpu":
        return groupnorm_swish_rows_plain(x, weight, bias, groups, eps, act,
                                          mesh)
    n = _rows_count(x, groups, mesh)
    group = mesh.seq_group
    mean = all_reduce_sum(groupnorm_partial_stats(x, groups), group) / n
    var = all_reduce_sum(groupnorm_partial_stats(x, groups, mean), group) / n
    return groupnorm_apply(x, mean, torch.rsqrt(var + eps), weight, bias,
                           groups, act)


class _GroupNormSwishRows(torch.autograd.Function):
    """Forward through ``_rows_forward`` (saving only its inputs); backward
    through ``groupnorm_swish_rows_plain``, recomputed under
    ``enable_grad``, as ``_GroupNormSwish``: its all-reduces run again on
    every seq rank, in the same order."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, act, mesh):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (groups, eps, act, mesh)
        return _rows_forward(x, weight, bias, groups, eps, act, mesh)

    @staticmethod
    def backward(ctx, gy):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = groupnorm_swish_rows_plain(*inputs, *ctx.args)
        gx, gw, gb = torch.autograd.grad(y, inputs, gy)
        return gx, gw, gb, None, None, None, None


def groupnorm_swish_rows(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int, mesh,
                         eps: float = 1e-5, act: bool = True) -> torch.Tensor:
    """GroupNorm (+swish) over NCHW ``x``, this rank's rows of images whose
    rows the seq ranks of ``mesh`` (a ``parallel.SeqMesh``) split, with the
    statistics of the whole images; differentiable in x, weight and
    bias."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSwishRows.apply(x, weight, bias, groups, eps, act,
                                         mesh)
    return _rows_forward(x, weight, bias, groups, eps, act, mesh)
