"""Single-head spatial self-attention over H*W tokens, forward and backward.

Counterpart of ``itsd_tpu/kernels/attention.py``: ``attention_plain`` is
``_attention_xla``, ``attention_plain_stats`` adds the per-row log-sum-exp of
``_attention_flash_stats``, and ``attention_bwd_plain`` is the blockwise
backward ``_attention_flash_bwd`` written with explicit [B, N, N] matrices.
The CUDA kernels replace the Pallas ones: the forward ``_flash_fwd_kernel``
and the backward ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``.
``flash_attention`` ties them together as a ``torch.autograd.Function``, as
``_flash_attention_diff`` does with ``jax.custom_vjp``.

Each of the three functions has three kernels (the forward four), and
``route`` picks one from the function, the dtype and C:
* "mma": bf16 with C % 16 == 0 and C <= 256, on the tensor cores with
  Hopper's wgmma, TMA and mbarriers (``csrc/flash_attention_hopper.cu``,
  ``csrc/flash_attention_bwd_dq_hopper.cu``,
  ``csrc/flash_attention_bwd_dkv_hopper.cu``);
* "wide": bf16 with C % 16 == 0 and 256 < C <= 1024, on the tensor cores
  with the head dimension split over column owners: the forward and dk/dv
  on Hopper's wgmma, TMA and mbarriers, two warpgroups a block and the
  ranks of a thread-block cluster, each owner recomputing the scores over
  all of C (``csrc/flash_attention_wide_hopper.cu``,
  ``csrc/flash_attention_bwd_dkv_wide_hopper.cu``), dq on mma.sync with the
  head dimension split across warps (``csrc/flash_attention_bwd_dq_wide.cu``):
  the CFG UNet's C=512 and C=1024 and the flagship's C=384;
* "tf32x3": the f32 forward (C % 4 == 0 up to 1024), on the tensor cores
  with f32-accurate products: each f32 operand split as hi + lo in TF32
  and three TF32 products a product, f32 accumulation
  (``csrc/flash_attention_tf32x3.cu``), so that f32 keeps its accuracy at
  the tensor cores' rate;
* "simt": everything else the kernels take (C % 4 == 0 up to 1024): bf16
  at C % 16 != 0, and the f32 dq and dk/dv, on the CUDA cores in f32
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``);
* "plain": the widths no kernel takes (C % 4 != 0 or C > 1024), whatever
  the dtype: the plain versions, computed on the card, as JAX computes
  ``_attention_xla`` wherever ``_flash_eligible`` fails. The width alone
  decides it; these calls count in ``plain_calls``, not in the launches.

The mma.sync kernels that the Hopper kernels replaced
(``csrc/flash_attention_mma.cu``, ``csrc/flash_attention_bwd_dq_mma.cu``,
``csrc/flash_attention_bwd_mma.cu``; on the wide route
``csrc/flash_attention_wide.cu`` and ``csrc/flash_attention_bwd_wide.cu``)
stay in the library as their same-call yardsticks: only the forced calls
``_flash_mma_sync``, ``_flash_bwd_dq_mma_sync``, ``_flash_bwd_dkv_mma_sync``,
``_flash_wide_sync`` and ``_flash_bwd_dkv_wide_sync`` reach them (tests and
``chip_smoke.py``), as ``_flash_simt`` and the other ``_simt`` calls force
the CUDA-core kernels (the f32 forward's yardstick too); no path routes
there.

Every entry point dispatches on where its inputs lie: CPU tensors go to the
plain versions, CUDA tensors to the kernels, and anything the kernels do not
take raises. A failed build or launch raises; nothing gives way to another
route. Every kernel puts the batch in ``gridDim.y``, which CUDA caps at
65,535, so a larger batch raises (``check_batch``) before any launch.

``spatial_attention`` also takes the model's ``attention_impl``: "auto"
(unless ``ITSD_ATTN_IMPL`` says otherwise) and "flash" take the path above;
"xla" takes the plain version on any device, and only when asked for;
"ring" splits the tokens over the seq ranks of the registered layout, or
without one over every rank, as JAX's default (``kernels.ring_attention``,
the global view; tokens that do not tile warn and run unsharded, through
the kernels). The global view needs every seq rank to hold the same
q, k and v: where the ranks hold different rows of a batch and no layout
is registered (a rank's window of rows, ``parallel.on_local_rows``: the
searches, Picard), "ring" is the local call. When the activations are row
shards of the images (``parallel.spatial.row_shards``: a rank's rows are
a contiguous share of the H-major tokens), every impl goes around the
ring, as JAX's "auto" routes through the ring under a spatial mesh; "xla"
then runs each hop through the plain versions. ``mha_attention`` folds
the heads of multi-head attention into the batch, as the ViT needs.
"""

from __future__ import annotations

import os
import warnings

import torch

from ..parallel import default_seq_mesh, get_seq_mesh, row_windows
from ..parallel.spatial import row_shard_mesh
from . import _build

# Kernel launches so far: the forward (both entry points, every route), the
# dq kernel and the dk/dv kernel (every route), and of those the ones on
# the "mma", "wide" and (the forward) "tf32x3" routes, and the forced calls
# of the mma.sync forward,
# dq and dk/dv (and of the wide route's mma.sync forward and dk/dv). A run
# resets them to check what went through the kernels. ``plain_calls``
# counts the calls of the "plain" route on CUDA tensors, which launch no
# kernel of this module.
launches = 0
mma_launches = 0
wide_launches = 0
tf32x3_launches = 0
mma_sync_launches = 0
wide_sync_launches = 0
dq_launches = 0
dq_mma_launches = 0
dq_wide_launches = 0
dq_mma_sync_launches = 0
dkv_launches = 0
dkv_mma_launches = 0
dkv_wide_launches = 0
dkv_mma_sync_launches = 0
dkv_wide_sync_launches = 0
plain_calls = 0

MAX_C = 1024  # kMaxC of csrc/flash_attention.cu, flash_attention_bwd.cu
#               and flash_attention_tf32x3.cu
MMA_MAX_C = 256  # kMaxC of the csrc/flash_attention*_mma.cu kernels
WIDE_MAX_C = 1024  # kMaxC of the csrc/flash_attention*_wide.cu kernels
KERNELS = ("forward", "dq", "dkv")
MAX_GRID_Y = 65535  # CUDA's cap on gridDim.y, where every kernel puts B


def check_batch(B: int) -> None:
    """Raise unless a batch of ``B`` fits one launch: every kernel puts the
    batch in ``gridDim.y``, which CUDA caps at ``MAX_GRID_Y``."""
    if B > MAX_GRID_Y:
        raise ValueError(f"attention: the kernels take a batch of at most "
                         f"{MAX_GRID_Y} (CUDA's gridDim.y cap), got {B}")


def route(dtype: torch.dtype, C: int, kernel: str) -> str:
    """The kernel a CUDA call of ``kernel`` ("forward", "dq" or "dkv")
    takes: "plain" (the plain version, no kernel) for C % 4 != 0 or
    C > 1024, whatever the dtype; "mma" (tensor cores) for bf16 with
    C % 16 == 0 and C <= 256; "wide" (tensor cores, the head dimension
    split over column owners) for bf16 with C % 16 == 0 and
    256 < C <= 1024; "tf32x3" (tensor cores, f32-accurate products) for
    the f32 forward; "simt" (CUDA cores, f32 arithmetic) for the rest."""
    if kernel not in KERNELS:
        raise ValueError(f"route: kernel must be one of {KERNELS}, got "
                         f"{kernel!r}")
    if C % 4 or C > MAX_C:
        return "plain"
    if dtype == torch.float32 and kernel == "forward":
        return "tf32x3"
    if dtype != torch.bfloat16 or C % 16:
        return "simt"
    if C <= MMA_MAX_C:
        return "mma"
    return "wide"


def _plain(fn, *args):
    """A "plain" route's call: ``fn`` (a plain version) on ``args``,
    counted in ``plain_calls``."""
    global plain_calls
    plain_calls += 1
    return fn(*args)


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


def _check(q, k, v, *more):
    """Raise unless the kernels take q, k, v (and the [B, N, C] tensors
    ``more``, such as dO)."""
    ts = (q, k, v, *more)
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(
            "attention: q, k, v must share one [B, N, C] shape, got "
            f"{[tuple(t.shape) for t in ts]}")
    if q.dtype not in _build.DTYPE_CODES or any(t.dtype != q.dtype
                                                for t in ts):
        raise TypeError("attention: kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("attention: q, k, v must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("attention: q, k, v must be 16-byte aligned (the "
                         "kernel loads 4 elements at once)")
    check_batch(q.shape[0])
    C = q.shape[-1]
    if C % 4 or C > MAX_C:
        raise ValueError(f"attention: kernel takes C % 4 == 0, C <= {MAX_C}; "
                         f"got C={C}")


def _entry(kernels, base, which):
    """The C entry point of a route's kernel: ``base`` for "simt",
    ``base_mma``, ``base_wide`` or ``base_tf32x3`` for the tensor-core ones
    (and
    ``base_mma_sync`` or ``base_wide_sync`` for the mma.sync kernels'
    forced calls)."""
    name = base if which == "simt" else f"{base}_{which}"
    return getattr(kernels.lib, name), name


def _launch_forward(q, k, v, scale, emit_lse, which):
    global launches, mma_launches, wide_launches, mma_sync_launches
    global wide_sync_launches, tf32x3_launches
    _check(q, k, v)
    B, N, C = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, N), dtype=torch.float32, device=q.device)
           if emit_lse else None)
    kernels = _build.load()
    entry, name = _entry(kernels, "itsd_flash_attention", which)
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr() if emit_lse else None, B, N, C, scale,
                   _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q))
    _build.check(kernels, rc, name)
    launches += 1
    mma_launches += which == "mma"
    wide_launches += which == "wide"
    tf32x3_launches += which == "tf32x3"
    mma_sync_launches += which == "mma_sync"
    wide_sync_launches += which == "wide_sync"
    return (o, lse) if emit_lse else o


def _flash(q, k, v, scale, emit_lse):
    """The forward through the kernel ``route`` names, or the plain version
    at a width no kernel takes."""
    which = route(q.dtype, q.shape[-1], "forward")
    if which == "plain":
        return _plain(attention_plain_stats if emit_lse else attention_plain,
                      q, k, v, scale)
    return _launch_forward(q, k, v, scale, emit_lse, which)


def _flash_simt(q, k, v, scale, emit_lse):
    """The forward through the CUDA-core kernel whatever the route, so that
    it can be held and timed on the same inputs as the tensor-core kernels
    (bf16, and f32 beside the "tf32x3" kernel that replaced it there). No
    path of the program calls it."""
    return _launch_forward(q, k, v, scale, emit_lse, "simt")


def _require_cuda(q, what):
    """Raise unless ``q`` lies on a CUDA device: a forced call has no plain
    version to fall back to."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: launches a CUDA kernel; it takes CUDA "
                         f"tensors only, got {q.device}")


def _flash_mma_sync(q, k, v, scale, emit_lse):
    """The forward through the mma.sync kernel that the Hopper kernel
    replaced on the "mma" route (bf16, C % 16 == 0, C <= 256), so that the
    two can be held and timed on the same inputs. No path of the program
    calls it."""
    _require_cuda(q, "_flash_mma_sync")
    return _launch_forward(q, k, v, scale, emit_lse, "mma_sync")


def _flash_wide_sync(q, k, v, scale, emit_lse):
    """The forward through the mma.sync kernel that the Hopper kernel
    replaced on the "wide" route (bf16, C % 16 == 0, 256 < C <= 1024), so
    that the two can be held and timed on the same inputs. No path of the
    program calls it."""
    _require_cuda(q, "_flash_wide_sync")
    return _launch_forward(q, k, v, scale, emit_lse, "wide_sync")


def row_dd(o, do, dlse=None):
    """dd = rowsum(dO * O) - dlse, f32 [B, N]: the softmax Jacobian's
    diagonal term, taken outside the kernels (as JAX takes it outside
    Pallas)."""
    dd = (do.float() * o.float()).sum(-1)
    return dd if dlse is None else dd - dlse.float()


def _p_ds(q, k, v, do, lse, dd, scale):
    """p = exp(s - lse) and ds = p * (dO.v^T - dd), f32 [B, N, N]."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dp = torch.einsum("bqc,bkc->bqk", do.float(), v.float())
    return p, p * (dp - dd[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, dd, scale):
    """The dq kernel's function on explicit [B, N, N] matrices:
    dq = scale * ds.k, with ds rounded to the input dtype first."""
    _, ds = _p_ds(q, k, v, do, lse, dd, scale)
    dq = scale * torch.einsum("bqk,bkc->bqc", ds.to(k.dtype).float(),
                              k.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, dd, scale):
    """The dk/dv kernel's function on explicit [B, N, N] matrices:
    dk = scale * ds^T.q and dv = p^T.dO, with ds and p rounded to the input
    dtype first."""
    p, ds = _p_ds(q, k, v, do, lse, dd, scale)
    dk = scale * torch.einsum("bqk,bqc->bkc", ds.to(q.dtype).float(),
                              q.float())
    dv = torch.einsum("bqk,bqc->bkc", p.to(do.dtype).float(), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float, dlse=None):
    """(dq, dk, dv) of single-head attention from the forward's ``o`` and
    f32 ``lse`` [B, N], with the kernels' formula and roundings on explicit
    [B, N, N] matrices: dd = rowsum(dO*O) - dlse, p = exp(s - lse),
    ds = p*(dO.v^T - dd), dq = scale*ds.k, dk = scale*ds^T.q, dv = p^T.dO,
    where ds and p are rounded to the input dtype before their products.
    ``dlse`` is the optional cotangent of lse ([B, N])."""
    dd = row_dd(o, do, dlse)
    return (flash_bwd_dq_plain(q, k, v, do, lse, dd, scale),
            *flash_bwd_dkv_plain(q, k, v, do, lse, dd, scale))


def _on_cpu(q) -> bool:
    """True for the plain version (CPU), False for the kernel (CUDA)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: no path for device {q.device}")
    return q.device.type == "cpu"


def attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float):
    """(o, lse): attention plus the f32 per-row log-sum-exp ``[B, N]`` that
    the blockwise backward and the ring merge need. Not differentiable:
    ``flash_attention`` is."""
    if _on_cpu(q):
        return attention_plain_stats(q, k, v, scale)
    return _flash(q, k, v, scale, emit_lse=True)


def _check_rows(t, q, what):
    B, N = q.shape[:2]
    if (t.shape != (B, N) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"attention: {what} must be contiguous f32 "
                         f"[{B}, {N}] on {q.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch_dq(q, k, v, do, lse, dd, scale, which):
    global dq_launches, dq_mma_launches, dq_wide_launches
    global dq_mma_sync_launches
    _check(q, k, v, do)
    _check_rows(lse, q, "lse")
    _check_rows(dd, q, "dd")
    B, N, C = q.shape
    dq = torch.empty_like(q)
    kernels = _build.load()
    entry, name = _entry(kernels, "itsd_flash_bwd_dq", which)
    with torch.cuda.device(q.device):
        rc = entry(*(t.data_ptr() for t in (q, k, v, do, lse, dd, dq)), B, N,
                   C, scale, _build.DTYPE_CODES[q.dtype],
                   _build.stream_ptr(q))
    _build.check(kernels, rc, name)
    dq_launches += 1
    dq_mma_launches += which == "mma"
    dq_wide_launches += which == "wide"
    dq_mma_sync_launches += which == "mma_sync"
    return dq


def flash_bwd_dq(q, k, v, do, lse, dd, scale):
    """dq through the dq kernel ``route`` names (CUDA tensors only), or the
    plain version at a width no kernel takes."""
    which = route(q.dtype, q.shape[-1], "dq")
    if which == "plain":
        return _plain(flash_bwd_dq_plain, q, k, v, do, lse, dd, scale)
    return _launch_dq(q, k, v, do, lse, dd, scale, which)


def _flash_bwd_dq_simt(q, k, v, do, lse, dd, scale):
    """dq through the CUDA-core kernel whatever the route, so that it can
    be held and timed on the same bf16 inputs as the tensor-core kernels.
    No path of the program calls it."""
    return _launch_dq(q, k, v, do, lse, dd, scale, "simt")


def _flash_bwd_dq_mma_sync(q, k, v, do, lse, dd, scale):
    """dq through the mma.sync kernel that the Hopper kernel replaced on
    the "mma" route, so that the two can be held and timed on the same
    inputs. No path of the program calls it."""
    _require_cuda(q, "_flash_bwd_dq_mma_sync")
    return _launch_dq(q, k, v, do, lse, dd, scale, "mma_sync")


def _launch_dkv(q, k, v, do, lse, dd, scale, which):
    global dkv_launches, dkv_mma_launches, dkv_wide_launches
    global dkv_mma_sync_launches, dkv_wide_sync_launches
    _check(q, k, v, do)
    _check_rows(lse, q, "lse")
    _check_rows(dd, q, "dd")
    B, N, C = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernels = _build.load()
    entry, name = _entry(kernels, "itsd_flash_bwd_dkv", which)
    with torch.cuda.device(q.device):
        rc = entry(*(t.data_ptr() for t in (q, k, v, do, lse, dd, dk, dv)),
                   B, N, C, scale, _build.DTYPE_CODES[q.dtype],
                   _build.stream_ptr(q))
    _build.check(kernels, rc, name)
    dkv_launches += 1
    dkv_mma_launches += which == "mma"
    dkv_wide_launches += which == "wide"
    dkv_mma_sync_launches += which == "mma_sync"
    dkv_wide_sync_launches += which == "wide_sync"
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, dd, scale):
    """(dk, dv) through the dk/dv kernel ``route`` names (CUDA tensors
    only), or the plain version at a width no kernel takes."""
    which = route(q.dtype, q.shape[-1], "dkv")
    if which == "plain":
        return _plain(flash_bwd_dkv_plain, q, k, v, do, lse, dd, scale)
    return _launch_dkv(q, k, v, do, lse, dd, scale, which)


def _flash_bwd_dkv_simt(q, k, v, do, lse, dd, scale):
    """(dk, dv) through the CUDA-core kernel whatever the route, so that
    it can be held and timed on the same bf16 inputs as the tensor-core
    kernels. No path of the program calls it."""
    return _launch_dkv(q, k, v, do, lse, dd, scale, "simt")


def _flash_bwd_dkv_mma_sync(q, k, v, do, lse, dd, scale):
    """(dk, dv) through the mma.sync kernel that the Hopper kernel replaced
    on the "mma" route, so that the two can be held and timed on the same
    inputs. No path of the program calls it."""
    _require_cuda(q, "_flash_bwd_dkv_mma_sync")
    return _launch_dkv(q, k, v, do, lse, dd, scale, "mma_sync")


def _flash_bwd_dkv_wide_sync(q, k, v, do, lse, dd, scale):
    """(dk, dv) through the mma.sync kernel that the Hopper kernel replaced
    on the "wide" route, so that the two can be held and timed on the same
    inputs. No path of the program calls it."""
    _require_cuda(q, "_flash_bwd_dkv_wide_sync")
    return _launch_dkv(q, k, v, do, lse, dd, scale, "wide_sync")


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float, dlse=None):
    """(dq, dk, dv): ``attention_bwd_plain`` for CPU tensors and, on the
    "plain" route, for CUDA tensors; else dd in PyTorch, then the dq kernel
    and the dk/dv kernel that ``route`` names."""
    if _on_cpu(q):
        return attention_bwd_plain(q, k, v, o, lse, do, scale, dlse)
    if route(q.dtype, q.shape[-1], "dq") == "plain":
        return _plain(attention_bwd_plain, q, k, v, o, lse, do, scale, dlse)
    dd = row_dd(o, do, dlse).contiguous()
    return (flash_bwd_dq(q, k, v, do, lse, dd, scale),
            *flash_bwd_dkv(q, k, v, do, lse, dd, scale))


class _FlashAttention(torch.autograd.Function):
    """Forward through ``attention_with_lse`` (saving q, k, v, o and lse),
    backward through ``attention_bwd``: the counterpart of
    ``_flash_attention_diff``, with the lse output differentiable too."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_with_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.scale, dlse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float):
    """Differentiable (o, lse) over ``[B, N, C]``; gradients flow into q, k
    and v from both outputs."""
    return _FlashAttention.apply(q, k, v, scale)


IMPLS = ("auto", "flash", "xla", "ring")


def resolve_impl(impl: str = "auto") -> str:
    """The path of an attention call: ``impl`` as given ("flash": the
    kernels on CUDA tensors; "xla": the plain version, at the user's
    explicit request only; "ring": the sequence-sharded path), or for
    "auto" the environment's ``ITSD_ATTN_IMPL`` (default "auto", which
    takes the kernels), as ``itsd_tpu/kernels/attention.py:spatial_attention``
    reads it."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl: {impl!r}; expected one "
                         f"of {IMPLS}")
    if impl == "auto":
        impl = os.environ.get("ITSD_ATTN_IMPL", "auto")
        if impl not in IMPLS:
            raise ValueError(f"unknown ITSD_ATTN_IMPL={impl!r}; expected "
                             f"one of {IMPLS}")
    return "flash" if impl == "auto" else impl


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    path: str = "flash") -> torch.Tensor:
    """One device's attention over all of ``[B, N, C]``, scale
    ``C ** -0.5``: "xla" the plain version; "flash" the kernels on CUDA
    tensors (through ``flash_attention`` when a gradient is wanted, else
    the forward alone, without the lse), the plain version (its gradient
    autograd's) on CUDA tensors of a width no kernel takes, as JAX's
    ``_attention_xla`` outside ``_flash_eligible``, and the plain version
    on the CPU."""
    scale = float(q.shape[-1]) ** -0.5
    if path == "xla":
        return attention_plain(q, k, v, scale)
    if (not _on_cpu(q)
            and route(q.dtype, q.shape[-1], "forward") == "plain"):
        return _plain(attention_plain, q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention(q, k, v, scale)[0]
    if _on_cpu(q):
        return attention_plain(q, k, v, scale)
    return _flash(q, k, v, scale, emit_lse=False)


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """Single-head attention over ``[B, N, C]`` tokens with scale
    ``C ** -0.5``, as the reference's AttnBlock, on the path
    ``resolve_impl(impl)`` names (see the module docstring for the ring).
    Differentiable on every path."""
    from .ring_attention import ring_attention, sequence_sharded_attention

    path = resolve_impl(impl)
    rows = row_shard_mesh()
    if rows is not None:
        return ring_attention(q, k, v, rows, plain=path == "xla")
    if path != "ring":
        return local_attention(q, k, v, path)
    mesh = get_seq_mesh()
    if mesh is None and not row_windows():
        mesh = default_seq_mesh()
    if mesh is None or mesh.seq == 1:
        return local_attention(q, k, v, "flash")
    if q.shape[1] % mesh.seq:
        warnings.warn(
            f"attention_impl=ring: the token count ({q.shape[1]}) does not "
            f"tile over the seq axis ({mesh.seq} ranks): running it "
            "unsharded", stacklevel=2)
        return local_attention(q, k, v, "flash")
    return sequence_sharded_attention(q, k, v, mesh)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Multi-head attention, q, k, v ``[B, N, H, D]`` -> ``[B, N, H, D]``:
    the heads folded into the batch (``[B*H, N, D]``), then
    ``spatial_attention``, as ``itsd_tpu/kernels/attention.py:
    mha_attention``."""
    B, N, H, D = q.shape

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, N, D)

    out = spatial_attention(fold(q), fold(k), fold(v), impl=impl)
    return out.reshape(B, H, N, D).transpose(1, 2)
