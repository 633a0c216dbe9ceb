"""Image rows over the ``seq`` ranks: the exchanges of spatial sharding.

JAX has no counterpart of this module: under ``spatial_sharding`` (image
rows over the ``seq`` mesh axis) GSPMD partitions every convolution, with
a halo exchange for its windows, and reduces GroupNorm's statistics across
the axis. Here the UNet does both by hand when its activations are row
shards (``row_shards``): ``halo`` gives a convolution the rows of its
neighbours, ``all_reduce_sum`` sums GroupNorm's partial statistics, and
``kernels.ring_attention`` rotates keys and values around the same ranks.

A rank holds a contiguous block of the image rows of its batch rows: in
NHWC at axis 1, in NCHW at axis 2. ``image_rows`` cuts a global array to
this rank's block (batch rows over the mesh's data axis, image rows over
its seq axis) and ``gather_image`` puts the global array back on every
rank.

Every exchange is a collective that each rank of the group runs in the
same order: the halo's and the ring's point-to-point messages go through
``dist.batch_isend_irecv``, posted in one order on every rank. A gloo group
cannot send a CUDA tensor (an ``isend`` of one aborts the process: gloo
reads it as host memory), nor, by PyTorch's list of gloo's collectives,
gather one, so with gloo those messages and gathers (``mesh.gather_rows``)
are staged through host memory; gloo's all-reduce takes CUDA tensors, and
NCCL takes the device tensors as they are. Nothing falls back to an unsharded computation.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import RowDraws, SeqMesh, gather_rows, local_rows, row_window

# The layouts whose seq ranks split the activations' image rows now,
# innermost last (None: whole images); opened by ``row_shards``.
_ROW_SHARDS: list = []


@contextlib.contextmanager
def row_shards(mesh: Optional[SeqMesh]):
    """While the body runs, the model's activations are this rank's block
    of image rows of ``mesh``'s seq axis (``mesh`` None: whole images).
    Open it around the forward and the backward alike: a rematerialized
    block reruns its exchanges in the backward."""
    _ROW_SHARDS.append(mesh)
    try:
        yield mesh
    finally:
        _ROW_SHARDS.pop()


def row_shard_mesh() -> Optional[SeqMesh]:
    """The layout whose seq ranks (more than one) split the activations'
    image rows now, or None."""
    mesh = _ROW_SHARDS[-1] if _ROW_SHARDS else None
    return mesh if mesh is not None and mesh.seq > 1 else None


# ---------------------------------------------------------------------------
# collectives


def p2p(sends, recvs, group) -> list:
    """One ``batch_isend_irecv`` over ``group``: ``sends`` are (tensor,
    rank in the group, tag), ``recvs`` (shape, dtype, device, rank in the
    group, tag); returns the received tensors in the order of ``recvs``.
    A message is matched by its tag (gloo) or by its place among the
    messages between the two ranks (NCCL), so each pair of ranks must post
    them in one order with one tag each."""
    gloo = dist.get_backend(group) == "gloo"
    host = gloo and (any(t.is_cuda for t, _, _ in sends) or any(
        torch.device(dev).type == "cuda" for _, _, dev, _, _ in recvs))
    ops, bufs = [], []
    for t, peer, tag in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if host else t,
                              dist.get_global_rank(group, peer), group,
                              tag=tag))
    for shape, dtype, dev, peer, tag in recvs:
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host else dev)
        bufs.append((buf, dev))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group,
                              tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [buf.to(dev) if host else buf for buf, dev in bufs]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, as a new tensor (gloo
    sums a CUDA tensor itself)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks; its gradient is the sum of the
    ranks' gradients (every rank uses the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks; differentiable."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    return _all_reduce(t, group)


class _CutSeq(torch.autograd.Function):
    """This rank's share along ``dim`` of a tensor every seq rank holds
    whole; its gradient is gathered from every rank, so that a replicated
    computation gets the whole gradient on each (the converse of
    ``gather_rows``)."""

    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return local_rows(t, mesh.seq_group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.mesh.seq_group, ctx.dim), None, None


def cut_seq(t: torch.Tensor, dim: int, mesh: SeqMesh) -> torch.Tensor:
    """This seq rank's contiguous share of ``t`` along ``dim``."""
    if mesh.seq == 1:
        return t
    return _CutSeq.apply(t, dim, mesh)


def gather_seq(t: torch.Tensor, dim: int, mesh: SeqMesh) -> torch.Tensor:
    """The seq ranks' ``t`` concatenated along ``dim``, on every rank;
    differentiable (``gather_rows``)."""
    if mesh.seq == 1:
        return t
    return gather_rows(t, mesh.seq_group, dim)


# ---------------------------------------------------------------------------
# the halo exchange


_UP, _DOWN = 0, 1  # the tags of the messages to the previous / next rank


def _neighbours(mesh: SeqMesh):
    j = mesh.seq_rank
    return (j - 1 if j > 0 else None), (j + 1 if j < mesh.seq - 1 else None)


def _swap(up: Optional[torch.Tensor], down: Optional[torch.Tensor],
          up_shape, down_shape, mesh: SeqMesh, like: torch.Tensor):
    """Send ``up`` to the previous seq rank and ``down`` to the next (where
    they exist), and receive the next rank's ``up`` (``up_shape``) and the
    previous rank's ``down`` (``down_shape``); None where there is no
    neighbour or nothing to send. Between two neighbours there is at most
    one message each way."""
    prev, nxt = _neighbours(mesh)
    sends, recvs, which = [], [], []
    if prev is not None and up is not None:
        sends.append((up, prev, _UP))
    if nxt is not None and down is not None:
        sends.append((down, nxt, _DOWN))
    if nxt is not None and up_shape is not None:
        recvs.append((up_shape, like.dtype, like.device, nxt, _UP))
        which.append("from_next")
    if prev is not None and down_shape is not None:
        recvs.append((down_shape, like.dtype, like.device, prev, _DOWN))
        which.append("from_prev")
    got = dict(zip(which, p2p(sends, recvs, mesh.seq_group)))
    return got.get("from_next"), got.get("from_prev")


def _rows(x, lo, n):
    return x.narrow(2, lo, n) if n else None


def _halo_forward(x, top, bottom, mesh):
    B, C, h, W = x.shape
    if h < max(top, bottom):
        raise ValueError(f"halo: {h} rows a rank cannot give a halo of "
                         f"{max(top, bottom)}")
    below, above = _swap(_rows(x, 0, bottom), _rows(x, h - top, top),
                         (B, C, bottom, W) if bottom else None,
                         (B, C, top, W) if top else None, mesh, x)
    zeros = x.new_zeros
    return torch.cat([above if above is not None else zeros(B, C, top, W),
                      x,
                      below if below is not None else zeros(B, C, bottom,
                                                            W)], dim=2)


class _Halo(torch.autograd.Function):
    """``x`` [B, C, h, W] (this rank's rows) with ``top`` rows of the
    previous seq rank above and ``bottom`` rows of the next below; zeros
    at the image's top and bottom edges, which is a convolution's zero
    padding there. The backward sends the gradients of the halo rows back
    to the ranks that own them, which add them to their own."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        ctx.top, ctx.bottom, ctx.mesh = top, bottom, mesh
        return _halo_forward(x, top, bottom, mesh)

    @staticmethod
    def backward(ctx, g):
        top, bottom, mesh = ctx.top, ctx.bottom, ctx.mesh
        B, C, n, W = g.shape
        h = n - top - bottom
        gx = g.narrow(2, top, h).clone()
        # the gradient of the rows above goes up to their owner, that of
        # the rows below down; the owner adds what comes back
        from_next, from_prev = _swap(
            _rows(g, 0, top), _rows(g, top + h, bottom),
            (B, C, top, W) if top else None,
            (B, C, bottom, W) if bottom else None, mesh, g)
        if from_next is not None:
            gx[:, :, h - top:] += from_next
        if from_prev is not None:
            gx[:, :, :bottom] += from_prev
        return gx, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int,
         mesh: SeqMesh) -> torch.Tensor:
    """``x`` [B, C, h, W] with ``top`` rows from the previous seq rank and
    ``bottom`` from the next (zeros at the image's edges); differentiable.
    A halo of no rows (a window that never crosses a rank's rows, as the
    ViT's patch embedding) is ``x`` itself: no message, no copy."""
    if not top and not bottom:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Halo.apply(x, top, bottom, mesh)
    return _halo_forward(x, top, bottom, mesh)


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride,
                padding, mesh: SeqMesh) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding)`` of the whole image,
    on this rank's rows: an output row o reads input rows s*o - p to
    s*o - p + k - 1, so the rank's outputs need p rows from above and
    max(0, k - s - p) from below, and then no padding in H."""
    k, s, p = weight.shape[2], stride[0], padding[0]
    xp = halo(x, p, max(0, k - s - p), mesh)
    return F.conv2d(xp, weight, bias, stride, (0, padding[1]))


def halo_conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias,
                          stride, padding, output_padding,
                          mesh: SeqMesh) -> torch.Tensor:
    """``F.conv_transpose2d`` of the whole image (an output of s times the
    rows), on this rank's rows: its s*h output rows read input rows from
    (k - 1 - p) // s above its own to (p - 1) // s + 1 below. The
    transposed convolution of the rows with their halo, unpadded in H, is
    cut to the rank's outputs."""
    k, s, p = weight.shape[2], stride[0], padding[0]
    h = x.shape[2]
    top = (k - 1 - p) // s
    xp = halo(x, top, (p - 1) // s + 1, mesh)
    y = F.conv_transpose2d(xp, weight, bias, stride, (0, padding[1]),
                           (0, output_padding[1]))
    return y.narrow(2, p + s * top, s * h)


# ---------------------------------------------------------------------------
# images over the layout


def image_rows(x, mesh: SeqMesh, h_axis: Optional[int] = 1,
               batch: bool = True):
    """This rank's block of the global ``x`` (a tensor or a numpy array):
    its batch rows over the mesh's data axis (when ``batch``) and its
    image rows, axis ``h_axis``, over the seq axis (``h_axis`` None: batch
    rows only)."""
    if batch and mesh.data > 1:
        x = local_rows(x, mesh.data_group)
    if h_axis is not None and mesh.seq > 1:
        x = local_rows(x, mesh.seq_group, h_axis)
    return x.contiguous() if isinstance(x, torch.Tensor) else x


def gather_image(x: torch.Tensor, mesh: SeqMesh, h_axis: int = 1,
                 batch: bool = True, batch_axis: int = 0) -> torch.Tensor:
    """The global array of which ``x`` is this rank's ``image_rows`` (its
    batch rows on ``batch_axis``; ``h_axis`` None: batch rows only), on
    every rank."""
    if mesh.seq > 1 and h_axis is not None:
        x = gather_rows(x, mesh.seq_group, h_axis)
    if batch and mesh.data > 1:
        x = gather_rows(x, mesh.data_group, batch_axis)
    return x


def splits_batch(mesh: SeqMesh, rows: int) -> bool:
    """Whether a batch of ``rows`` splits over the data axis (else every
    data index holds it whole), as JAX's ``_spatial_put``."""
    return mesh.data > 1 and rows % mesh.data == 0


def on_image_rows(fn: Callable, x: torch.Tensor, generator, noise_fn,
                  mesh: SeqMesh, batch: bool):
    """``fn(x, generator, noise_fn)`` (a sampler over NHWC images) on this
    rank's block of ``x`` (``image_rows``), under ``row_shards(mesh)``;
    returns its output, a block of the global result. Every draw is made
    for the global images and cut (``RowDraws``; ``noise_fn``'s global
    draws are cut alike); with ``batch`` the batch rows split over the
    data axis, and the window of the rank's global rows is open
    (``row_window``), so that a guided eps_fn gives each row its global
    row's label."""
    local = image_rows(x, mesh, 1, batch)
    if generator is not None:
        generator = RowDraws(generator, mesh, batch)
    local_fn = None
    if noise_fn is not None:
        def local_fn(*index):
            return image_rows(noise_fn(*index), mesh, 1, batch)
    b = local.shape[0]
    window = (row_window(mesh.data_rank * b, b, x.shape[0]) if batch
              and mesh.data > 1 else contextlib.nullcontext())
    with window, row_shards(mesh):
        return fn(local, generator, local_fn)
