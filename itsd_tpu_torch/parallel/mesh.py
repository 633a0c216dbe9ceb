"""The multi-device layer on ``torch.distributed``: the data axis and the
``seq`` axis.

Counterpart of ``itsd_tpu/parallel/mesh.py``. One process drives one GPU,
started by ``torchrun``; every process holds the whole model.

The data axis. The rows of a batch are split over the processes (the
ranks): training batches, search candidates and Picard's time grid. JAX
lays the same rows over a one-axis mesh (``batch_sharding``,
``candidate_sharding``, ``shard_batch(process_local=True)``); here a rank
takes its rows with ``local_rows`` and ``gather_rows`` puts the global
array back together on every rank. Where a ``shard`` argument appears in
the port (the searches, Picard), it is the process group whose ranks
split the rows: ``data_group()`` for every rank, or None for one
process's behaviour. The train step and the batch iterator take the
run's layout instead (``make_seq_mesh(1)``: the data axis alone).

The seq axis. ``make_seq_mesh(K)`` factors the W ranks into ``data = W/K``
by ``seq = K``, as JAX's ``make_mesh((n // K, K), ("data", "seq"))``:
rank r sits at (r // K, r % K). The K ranks of one data index split the
image rows of the same batch rows (``parallel.spatial``, the counterpart
of GSPMD's spatial partitioning under ``spatial_sharding``) and the tokens
of ring attention (``kernels.ring_attention``). The registry
(``set_seq_mesh``, ``get_seq_mesh``, ``seq_mesh_scope``,
``default_seq_mesh``) is JAX's: the CLI scopes the layout of a run, and
the default, tokens over every rank, is not persisted.

Random draws. JAX's keys are global, so a sharded run draws what the
unsharded one draws. Here each rank seeds the same generator and draws
every quantity for the global batch (and, under the seq axis, the global
image), then keeps its block (``draw`` with ``RowDraws``), so a run's
result does not depend on the world size or the layout.

Labels. A guided model call on a rank's rows of a fold (``on_local_rows``)
tiles its B labels over the fold's global rows and keeps the rows it
serves (``row_windows``), as JAX tiles them over the global array, so a
rank may hold any slice of a candidate.

Not ported: ``param_sharding``, since no command builds a ``model`` axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def maybe_initialize_distributed(device="cuda", **kwargs) -> bool:
    """Start the default process group when the process was launched for
    one: by ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
    with ``ITSD_MULTIHOST=1`` (the same variables, set by another
    launcher), or with explicit ``kwargs`` for
    ``torch.distributed.init_process_group`` (``init_method``,
    ``world_size``, ``rank``, ``timeout`` as a number of seconds). The
    backend is NCCL on a CUDA ``device``, with this process on
    ``cuda:LOCAL_RANK``, and gloo on the CPU.

    Returns True when it started the group; False when there is nothing to
    start or the group is already up. A genuine failure (a bad address, a
    timeout, a missing variable) is printed to stderr and raised: processes
    that each went on alone would write conflicting checkpoints."""
    launched = all(v in os.environ for v in _LAUNCHER_VARS)
    if not (kwargs or launched or os.environ.get("ITSD_MULTIHOST") == "1"):
        return False
    if dist.is_initialized():
        return False
    if "timeout" in kwargs:
        kwargs["timeout"] = timedelta(seconds=kwargs["timeout"])
    try:
        if torch.device(device).type == "cuda":
            local = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                            0)))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", device_id=local, **kwargs)
        else:
            dist.init_process_group("gloo", **kwargs)
    except Exception as e:
        print(f"[parallel] torch.distributed.init_process_group FAILED: "
              f"{e}", file=sys.stderr, flush=True)
        raise
    return True


def data_group():
    """The process group of every rank, or None without one."""
    return dist.group.WORLD if dist.is_initialized() else None


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main() -> bool:
    """True on rank 0, and without a process group: the rank that writes
    files and prints summaries."""
    return rank() == 0


def local_rows(x, group=None, dim: int = 0):
    """This rank's contiguous share of axis ``dim`` of ``x`` (a tensor or
    a numpy array): rows ``rank * n / W`` up to ``(rank + 1) * n / W`` of
    ``group``'s W ranks. Raises ValueError unless W divides the n rows."""
    w, n = world_size(group), x.shape[dim]
    if n % w:
        raise ValueError(f"{w} ranks do not divide the {n} rows of axis "
                         f"{dim}")
    k = n // w
    r = rank(group)
    cut = [slice(None)] * x.ndim
    cut[dim] = slice(r * k, (r + 1) * k)
    return x[tuple(cut)]


def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order. A gloo
    group cannot gather a CUDA tensor: it goes through host memory."""
    src = x.detach().contiguous()
    host = src.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


class _GatherRows(torch.autograd.Function):
    """``all_gather`` along ``dim`` whose backward keeps this rank's slice
    of the gradient: every rank computes the same function of the
    gathered rows, so the gradient of its own rows is its own slice, with
    nothing to reduce."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rows, ctx.rank, ctx.dim = x.shape[dim], rank(group), dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows),
                None, None)


def gather_rows(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The global array of which ``x`` is this rank's ``local_rows`` (its
    share along ``dim``), in rank order, on every rank. Differentiable.
    Without a process group it is ``x``."""
    if not dist.is_initialized():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group, dim)
    return _all_gather(x, group, dim)


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast the parameters and buffers of the group's rank 0 to every
    rank of it, in place; returns ``module``."""
    if dist.is_initialized():
        src = dist.get_global_rank(group or dist.group.WORLD, 0)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=group)
    return module


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its sum over the ranks, in place, through one
    collective on a flat copy (all of one dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


class RowDraws:
    """A generator whose draws are made for the global batch and cut to
    this rank's block (``draw``): what each rank passes where one process
    passes its generator, so that every rank draws what the one-process
    run draws for its block and advances the generator as it does.

    The batch rows split over ``mesh``'s data axis (unless ``batch`` is
    False: the batch is whole on every rank), and a 4-D draw's image rows
    over its seq axis. ``get_state``/``set_state`` are the generator's
    (remat rewinds it)."""

    def __init__(self, generator: Optional[torch.Generator],
                 mesh: "SeqMesh", batch: bool = True):
        self.generator = generator
        self.batch = (mesh.data, mesh.data_rank) if batch else (1, 0)
        self.image = (mesh.seq, mesh.seq_rank)

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)


def draw(fn: Callable, shape, generator, h_axis: Optional[int] = None,
         **kwargs) -> torch.Tensor:
    """``fn(shape, generator=generator, **kwargs)``, where ``fn`` is
    ``torch.rand``, ``torch.randn`` or a partial of ``torch.randint``. With
    a ``RowDraws``, the draw is made for the global batch (and, where its
    seq axis splits images, for the global image: ``h_axis`` names the
    axis of image rows, 1 in NHWC and 2 in NCHW) from its generator, and
    this rank's block is kept."""
    if not isinstance(generator, RowDraws):
        return fn(shape, generator=generator, **kwargs)
    (n, i), (k, j) = generator.batch, generator.image
    full = list(shape)
    full[0] *= n
    if k > 1:
        if h_axis is None and len(shape) == 4:
            raise ValueError("draw: an image-shaped draw under a seq axis "
                             "needs h_axis, the axis of its image rows")
        if h_axis is not None:
            full[h_axis] *= k
    out = fn(tuple(full), generator=generator.generator, **kwargs)
    out = out.narrow(0, i * shape[0], shape[0])
    if k > 1 and h_axis is not None:
        out = out.narrow(h_axis, j * shape[h_axis], shape[h_axis])
    return out.contiguous()


# The windows of global rows that the calls running now serve, outermost
# first: (first global row, rows, global rows); opened by ``on_local_rows``.
_WINDOWS: list = []


def row_windows() -> tuple:
    return tuple(_WINDOWS)


@contextlib.contextmanager
def row_window(start: int, rows: int, total: int):
    """Open the window of ``rows`` global rows from ``start`` of
    ``total`` while the body runs."""
    _WINDOWS.append((start, rows, total))
    try:
        yield
    finally:
        _WINDOWS.pop()


def on_local_rows(fn: Callable, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(local_rows(x))`` gathered back into the global rows on every
    rank. While ``fn`` runs, the window of global rows it serves is open
    (``row_windows``), so that a guided eps_fn gives each row the label of
    its global row (``core.process``): the labels are tiled over the global
    fold, as JAX's, whatever slice of it a rank holds."""
    local = local_rows(x, group)
    k = local.shape[0]
    with row_window(rank(group) * k, k, x.shape[0]):
        out = fn(local)
    return gather_rows(out, group)


def under_row_windows(fn: Callable) -> Callable:
    """``fn`` run under the windows open now, wherever it is called: for a
    function that ``torch.utils.checkpoint`` reruns in the backward, after
    ``on_local_rows`` has returned."""
    windows = list(_WINDOWS)

    def run(*args, **kwargs):
        outer = _WINDOWS[:]
        _WINDOWS[:] = windows
        try:
            return fn(*args, **kwargs)
        finally:
            _WINDOWS[:] = outer

    return run


def sharded_rows(fn: Callable, x: torch.Tensor, generator, noise_fn,
                 group) -> torch.Tensor:
    """``fn(x, generator, noise_fn)`` (a sampler or segment call that
    draws tensors of ``x``'s shape, from ``noise_fn(*index)`` when given,
    else from ``generator``) run on this rank's rows of ``x`` and gathered
    back (``on_local_rows``). Every draw is made for all the rows and cut
    to this rank's (``RowDraws``), so the result is the one-process
    call's. With ``group`` None it is ``fn(x, generator, noise_fn)``."""
    if group is None:
        return fn(x, generator, noise_fn)
    local_fn = None
    if noise_fn is not None:
        def local_fn(*index):
            return local_rows(noise_fn(*index), group)
    if generator is not None:
        generator = RowDraws(generator, SeqMesh.over(group))
    return on_local_rows(lambda rows: fn(rows, generator, local_fn), x,
                         group)


# ---------------------------------------------------------------------------
# the seq axis


@dataclasses.dataclass(frozen=True)
class SeqMesh:
    """The ranks factored into ``data`` x ``seq``: rank r sits at
    (r // seq, r % seq). ``seq_group`` is the process group of the seq
    ranks of this rank's data index (they split its images' rows and its
    attention tokens), ``data_group`` that of the data ranks of its seq
    index; each is None where its axis has size 1."""
    data: int
    seq: int
    data_group: object = None
    seq_group: object = None

    @classmethod
    def over(cls, group) -> "SeqMesh":
        """The data axis alone, over ``group``'s ranks (None: every rank):
        the layout of ``local_rows(x, group)``."""
        return cls(world_size(group), 1, group or data_group())

    @property
    def data_rank(self) -> int:
        return rank(self.data_group) if self.data > 1 else 0

    @property
    def seq_rank(self) -> int:
        return rank(self.seq_group) if self.seq > 1 else 0


# (the default group, seq) -> SeqMesh: every group is made once a process
_SEQ_MESHES: dict = {}


def _axis_groups(sizes_and_ranks):
    """``dist.new_group`` for each rank list, on every rank and in one
    order (which the collective call requires); returns the group holding
    this rank."""
    mine, me = None, rank()
    for ranks in sizes_and_ranks:
        g = dist.new_group(list(ranks))
        if me in ranks:
            mine = g
    return mine


def make_seq_mesh(seq: int) -> SeqMesh:
    """The (data = W/seq, seq) layout of the W ranks, its groups built once
    per process. Raises ValueError unless ``seq`` divides W."""
    w = world_size()
    if seq < 1 or w % seq:
        raise ValueError(f"a seq axis of {seq} must divide the world size "
                         f"{w}")
    key = (id(dist.group.WORLD) if dist.is_initialized() else None, seq)
    if key not in _SEQ_MESHES:
        data = w // seq
        everyone = dist.group.WORLD if dist.is_initialized() else None
        seq_group = data_group_ = None
        if seq > 1:
            seq_group = everyone if seq == w else _axis_groups(
                range(i * seq, (i + 1) * seq) for i in range(data))
        if data > 1:
            data_group_ = everyone if data == w else _axis_groups(
                range(j, w, seq) for j in range(seq))
        _SEQ_MESHES[key] = SeqMesh(data, seq, data_group_, seq_group)
    return _SEQ_MESHES[key]


# The registered layout of ring attention and spatial sharding: the CLI
# scopes its run's (``seq_mesh_scope``), as JAX's registry.
_SEQ_MESH: Optional[SeqMesh] = None


def set_seq_mesh(mesh: Optional[SeqMesh]) -> Optional[SeqMesh]:
    """Register (or clear, with None) the seq layout; returns the previous
    registration, so that callers can restore it."""
    global _SEQ_MESH
    prev, _SEQ_MESH = _SEQ_MESH, mesh
    return prev


def get_seq_mesh() -> Optional[SeqMesh]:
    return _SEQ_MESH


@contextlib.contextmanager
def seq_mesh_scope(mesh: Optional[SeqMesh]):
    """Register ``mesh`` while the body runs and restore the previous
    registration on exit (``mesh`` None: a no-op scope), so that an entry
    point does not leak its layout into later runs in the process."""
    if mesh is None:
        yield None
        return
    prev = set_seq_mesh(mesh)
    try:
        yield mesh
    finally:
        set_seq_mesh(prev)


def default_seq_mesh() -> SeqMesh:
    """data=1 x seq=W over every rank, JAX's latency-serving layout: one
    sample's tokens spread over all the ranks. Not registered."""
    return make_seq_mesh(world_size())
