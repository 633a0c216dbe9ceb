"""The data axis of the multi-device layer, on ``torch.distributed``.

Counterpart of the ``data`` axis of ``itsd_tpu/parallel/mesh.py``. One
process drives one GPU, started by ``torchrun``; every process holds the
whole model, and the rows of a batch are split over the processes (the
ranks): training batches, search candidates and Picard's time grid. JAX
lays the same rows over a one-axis mesh (``batch_sharding``,
``candidate_sharding``, ``shard_batch(process_local=True)``); here a rank
takes its rows with ``local_rows`` and ``gather_rows`` puts the global
array back together on every rank.

Where a ``shard`` argument appears in the port (the train step, the
searches, Picard), it is the process group whose ranks split the rows:
``data_group()`` for every rank, or None for one process's behaviour.

Random draws. JAX's keys are global, so a sharded run draws what the
unsharded one draws. Here each rank seeds the same generator and draws
every quantity for the global batch, then keeps its rows (``draw`` with
``RowDraws``), so a run's result does not depend on the world size.

Labels. A guided model call on a rank's rows of a fold (``on_local_rows``)
tiles its B labels over the fold's global rows and keeps the rows it
serves (``row_windows``), as JAX tiles them over the global array, so a
rank may hold any slice of a candidate.

Not ported: the ``seq`` mesh registry (``set_seq_mesh`` and its scope,
the axis of ring attention and ``train.spatial_shard``), which comes with
the sequence axis, and ``param_sharding``, since no command builds a
``model`` axis.
"""

from __future__ import annotations

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


def local_rows(x, group=None):
    """This rank's contiguous share of the leading axis of ``x`` (a tensor
    or a numpy array): rows ``rank * n / W`` up to ``(rank + 1) * n / W``.
    Raises ValueError unless the world size W divides the n rows."""
    w, n = world_size(group), x.shape[0]
    if n % w:
        raise ValueError(f"{w} ranks do not divide the {n} rows of the "
                         "leading axis")
    k = n // w
    r = rank(group)
    return x[r * k:(r + 1) * k]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """``all_gather`` along the leading axis whose backward keeps this
    rank's slice of the gradient: every rank computes the same function
    of the gathered rows, so the gradient of its own rows is its own slice,
    with nothing to reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.rank = x.shape[0], rank(group)
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The global array of which ``x`` is this rank's ``local_rows``, in
    rank order, on every rank. Differentiable. Without a process group it
    is ``x``."""
    if not dist.is_initialized():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group)
    return _all_gather(x, group)


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
    this rank's rows (``draw``): what each rank passes where one process
    passes its generator, so that every rank draws what the one-process
    run draws for its rows and advances the generator as it does.
    ``get_state``/``set_state`` are the generator's (remat rewinds it)."""

    def __init__(self, generator: Optional[torch.Generator], group=None):
        self.generator, self.group = generator, group

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)


def draw(fn: Callable, shape, generator, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=generator, **kwargs)``, where ``fn`` is
    ``torch.rand``, ``torch.randn`` or a partial of ``torch.randint``. With
    a ``RowDraws``, the draw is made for the world size times ``shape[0]``
    rows from its generator, and this rank's rows are kept."""
    if isinstance(generator, RowDraws):
        group = generator.group
        full = fn((shape[0] * world_size(group),) + tuple(shape[1:]),
                  generator=generator.generator, **kwargs)
        return local_rows(full, group)
    return fn(shape, generator=generator, **kwargs)


# The windows of global rows that the calls running now serve, outermost
# first: (first global row, rows, global rows); opened by ``on_local_rows``.
_WINDOWS: list = []


def row_windows() -> tuple:
    return tuple(_WINDOWS)


def on_local_rows(fn: Callable, x: torch.Tensor, group) -> torch.Tensor:
    """``fn(local_rows(x))`` gathered back into the global rows on every
    rank. While ``fn`` runs, the window of global rows it serves is open
    (``row_windows``), so that a guided eps_fn gives each row the label of
    its global row (``core.process``): the labels are tiled over the global
    fold, as JAX's, whatever slice of it a rank holds."""
    local = local_rows(x, group)
    k = local.shape[0]
    _WINDOWS.append((rank(group) * k, k, x.shape[0]))
    try:
        out = fn(local)
    finally:
        _WINDOWS.pop()
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
        generator = RowDraws(generator, group)
    return on_local_rows(lambda rows: fn(rows, generator, local_fn), x,
                         group)
