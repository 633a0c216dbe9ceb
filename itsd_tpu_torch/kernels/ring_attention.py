"""Sequence-parallel (ring) attention over the seq ranks.

Counterpart of ``itsd_tpu/kernels/ring_attention.py``. The tokens of a
``[B, N, C]`` attention call are split over the seq ranks of a
``parallel.SeqMesh``, N/K each; each rank attends its queries to the keys
and values it holds, then passes them on around the ring K - 1 times
(``dist.batch_isend_irecv``: from rank j to j - 1), merging the partial
outputs by log-sum-exp in f32, as JAX's ``ring_attention`` with its
``ppermute``. The result is exact: after the K - 1 hops every query has
seen every key. There is no kernel here: each hop runs the attention
kernels (``attention_with_stats``: the forward that also writes the lse;
the CPU takes the plain version).

The backward is not autograd's (autograd does not differentiate through
point-to-point messages). With the merged lse, the global softmax's rows
are ``p = exp(s - lse)`` whichever shard the keys came from, so each hop's
dq and dk/dv kernels, called with the merged lse and ``dd = rowsum(dO *
O)`` of the final output, give that shard's exact share of the gradient:
the same arithmetic as JAX's ``dd - dlse`` fold. dq sums the hops' shares
in f32; the dk and dv shares, also f32, travel around the ring with their
keys and values, and one last hop brings each home to its owner.

``sequence_sharded_attention`` is the global view: every seq rank holds
the whole ``[B, N, C]``, takes its share of the tokens (whose gradient is
gathered back from all the ranks), runs the ring and gathers the outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import SeqMesh
from ..parallel.spatial import cut_seq, gather_seq, p2p
from . import attention as A


def attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None, plain: bool = False):
    """(o, lse): single-head attention and its f32 per-row log-sum-exp
    ``[B, N]``: the flash forward's kernel on CUDA tensors
    (``attention.attention_with_lse``), the plain version on the CPU or
    when ``plain``. Not differentiable."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    if plain:
        return A.attention_plain_stats(q, k, v, scale)
    return A.attention_with_lse(q, k, v, scale)


def _hop_grads(q, k, v, do, lse, dd, scale, plain):
    """(dq, dk, dv) of one hop's keys and values, from the merged lse."""
    if plain or A._on_cpu(q):
        return (A.flash_bwd_dq_plain(q, k, v, do, lse, dd, scale),
                *A.flash_bwd_dkv_plain(q, k, v, do, lse, dd, scale))
    return (A.flash_bwd_dq(q, k, v, do, lse, dd, scale),
            *A.flash_bwd_dkv(q, k, v, do, lse, dd, scale))


def _pass_on(tensors, mesh: SeqMesh):
    """Each tensor sent to the previous seq rank, its counterpart received
    from the next (one hop of the ring, JAX's perm j -> j - 1)."""
    j, K = mesh.seq_rank, mesh.seq
    prev, nxt = (j - 1) % K, (j + 1) % K
    return p2p([(t, prev, i) for i, t in enumerate(tensors)],
               [(t.shape, t.dtype, t.device, nxt, i)
                for i, t in enumerate(tensors)], mesh.seq_group)


def _merge(o, lse, o_i, lse_i):
    """The log-sum-exp merge of two partials, in f32 (JAX's ``body``)."""
    m = torch.maximum(lse, lse_i)
    w, w_i = torch.exp(lse - m), torch.exp(lse_i - m)
    denom = w + w_i
    o = (o * w[..., None] + o_i.float() * w_i[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _ring_forward(q, k, v, mesh, plain):
    """(o in q.dtype, merged f32 lse): attend to the local keys and
    values, then K - 1 hops; no dead final hop."""
    scale = float(q.shape[-1]) ** -0.5
    o, lse = attention_with_stats(q, k, v, scale, plain)
    o = o.float()
    kv = (k, v)
    for _ in range(mesh.seq - 1):
        kv = _pass_on(kv, mesh)
        o_i, lse_i = attention_with_stats(q, *kv, scale, plain)
        o, lse = _merge(o, lse, o_i, lse_i)
    return o.to(q.dtype), lse


class _Ring(torch.autograd.Function):
    """The ring's forward (saving q, k, v, o and the merged lse) and its
    backward: K hops of the dq and dk/dv kernels on the keys and values
    passed around again, dk and dv travelling with them, then one hop
    home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, plain):
        o, lse = _ring_forward(q, k, v, mesh, plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.plain = mesh, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, plain = ctx.mesh, ctx.plain
        scale = float(q.shape[-1]) ** -0.5
        do = do.contiguous()
        dd = A.row_dd(o, do).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc, dk, dv = k, v, None, None
        for hop in range(mesh.seq):
            if hop:
                kc, vc, dk, dv = _pass_on((kc, vc, dk, dv), mesh)
            dq_h, dk_h, dv_h = _hop_grads(q, kc, vc, do, lse, dd, scale,
                                          plain)
            dq += dq_h.float()
            dk = dk_h.float() if dk is None else dk + dk_h.float()
            dv = dv_h.float() if dv is None else dv + dv_h.float()
        # the shares of the previous rank's keys and values go home
        dk, dv = _pass_on((dk, dv), mesh)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: SeqMesh, plain: bool = False) -> torch.Tensor:
    """The per-rank body: q, k, v are this rank's ``[B, N/K, C]`` share of
    the tokens split over ``mesh``'s K seq ranks (its rows, in H-major
    order, under spatial sharding); returns its share of the output.
    Differentiable. With one seq rank it is the single-device call
    (``attention.local_attention``); ``plain`` runs each hop through the
    plain versions (``attention_impl="xla"``)."""
    if mesh.seq == 1:
        return A.local_attention(q, k, v, "xla" if plain else "flash")
    A.check_batch(q.shape[0])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Ring.apply(q, k, v, mesh, plain)
    return _ring_forward(q, k, v, mesh, plain)[0]


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mesh: SeqMesh,
                               plain: bool = False) -> torch.Tensor:
    """The global view: ``[B, N, C]`` attention, whole on every seq rank of
    ``mesh``, with its tokens split over them and run around the ring; the
    whole output on every rank, and, through its gradient, the whole
    gradient of q, k and v. Raises ValueError unless the seq ranks divide
    N, as JAX's assert."""
    n, size = q.shape[1], mesh.seq
    if n % size:
        raise ValueError(
            f"token count {n} must divide over seq axis 'seq' ({size})")
    local = [cut_seq(t, 1, mesh) for t in (q, k, v)]
    return gather_seq(ring_attention(*local, mesh, plain), 1, mesh)
