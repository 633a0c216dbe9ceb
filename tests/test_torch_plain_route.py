"""The port's attention at the widths no kernel takes (C % 4 != 0 or
C > 1024): the "plain" route.

JAX's ``spatial_attention`` computes such widths through ``_attention_xla``
(``_flash_eligible`` fails), so the port computes them through its plain
versions on whichever device holds the tensors. On the CPU every width
takes the plain versions; here the CUDA dispatch is held too, with the
device test (``attention._on_cpu``) answering "not the CPU" for CPU
tensors, the library's loader and the kernels' checks replaced by stand-ins
that fail when reached.

Tolerance against JAX: f32, 2e-5 absolute on values O(1) (the same
explicit-softmax algorithm; only the order of f32 sums differs, ~1e-6),
for the output and the gradients of q, k and v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.kernels.attention import spatial_attention as jax_attention
from itsd_tpu_torch.kernels import _build, attention, ring_attention

from _torch_port import one_torch_thread  # noqa: F401

WIDTHS = [1028, 6]


def _inputs(seed, B, N, C):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, C)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("C", WIDTHS)
def test_spatial_attention_outside_the_kernel_widths_matches_jax(C):
    """The port's ``spatial_attention`` against JAX's on the CPU (which takes
    ``_attention_xla`` at these widths): the output and the gradients of
    q, k and v of sum(o * dO), from numpy inputs of one seed, f32, 2e-5."""
    q, k, v, do = _inputs(C, 2, 16, C)

    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v) * jnp.asarray(do))

    want_o = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v))))
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attention.spatial_attention(tq, tk, tv)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=2e-5,
                               rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """CPU tensors dispatched as CUDA tensors are: the device test answers
    "not the CPU"; loading the library or checking a kernel's inputs
    fails, so nothing on the "plain" route may reach either."""
    def unreachable(*a, **kw):
        raise AssertionError("the plain route reached a kernel")

    monkeypatch.setattr(attention, "_on_cpu", lambda q: False)
    monkeypatch.setattr(_build, "load", unreachable)
    monkeypatch.setattr(attention, "_check", unreachable)
    return [getattr(attention, n) for n in COUNTERS]


COUNTERS = ("launches", "dq_launches", "dkv_launches", "wide_launches",
            "mma_launches", "wide_sync_launches", "dkv_wide_sync_launches")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", WIDTHS)
def test_the_plain_route_computes_the_plain_versions(as_if_on_the_card,
                                                     dtype, C):
    """On the "plain" route, ``spatial_attention`` is the plain version
    (its gradient autograd's), ``attention_with_lse`` and ``attention_bwd``
    (the differentiable ``flash_attention`` through them) the plain
    versions with the kernels' formula: equal bit for bit, each call one
    ``plain_calls``, no launch counted."""
    gen = torch.Generator().manual_seed(C)
    q, k, v, do = (torch.randn((2, 16, C), generator=gen).to(dtype)
                   for _ in range(4))
    scale = C ** -0.5
    plain0 = attention.plain_calls
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention.spatial_attention(*ins)
    grads = torch.autograd.grad(o, ins, do)
    assert attention.plain_calls - plain0 == 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention.attention_plain(*ref, scale)
    assert torch.equal(o, want)
    assert all(map(torch.equal, grads,
                   torch.autograd.grad(want, ref, do)))

    o_lse, lse = attention.attention_with_lse(q, k, v, scale)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    assert torch.equal(o_lse, want_o) and torch.equal(lse, want_lse)
    got = attention.attention_bwd(q, k, v, o_lse, lse, do, scale)
    assert all(map(torch.equal, got, attention.attention_bwd_plain(
        q, k, v, o_lse, lse, do, scale)))
    fins = [t.clone().requires_grad_() for t in (q, k, v)]
    fo, _ = attention.flash_attention(*fins, scale)
    fgrads = torch.autograd.grad(fo, fins, do)
    assert torch.equal(fo, want_o)
    assert all(map(torch.equal, fgrads, attention.attention_bwd_plain(
        q, k, v, want_o, want_lse, do, scale)))
    assert attention.plain_calls - plain0 == 5
    assert [getattr(attention, n) for n in COUNTERS] == as_if_on_the_card


@pytest.mark.parametrize("C", WIDTHS)
def test_the_rings_hops_take_the_plain_route(as_if_on_the_card, C):
    """A ring hop's forward (``attention_with_stats``) and gradients
    (``_hop_grads``) on the "plain" route: the plain versions, counted in
    ``plain_calls``, no launch."""
    gen = torch.Generator().manual_seed(C + 1)
    q, k, v, do = (torch.randn((2, 8, C), generator=gen) for _ in range(4))
    scale = C ** -0.5
    plain0 = attention.plain_calls
    o, lse = ring_attention.attention_with_stats(q, k, v, scale)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    dd = attention.row_dd(o, do)
    got = ring_attention._hop_grads(q, k, v, do, lse, dd, scale, False)
    want = (attention.flash_bwd_dq_plain(q, k, v, do, lse, dd, scale),
            *attention.flash_bwd_dkv_plain(q, k, v, do, lse, dd, scale))
    assert all(map(torch.equal, got, want))
    assert attention.plain_calls - plain0 == 3
    assert [getattr(attention, n) for n in COUNTERS] == as_if_on_the_card


def test_forced_calls_keep_their_refusal(as_if_on_the_card, monkeypatch):
    """The forced calls have no plain version: at a width no kernel takes
    they reach the kernels' checks (which refuse it on the card), never the
    plain route."""
    reached = []
    monkeypatch.setattr(attention, "_check",
                        lambda *a: reached.append(a[0].shape[-1])
                        or (_ for _ in ()).throw(ValueError("C % 4")))
    q = torch.zeros((1, 8, 1028))
    lse = torch.zeros((1, 8))
    plain0 = attention.plain_calls
    with pytest.raises(ValueError, match="C % 4"):
        attention._flash_simt(q, q, q, 0.5, emit_lse=False)
    with pytest.raises(ValueError, match="C % 4"):
        attention._flash_bwd_dkv_simt(q, q, q, q, lse, lse, 0.5)
    assert reached == [1028, 1028] and attention.plain_calls == plain0
