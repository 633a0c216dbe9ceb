"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.

These tests are marked ``cuda`` and skip (inside a fixture) where no card is
present. The card's machine has no JAX, so this file imports none, and is run
there without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of test_torch_kernels.py, plus one for bf16 attention
outputs: the kernel rounds p to bf16 before p.v (as the Pallas kernel), the
plain version the normalised softmax weights. Each is off by at most 2^-9
relative, so the sums differ by at most 2^-8 * max|v|; then each side rounds
its output to bf16 (one step, 2^-7 relative). The test allows twice the
first term: atol 2^-7 * max|v|, rtol 2^-7.

The forward, the dq backward and the dk/dv backward each have two
tensor-core kernels ("mma", C <= 256, and "wide", 256 < C <= 1024) and a
CUDA-core one ("simt"); the f32 forward has a tensor-core kernel of its own
("tf32x3": error-compensated TF32 products, f32 accuracy); ``route`` picks
one from the function, the dtype and C. They are held here on the same
inputs, the "simt" ones through the private ``_flash_simt``,
``_flash_bwd_dq_simt`` and ``_flash_bwd_dkv_simt``. Run one route's tests
with ``-k mma``, ``-k wide``, ``-k tf32x3`` or ``-k simt``, the dq tests of
one route with ``-k "dq and mma"``,
``-k "wide and cfg"`` or ``-k "routes and simt"``, the tests at the CFG
UNet's widths and maps with ``-k cfg``, the wide route's Hopper forward and
dk/dv (which replaced the mma.sync kernels that ``_flash_wide_sync`` and
``_flash_bwd_dkv_wide_sync`` still reach) against their plain versions and
the mma.sync kernels with ``-k "wide and hopper"``, the "plain" route (the
widths no kernel takes, computed by the plain versions on the card) with
``-k plain_route``, the Hopper forward, dq and dk/dv
(the mma route's since they replaced the mma.sync kernels, which forced
calls still reach: ``_flash_mma_sync``, ``_flash_bwd_dq_mma_sync``,
``_flash_bwd_dkv_mma_sync``) against their plain versions and the mma.sync
kernels with ``-k hopper`` (``-k "hopper and forward"``, ``-k "hopper and
dq"``, ``-k "hopper and dkv"``), the mma.sync entries' refusals with
``-k "mma_sync and refuse"``, the stats kernel of GroupNorm over row
shards against its plain version and the earlier stats kernel it replaced
(``_groupnorm_partial_stats_cluster``) with ``-k stats``, those at
Picard's folded batches
(400 and 800 rows) with ``-k picard``, a batch at CUDA's gridDim.y
cap and past it with ``-k grid_cap``, and gradient search's backward
batches (8 and the dual 16), its gradient through DPM-Solver++ and
``gradient_search`` itself over the remat'd ancestral chain, kernels
against plain, with ``-k gradient_search``. The metric networks
(Inception-V3 and CLIP, no kernel of ours) on the card against the same
modules on the CPU: ``-k extractor``. The ViT's multi-head attention (12
heads of 64 folded into the batch: mma at C=64) and the ViT against its
plain path: ``-k vit``; remat against no remat on the card: ``-k
remat``. The stats and apply kernels of GroupNorm over row shards (the
images' rows split over the seq ranks) at the flagship's and the CIFAR
UNet's row shards: ``-k rows``.

The backward kernels against ``attention_bwd_plain`` (the same formula and
roundings): f32 2e-5 absolute on values O(1), sums in another order
(measured <= 3.8e-6 on an H100). bf16: both sides round ds (and p) to bf16,
from f32 values that may differ in their last bits, so a term can land on
the neighbouring bf16 value, and each side rounds its output (one step,
2^-7 relative): atol 2^-7 * max|plain|, rtol 2^-7 (measured <= 2^-8 *
max|plain|, one bf16 step at the outputs' scale).
"""

import pytest
import torch

from itsd_tpu_torch.kernels import attention, groupnorm
from itsd_tpu_torch.models.unet import _groups

BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is present")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


GN_SHAPES = [(8, 128, 32, 32), (8, 384, 32, 32), (8, 256, 16, 16),
             (8, 512, 4, 4), (2, 96, 8, 8), (2, 8, 3, 3), (3, 24, 5, 5)]
# The (C, H, W, act) of the 51 GroupNorm calls of the CIFAR-10 UNet (ch 128,
# ch_mult 1,2,2,2, attention at 16x16): 13 pairs.
CIFAR_GN = [(128, 32, 32, True), (128, 16, 16, True), (256, 16, 16, True),
            (256, 16, 16, False), (256, 8, 8, True), (256, 4, 4, True),
            (256, 4, 4, False), (512, 4, 4, True), (512, 8, 8, True),
            (512, 16, 16, True), (384, 16, 16, True), (384, 32, 32, True),
            (256, 32, 32, True)]
# The 256x256 flagship's largest spans, at batch 1: each is split over a
# thread-block cluster.
FLAGSHIP_GN = [(1, 384, 256, 256), (1, 256, 256, 256), (1, 128, 256, 256)]


def _gn_inputs(shape, dtype, gen, device):
    C = shape[1]
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5
         ).to(dtype)
    w = 1 + 0.1 * torch.randn(C, generator=gen, device=device)
    b = 0.1 * torch.randn(C, generator=gen, device=device)
    return x, w, b


def _gn_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_RTOL, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in GN_SHAPES:
        x, w, b = _gn_inputs(shape, dtype, gen, cuda_device)
        for act in (True, False):
            got = groupnorm.groupnorm_swish(x, w, b, _groups(shape[1]),
                                            act=act)
            want = groupnorm.groupnorm_swish_plain(x, w, b, _groups(shape[1]),
                                                   act=act)
            torch.cuda.synchronize()
            _gn_close(got, want, dtype)


def _gn_forward_and_backward(shape, act, dtype, seed, device):
    """The kernel against the plain version, forward and backward (the
    backward recomputes through the plain version, so its gradients equal
    autograd of the plain version exactly), and two launches equal bit for
    bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, w, b = _gn_inputs(shape, dtype, gen, device)
    G = _groups(shape[1])
    before = groupnorm.launches
    got = groupnorm.groupnorm_swish(x, w, b, G, act=act)
    again = groupnorm.groupnorm_swish(x, w, b, G, act=act)
    want = groupnorm.groupnorm_swish_plain(x, w, b, G, act=act)
    torch.cuda.synchronize()
    assert groupnorm.launches - before == 2
    assert got.dtype == dtype and torch.equal(got, again)
    _gn_close(got, want, dtype)
    xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
    gy = torch.randn(shape, generator=gen, device=device).to(dtype)
    got = torch.autograd.grad(groupnorm.groupnorm_swish(xg, wg, bg, G,
                                                        act=act),
                              (xg, wg, bg), gy)
    want = torch.autograd.grad(groupnorm.groupnorm_swish_plain(
        xg, wg, bg, G, act=act), (xg, wg, bg), gy)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,W,act", CIFAR_GN)
def test_groupnorm_at_the_cifar_shapes(cuda_device, dtype, C, H, W, act):
    _gn_forward_and_backward((8, C, H, W), act, dtype, C + H, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLAGSHIP_GN)
def test_groupnorm_at_the_flagship_spans(cuda_device, dtype, shape):
    """Spans of up to 786,432 elements, each split over a cluster of blocks
    (in f32 at the largest, not held on chip); the partial sums are added
    in a fixed order, so two launches agree bit for bit."""
    _gn_forward_and_backward(shape, True, dtype, shape[1], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C", [(256, 256), (16, 256), (100, 128),
                                 (64, 512), (40, 100)])
def test_flash_kernel_matches_plain(cuda_device, dtype, N, C):
    gen = torch.Generator(device=cuda_device).manual_seed(N + C)
    q, k, v = (torch.randn((4, N, C), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
    else:
        # each side's rounding of p (or of the weights) moves the sum by
        # <= 2^-9 * max|v|, then each rounds its output (one bf16 step)
        torch.testing.assert_close(
            o.float(), want_o.float(), rtol=BF16_RTOL,
            atol=BF16_RTOL * v.float().abs().max().item())


BWD_F32_TOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", [(16, 256, 256), (16, 16, 256),
                                   (4, 100, 128), (2, 64, 512),
                                   (3, 40, 100), (2, 1, 8)])
def test_flash_bwd_kernels_match_plain(cuda_device, dtype, B, N, C):
    gen = torch.Generator(device=cuda_device).manual_seed(B * N + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn((B, N), generator=gen, device=cuda_device)
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    for d in (None, dlse):
        before = (attention.dq_launches, attention.dkv_launches)
        got = attention.attention_bwd(q, k, v, o, lse, do, scale, d)
        want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale, d)
        torch.cuda.synchronize()
        assert (attention.dq_launches - before[0],
                attention.dkv_launches - before[1]) == (1, 1)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == (B, N, C)
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=BWD_F32_TOL, rtol=0)
            else:
                torch.testing.assert_close(
                    g.float(), w.float(), rtol=BF16_RTOL,
                    atol=BF16_RTOL * w.float().abs().max().item())


def _close_bf16(got, want, ref):
    """bf16 outputs within the tolerances above: atol 2^-7 * max|ref|
    (max|v| for the forward, max|plain| for the backward), rtol 2^-7."""
    torch.testing.assert_close(
        got.float(), want.float(), rtol=BF16_RTOL,
        atol=BF16_RTOL * ref.float().abs().max().item())


def _dq_order_bound(q, k, v, do, lse, scale):
    """Elementwise bound on how far two f32 evaluations of dq may differ
    through the order of the sums in dp = dO.v^T alone. The products of bf16
    values are exact in f32, so two orders of a C-term sum differ by at most
    C * 2^-23 * sum|terms|; p carries that into ds = p * (dp - dd), and
    scale * |ds|.|k| into dq. Where dq cancels to ~0 (N = 1 without dlse:
    there p = 1 and dp = dd, so ds = 0 in exact arithmetic) the outputs are
    this rounding noise, not O(1) values rounded to bf16. Elsewhere the
    bound is a few percent of the bf16 tolerance's atol."""
    return torch.einsum("bqk,bkc->bqc", _ds_order_bound(q, k, v, do, lse,
                                                        scale),
                        k.float().abs())


def _ds_order_bound(q, k, v, do, lse, scale):
    """scale * (the f32 summation-order bound of dp, carried through p into
    ds): [B, N, N], the factor ``_dq_order_bound`` and ``_dk_order_bound``
    multiply by |k| and |q|."""
    C = q.shape[-1]
    p = torch.exp(attention._scores(q, k, scale) - lse[..., None])
    terms = torch.einsum("bqc,bkc->bqk", do.float().abs(), v.float().abs())
    return scale * C * 2.0 ** -23 * p * terms


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 128, 256, 208])
@pytest.mark.parametrize("N", [1, 16, 17, 100, 256, 4096])
def test_flash_bwd_dq_mma_matches_plain(cuda_device, N, C):
    """bf16 dq on the tensor-core kernel, which ``route`` names for these
    widths, against ``flash_bwd_dq_plain``, with and without dlse; two
    launches on the same inputs agree bit for bit. Tolerance: the bf16 one
    above (atol 2^-7 * max|plain|, rtol 2^-7) plus, elementwise, the f32
    summation-order bound of ``_dq_order_bound``."""
    assert attention.route(torch.bfloat16, C, "dq") == "mma"
    B = 2
    gen = torch.Generator(device=cuda_device).manual_seed(N * C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    for dlse in (None, torch.randn((B, N), generator=gen,
                                   device=cuda_device)):
        dd = attention.row_dd(o, do, dlse).contiguous()
        args = (q, k, v, do, lse, dd, scale)
        counts = (attention.dq_launches, attention.dq_mma_launches)
        got = attention.flash_bwd_dq(*args)
        again = attention.flash_bwd_dq(*args)
        want = attention.flash_bwd_dq_plain(*args)
        torch.cuda.synchronize()
        assert (attention.dq_launches - counts[0],
                attention.dq_mma_launches - counts[1]) == (2, 2)
        assert got.dtype == torch.bfloat16 and got.shape == (B, N, C)
        assert torch.equal(got, again)
        err = (got.float() - want.float()).abs()
        limit = (BF16_RTOL * want.float().abs().max()
                 + BF16_RTOL * want.float().abs()
                 + _dq_order_bound(q, k, v, do, lse, scale))
        assert (err <= limit).all(), (
            f"max err {err.max().item():.3g}, worst excess "
            f"{(err - limit).max().item():.3g}")


ROUTE_SHAPES = [(4, 256, 256), (4, 16, 256), (4, 17, 128), (3, 100, 64),
                (2, 1, 16), (2, 4096, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mma", "simt"])
@pytest.mark.parametrize("B,N,C", ROUTE_SHAPES)
def test_flash_routes_match_plain_in_bf16(cuda_device, which, B, N, C):
    """The forward (with and without lse), dq and dk/dv through the
    tensor-core kernels ("mma", which ``route`` names for these shapes) and
    through the CUDA-core kernels ("simt", forced), each against its plain
    version."""
    assert all(attention.route(torch.bfloat16, C, kernel) == "mma"
               for kernel in attention.KERNELS)
    gen = torch.Generator(device=cuda_device).manual_seed(B * N + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = C ** -0.5
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    counts = (attention.launches, attention.mma_launches)
    if which == "mma":
        o, lse = attention.attention_with_lse(q, k, v, scale)
        o2 = attention.spatial_attention(q, k, v)
    else:
        o, lse = attention._flash_simt(q, k, v, scale, emit_lse=True)
        o2 = attention._flash_simt(q, k, v, scale, emit_lse=False)
    torch.cuda.synchronize()
    mma = int(which == "mma")
    assert (attention.launches - counts[0],
            attention.mma_launches - counts[1]) == (2, 2 * mma)
    assert torch.equal(o, o2)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    _close_bf16(o, want_o, v)

    dd = attention.row_dd(o, do).contiguous()
    args = (q, k, v, do, lse, dd, scale)
    counts = (attention.dq_launches, attention.dq_mma_launches)
    dq = (attention.flash_bwd_dq if which == "mma"
          else attention._flash_bwd_dq_simt)(*args)
    want = attention.flash_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    assert (attention.dq_launches - counts[0],
            attention.dq_mma_launches - counts[1]) == (1, mma)
    assert dq.dtype == torch.bfloat16 and dq.shape == (B, N, C)
    _close_bf16(dq, want, want)

    counts = (attention.dkv_launches, attention.dkv_mma_launches)
    dkv = (attention.flash_bwd_dkv if which == "mma"
           else attention._flash_bwd_dkv_simt)
    got = dkv(*args)
    want = attention.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert (attention.dkv_launches - counts[0],
            attention.dkv_mma_launches - counts[1]) == (1, mma)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (B, N, C)
        _close_bf16(g, w, w)


def _counts():
    return tuple(getattr(attention, n) for n in (
        "launches", "mma_launches", "wide_launches", "dq_launches",
        "dq_mma_launches", "dq_wide_launches", "dkv_launches",
        "dkv_mma_launches", "dkv_wide_launches"))


def _launched(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flagship_attention_shape(cuda_device, dtype):
    """The 256x256 flagship's attention, [1, 4096, 384], forward and
    backward through the CUDA-core kernels (forced): the route of the f32
    dq and dk/dv, whose forward takes the tf32x3 kernel
    (``test_tf32x3_forward_matches_plain_and_simt`` holds it here), and of
    no bf16 function, whose forward, dq and dk/dv take the wide kernels
    (``test_wide_mma_kernels_at_the_cfg_widths`` holds those here)."""
    B, N, C = 1, 4096, 384
    assert attention.route(dtype, C, "dq") == (
        "simt" if dtype == torch.float32 else "wide")
    gen = torch.Generator(device=cuda_device).manual_seed(384)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(4))
    scale = C ** -0.5
    counts = _counts()
    o, lse = attention._flash_simt(q, k, v, scale, emit_lse=True)
    dd = attention.row_dd(o, do).contiguous()
    args = (q, k, v, do, lse, dd, scale)
    got = (attention._flash_bwd_dq_simt(*args),
           *attention._flash_bwd_dkv_simt(*args))
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert _launched(counts) == (1, 0, 0, 1, 0, 0, 1, 0, 0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=BWD_F32_TOL, rtol=0)
    else:
        _close_bf16(o, want_o, v)
        for g, w in zip(got, want):
            _close_bf16(g, w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [512, 768, 1024])
@pytest.mark.parametrize("N", [1, 4, 16, 64, 256])
def test_simt_kernels_at_the_cfg_widths(cuda_device, dtype, C, N):
    """The CUDA-core forward (with and without lse), dq and dk/dv at the
    widths of the CFG UNet's 16x16 (C=512) and 8x8 and 4x4 (C=1024)
    stages, and C=768, each against its plain version (f32: 2e-5; bf16:
    the tolerances above), with dlse; two launches of each agree bit for
    bit. The f32 dq and dk/dv take this route at these widths, the f32
    forward the tf32x3 kernel; bf16, which takes the wide kernels, is
    forced here."""
    assert attention.route(dtype, C, "dq") == (
        "simt" if dtype == torch.float32 else "wide")
    B = 3
    gen = torch.Generator(device=cuda_device).manual_seed(N * 7 + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn((B, N), generator=gen, device=cuda_device)
    scale = C ** -0.5
    counts = _counts()
    o, lse = attention._flash_simt(q, k, v, scale, emit_lse=True)
    o2 = attention._flash_simt(q, k, v, scale, emit_lse=False)
    dd = attention.row_dd(o, do, dlse).contiguous()
    args = (q, k, v, do, lse, dd, scale)
    got = (attention._flash_bwd_dq_simt(*args),
           *attention._flash_bwd_dkv_simt(*args))
    again = (attention._flash_bwd_dq_simt(*args),
             *attention._flash_bwd_dkv_simt(*args))
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    want = (attention.flash_bwd_dq_plain(*args),
            *attention.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    assert _launched(counts) == (2, 0, 0, 2, 0, 0, 2, 0, 0)
    assert torch.equal(o, o2)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=BWD_F32_TOL, rtol=0)
    else:
        _close_bf16(o, want_o, v)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == (B, N, C)
            _close_bf16(g, w, w)


def _dk_order_bound(q, k, v, do, lse, scale):
    """As ``_dq_order_bound``, for dk = scale * ds^T.q (N = 1 without dlse
    gives dk = 0 in exact arithmetic)."""
    return torch.einsum("bqk,bqc->bkc", _ds_order_bound(q, k, v, do, lse,
                                                        scale),
                        q.float().abs())


# The CFG UNet's widths at every N its maps give, C=384 and C=768, the
# flagship's shape, and ragged N (a last tile part filled) at the CFG
# widths and at widths whose column shares differ by a step (C=272: 17
# steps of 16 columns over 2 or 4 warps; C=784: 49 over 4 or 8).
WIDE_SHAPES = ([(3, N, C) for C in (384, 512, 768, 1024)
                for N in (1, 4, 16, 64, 256)]
               + [(1, 4096, 384), (2, 100, 512), (2, 37, 1024),
                  (2, 100, 272), (2, 37, 784)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", WIDE_SHAPES)
def test_wide_mma_kernels_at_the_cfg_widths(cuda_device, B, N, C):
    """The wide tensor-core forward (with and without lse), dq and dk/dv,
    which ``route`` names for bf16 at these widths (``WIDE_SHAPES``),
    against their plain versions: the forward at the bf16 tolerance above
    (lse 2e-5), dq and dk/dv with a nonzero dlse at the bf16 one plus, for
    dq and dk, the f32 summation-order bound. Two launches of each agree
    bit for bit."""
    assert all(attention.route(torch.bfloat16, C, kernel) == "wide"
               for kernel in attention.KERNELS)
    gen = torch.Generator(device=cuda_device).manual_seed(N * 11 + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    dlse = torch.randn((B, N), generator=gen, device=cuda_device)
    scale = C ** -0.5
    counts = _counts()
    o, lse = attention.attention_with_lse(q, k, v, scale)
    o2 = attention.spatial_attention(q, k, v)
    o3, lse3 = attention.attention_with_lse(q, k, v, scale)
    dd = attention.row_dd(o, do, dlse).contiguous()
    args = (q, k, v, do, lse, dd, scale)
    got = (attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args))
    again = (attention.flash_bwd_dq(*args),
             *attention.flash_bwd_dkv(*args))
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    want = (attention.flash_bwd_dq_plain(*args),
            *attention.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    assert _launched(counts) == (3, 0, 3, 2, 0, 2, 2, 0, 2)
    assert torch.equal(o, o2) and torch.equal(o, o3)
    assert torch.equal(lse, lse3)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert o.dtype == torch.bfloat16 and o.shape == (B, N, C)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    _close_bf16(o, want_o, v)
    bounds = (_dq_order_bound(q, k, v, do, lse, scale),
              _dk_order_bound(q, k, v, do, lse, scale), 0.0)
    for name, g, w, bound in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == torch.bfloat16 and g.shape == (B, N, C)
        err = (g.float() - w.float()).abs()
        limit = (BF16_RTOL * w.float().abs().max()
                 + BF16_RTOL * w.float().abs() + bound)
        assert (err <= limit).all(), (
            f"{name}: max err {err.max().item():.3g}, worst excess "
            f"{(err - limit).max().item():.3g}")


# GroupNorm at the CFG UNet's smallest maps: 1x1 and 2x2 take the scalar
# path (HW is not a multiple of a 16-byte vector), [B, 256, 1, 1] has spans
# of 8 elements, and the up path's skip concatenations reach 2048
# channels.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("C", [256, 512, 768, 1536, 2048])
def test_groupnorm_at_the_cfg_small_maps(cuda_device, dtype, S, C):
    for act in (True, False):
        _gn_forward_and_backward((8, C, S, S), act, dtype, C + S,
                                 cuda_device)


# GroupNorm over row shards: (B, C, H / K, W) of the 256x256 flagship at
# batch 2 (ch 128, ch_mult 1,2,3,4) and of the CIFAR-10 UNet at batch 8, at
# K = 2 and 4 seq ranks.
ROWS_GN = [(2, 128, 256 // K, 256) for K in (2, 4)] + [
    (2, 256, 128 // K, 128) for K in (2, 4)] + [
    (2, 384, 64 // K, 64) for K in (2, 4)] + [
    (2, 512, 32 // K, 32) for K in (2, 4)] + [
    (8, 128, 32 // K, 32) for K in (2, 4)] + [
    (8, 256, 8 // K, 8) for K in (2, 4)] + [(8, 256, 1, 4), (3, 24, 1, 5)]


def _stats_close(got, want, x, G, what):
    """A span's f32 sum in another order: within 1e-5 of the sum of the
    terms' magnitudes (a sum of squares: 2e-5 of itself)."""
    terms = (groupnorm.groupnorm_partial_stats_plain(x.abs(), G)
             if what == "sum" else 2 * want)
    assert ((got - want).abs() <= 1e-5 * terms + 1e-6).all(), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ROWS_GN)
def test_groupnorm_rows_kernels_match_plain(cuda_device, dtype, shape):
    """The stats kernel (each span's sum, and its sum of squared deviations
    around a given mean) and the apply kernel against their plain
    versions; two launches equal bit for bit; one launch counted a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1] + shape[2])
    x, w, b = _gn_inputs(shape, dtype, gen, cuda_device)
    G = _groups(shape[1])
    before = (groupnorm.stats_launches, groupnorm.apply_launches)
    s1 = groupnorm.groupnorm_partial_stats(x, G)
    mean = s1 / x[0].numel() * G
    s2 = groupnorm.groupnorm_partial_stats(x, G, mean)
    again = groupnorm.groupnorm_partial_stats(x, G, mean)
    rstd = torch.rsqrt(s2 / x[0].numel() * G + 1e-5)
    y = groupnorm.groupnorm_apply(x, mean, rstd, w, b, G)
    y2 = groupnorm.groupnorm_apply(x, mean, rstd, w, b, G)
    torch.cuda.synchronize()
    assert (groupnorm.stats_launches - before[0],
            groupnorm.apply_launches - before[1]) == (3, 2)
    assert torch.equal(s2, again) and torch.equal(y, y2)
    _stats_close(s1, groupnorm.groupnorm_partial_stats_plain(x, G), x, G,
                 "sum")
    _stats_close(s2, groupnorm.groupnorm_partial_stats_plain(x, G, mean), x,
                 G, "squares")
    for act in (True, False):
        _gn_close(groupnorm.groupnorm_apply(x, mean, rstd, w, b, G, act),
                  groupnorm.groupnorm_apply_plain(x, mean, rstd, w, b, G,
                                                  act), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [2, 4])
def test_groupnorm_rows_of_slices_make_the_whole(cuda_device, dtype, K):
    """The flagship's 256x256 GroupNorm cut into K row slices: their stats,
    summed, are the whole image's, and each slice normalized with the
    global statistics is its rows of the fused kernel's output."""
    shape = (2, 128, 256, 256)
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    x, w, b = _gn_inputs(shape, dtype, gen, cuda_device)
    G = _groups(shape[1])
    n = x[0].numel() // G
    slices = [s.contiguous() for s in x.chunk(K, dim=2)]
    s1 = sum(groupnorm.groupnorm_partial_stats(s, G) for s in slices)
    _stats_close(s1, groupnorm.groupnorm_partial_stats(x, G), x, G, "sum")
    mean = s1 / n
    s2 = sum(groupnorm.groupnorm_partial_stats(s, G, mean) for s in slices)
    _stats_close(s2, groupnorm.groupnorm_partial_stats(x, G, mean), x, G,
                 "squares")
    rstd = torch.rsqrt(s2 / n + 1e-5)
    got = torch.cat([groupnorm.groupnorm_apply(s, mean, rstd, w, b, G)
                     for s in slices], dim=2)
    torch.cuda.synchronize()
    _gn_close(got, groupnorm.groupnorm_swish(x, w, b, G), dtype)


@pytest.mark.cuda
def test_mma_entries_refuse_what_they_do_not_take(cuda_device):
    """The tensor-core entry points take bf16 with C % 16 == 0 and C <= 256
    only; anything else returns an error, which the wrapper raises."""
    from itsd_tpu_torch.kernels import _build

    lib = _build.load().lib
    for dtype, C in ((torch.float32, 64), (torch.bfloat16, 24),
                     (torch.bfloat16, 272)):
        q = torch.zeros((1, 8, C), dtype=dtype, device=cuda_device)
        lse = torch.zeros((1, 8), device=cuda_device)
        code = _build.DTYPE_CODES[dtype]
        stream = _build.stream_ptr(q)
        p = q.data_ptr()
        assert lib.itsd_flash_attention_mma(p, p, p, p, None, 1, 8, C, 0.5,
                                            code, stream) != 0
        assert lib.itsd_flash_bwd_dkv_mma(p, p, p, p, lse.data_ptr(),
                                          lse.data_ptr(), p, p, 1, 8, C, 0.5,
                                          code, stream) != 0
        assert lib.itsd_flash_bwd_dq_mma(p, p, p, p, lse.data_ptr(),
                                         lse.data_ptr(), p, 1, 8, C, 0.5,
                                         code, stream) != 0


@pytest.mark.cuda
def test_mma_sync_entries_refuse_what_they_do_not_take(cuda_device):
    """The mma.sync forward, dq and dk/dv, which the Hopper kernels replaced
    on the mma route and which only forced calls reach, refuse what they
    refused as the route's kernels: anything but bf16 with C % 16 == 0 and
    C <= 256. The forced wrappers raise the kernel's refusal."""
    from itsd_tpu_torch.kernels import _build

    lib = _build.load().lib
    for dtype, C in ((torch.float32, 64), (torch.bfloat16, 24),
                     (torch.bfloat16, 272)):
        q = torch.zeros((1, 8, C), dtype=dtype, device=cuda_device)
        lse = torch.zeros((1, 8), device=cuda_device)
        code = _build.DTYPE_CODES[dtype]
        stream = _build.stream_ptr(q)
        p = q.data_ptr()
        assert lib.itsd_flash_attention_mma_sync(p, p, p, p, None, 1, 8, C,
                                                 0.5, code, stream) != 0
        assert lib.itsd_flash_bwd_dkv_mma_sync(
            p, p, p, p, lse.data_ptr(), lse.data_ptr(), p, p, 1, 8, C, 0.5,
            code, stream) != 0
        assert lib.itsd_flash_bwd_dq_mma_sync(
            p, p, p, p, lse.data_ptr(), lse.data_ptr(), p, 1, 8, C, 0.5,
            code, stream) != 0
    # C=24 passes the wrapper's checks (C % 4 == 0); the kernel refuses it
    q = torch.zeros((1, 8, 24), dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros((1, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="flash_attention_mma_sync: CUDA"):
        attention._flash_mma_sync(q, q, q, 0.5, emit_lse=False)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_mma_sync: CUDA"):
        attention._flash_bwd_dkv_mma_sync(q, q, q, q, lse, lse, 0.5)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_mma_sync: CUDA"):
        attention._flash_bwd_dq_mma_sync(q, q, q, q, lse, lse, 0.5)


# The mma route's forward and dk/dv run the Hopper kernels
# (csrc/flash_attention_hopper.cu, csrc/flash_attention_bwd_dkv_hopper.cu:
# wgmma, TMA, mbarriers), which pad C to the next multiple of 64 through
# the tensor maps' zero fill. Shapes: the kernel table's (PERF.md: the CFG
# UNet's train step and its Picard fold, the unconditional train and eval
# steps, the ViT's heads; for dk/dv the train steps and gradient search's
# batches), every padded width at N = 1, 16, 17, 255 and 1024 (ragged
# tiles of queries and keys), the ring's hop [24, 128, 64] and a batch at
# gridDim.y's cap.
HOPPER_WIDTHS = [(2, N, C) for C in (16, 48, 64, 96, 128, 144, 240, 256)
                 for N in (1, 16, 17, 255, 1024)]
HOPPER_FWD_SHAPES = ([(256, 1024, 128), (800, 1024, 128), (128, 256, 256),
                      (8, 256, 256), (192, 256, 64)]
                     + HOPPER_WIDTHS + [(24, 128, 64), (65535, 4, 128)])
HOPPER_DKV_SHAPES = ([(256, 1024, 128), (16, 1024, 128), (128, 256, 256),
                      (8, 256, 256), (192, 256, 64)]
                     + HOPPER_WIDTHS + [(24, 128, 64), (65535, 4, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", HOPPER_FWD_SHAPES)
def test_hopper_forward_matches_plain_and_mma_sync(cuda_device, B, N, C):
    """The mma route's forward (the Hopper kernel), with and without lse,
    against its plain version at the bf16 tolerance above (lse 2e-5), and
    against the mma.sync kernel it replaced (forced), each of the two within
    the bf16 tolerance of the plain version, so within twice its atol of
    each other. Two launches agree bit for bit; the variant without lse
    writes the same o."""
    assert attention.route(torch.bfloat16, C, "forward") == "mma"
    gen = torch.Generator(device=cuda_device).manual_seed(B + N * 7 + C)
    q, k, v = (torch.randn((B, N, C), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    scale = C ** -0.5
    counts, sync0 = _counts(), attention.mma_sync_launches
    o, lse = attention.attention_with_lse(q, k, v, scale)
    o2 = attention.spatial_attention(q, k, v)
    o3, lse3 = attention.attention_with_lse(q, k, v, scale)
    o_sync, lse_sync = attention._flash_mma_sync(q, k, v, scale,
                                                 emit_lse=True)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    torch.cuda.synchronize()
    assert _launched(counts)[:3] == (4, 3, 0)
    assert attention.mma_sync_launches - sync0 == 1
    assert o.dtype == torch.bfloat16 and o.shape == (B, N, C)
    assert torch.equal(o, o2) and torch.equal(o, o3)
    assert torch.equal(lse, lse3)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse_sync, want_lse, atol=2e-5, rtol=0)
    _close_bf16(o, want_o, v)
    _close_bf16(o_sync, want_o, v)
    torch.testing.assert_close(
        o.float(), o_sync.float(), rtol=BF16_RTOL,
        atol=2 * BF16_RTOL * v.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", HOPPER_DKV_SHAPES)
def test_hopper_dkv_matches_plain_and_mma_sync(cuda_device, B, N, C):
    """The mma route's dk/dv (the Hopper kernel), without and with dlse,
    against its plain version at the bf16 tolerance plus, for dk, the f32
    summation-order bound (``_dk_order_bound``), and against the mma.sync
    kernel it replaced (forced), which is held to the same limit. Two
    launches agree bit for bit."""
    assert attention.route(torch.bfloat16, C, "dkv") == "mma"
    gen = torch.Generator(device=cuda_device).manual_seed(B + N * 5 + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    bound = _dk_order_bound(q, k, v, do, lse, scale)
    for dlse in (None, torch.randn((B, N), generator=gen,
                                   device=cuda_device)):
        dd = attention.row_dd(o, do, dlse).contiguous()
        args = (q, k, v, do, lse, dd, scale)
        counts, sync0 = _counts(), attention.dkv_mma_sync_launches
        got = attention.flash_bwd_dkv(*args)
        again = attention.flash_bwd_dkv(*args)
        sync = attention._flash_bwd_dkv_mma_sync(*args)
        want = attention.flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        assert _launched(counts)[6:] == (3, 2, 0)
        assert attention.dkv_mma_sync_launches - sync0 == 1
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        for kernel, grads in (("hopper", got), ("mma.sync", sync)):
            for name, g, w, b in zip(("dk", "dv"), grads, want,
                                     (bound, 0.0)):
                assert g.dtype == torch.bfloat16 and g.shape == (B, N, C)
                err = (g.float() - w.float()).abs()
                limit = (BF16_RTOL * w.float().abs().max()
                         + BF16_RTOL * w.float().abs() + b)
                assert (err <= limit).all(), (
                    f"{kernel} {name} dlse={dlse is not None}: max err "
                    f"{err.max().item():.3g}, worst excess "
                    f"{(err - limit).max().item():.3g}")


# The mma route's dq runs the Hopper kernel
# (csrc/flash_attention_bwd_dq_hopper.cu: wgmma, TMA, mbarriers) since it
# replaced the mma.sync kernel, which the forced call
# ``_flash_bwd_dq_mma_sync`` still reaches. Every padded width (kC 64, 128,
# 192, 256) and widths that are not multiples of 64, at N of one row, one
# 64-row tile less one, one and one more, ragged and whole multi-tile maps;
# then the kernel table's shapes (the CFG UNet's train step and gradient
# search, the unconditional train step and gradient search, the ViT's heads
# and its ring hop); then small N at more samples than the card's 132
# SMs, where a tile packs ceil(B / 132) samples (2, 3, 4, 8 and 16), a last
# tile in part among them, and N = 16 at B = 128, which packs none.
HOPPER_DQ_SHAPES = ([(2, N, C) for C in (16, 48, 64, 128, 192, 256)
                     for N in (1, 16, 63, 64, 65, 200, 1024)]
                    + [(256, 1024, 128), (16, 1024, 128), (128, 256, 256),
                       (8, 256, 256), (192, 256, 64), (24, 128, 64)]
                    + [(256, 1, 256), (301, 7, 64), (400, 3, 128),
                       (300, 32, 192), (1000, 24, 48), (2000, 1, 16),
                       (128, 16, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", HOPPER_DQ_SHAPES)
def test_hopper_dq_matches_plain_and_mma_sync(cuda_device, B, N, C):
    """The mma route's dq (the Hopper kernel), without and with dlse,
    against its plain version at the bf16 tolerance plus the f32
    summation-order bound (``_dq_order_bound``), and the mma.sync kernel it
    replaced (forced) held to the same limit. Two launches agree bit for
    bit; one launch is counted a call, on the mma route."""
    assert attention.route(torch.bfloat16, C, "dq") == "mma"
    gen = torch.Generator(device=cuda_device).manual_seed(B + N * 3 + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    bound = _dq_order_bound(q, k, v, do, lse, scale)
    for dlse in (None, torch.randn((B, N), generator=gen,
                                   device=cuda_device)):
        dd = attention.row_dd(o, do, dlse).contiguous()
        args = (q, k, v, do, lse, dd, scale)
        counts, sync0 = _counts(), attention.dq_mma_sync_launches
        got = attention.flash_bwd_dq(*args)
        again = attention.flash_bwd_dq(*args)
        sync = attention._flash_bwd_dq_mma_sync(*args)
        want = attention.flash_bwd_dq_plain(*args)
        torch.cuda.synchronize()
        assert _launched(counts)[3:6] == (3, 2, 0)
        assert attention.dq_mma_sync_launches - sync0 == 1
        assert torch.equal(got, again)
        limit = (BF16_RTOL * want.float().abs().max()
                 + BF16_RTOL * want.float().abs() + bound)
        for kernel, g in (("hopper", got), ("mma.sync", sync)):
            assert g.dtype == torch.bfloat16 and g.shape == (B, N, C)
            err = (g.float() - want.float()).abs()
            assert (err <= limit).all(), (
                f"{kernel} dq dlse={dlse is not None}: max err "
                f"{err.max().item():.3g}, worst excess "
                f"{(err - limit).max().item():.3g}")


@pytest.mark.cuda
def test_hopper_dq_entry_refuses_what_it_does_not_take(cuda_device):
    """The Hopper dq's entry point (``itsd_flash_bwd_dq_mma``) takes bf16
    with C % 16 == 0, C <= 256, 1 <= B <= 65535 and N >= 1 only; anything
    else returns an error without a launch, which the wrapper raises."""
    from itsd_tpu_torch.kernels import _build

    lib = _build.load().lib
    q = torch.zeros((2, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros((2, 8), device=cuda_device)
    stream = _build.stream_ptr(q)
    p, lp = q.data_ptr(), lse.data_ptr()
    bf16, f32 = _build.DTYPE_CODES[torch.bfloat16], _build.DTYPE_CODES[
        torch.float32]
    for B, N, C, code in ((1, 8, 64, f32), (1, 8, 24, bf16),
                          (1, 8, 272, bf16), (1, 8, 0, bf16),
                          (0, 8, 64, bf16), (65536, 1, 64, bf16),
                          (1, 0, 64, bf16)):
        assert lib.itsd_flash_bwd_dq_mma(p, p, p, p, lp, lp, p, B, N, C,
                                         0.125, code, stream) != 0
    assert lib.itsd_flash_bwd_dq_mma(p, p, p, p, lp, lp, p, 2, 8, 64, 0.125,
                                     bf16, stream) == 0
    torch.cuda.synchronize()
    q24 = torch.zeros((1, 8, 24), dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros((1, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_mma: CUDA"):
        attention._launch_dq(q24, q24, q24, q24, lse, lse, 0.5, "mma")


# The stats kernel (a launch plan of its own since the earlier kernel, on
# the fused kernel's plan, became its yardstick, which the forced call
# ``_groupnorm_partial_stats_cluster`` reaches): the flagship's rows at
# K = 2 and 4 (its largest and smallest levels), the CIFAR UNet's, and the
# scalar path (HW not a multiple of the 16-byte vector; below, a view one
# element off the 16-byte alignment).
STATS_SHAPES = [(2, 128, 128, 256), (2, 128, 64, 256), (2, 512, 16, 32),
                (2, 512, 8, 32), (8, 128, 16, 32), (8, 256, 2, 8),
                (8, 512, 1, 4), (2, 64, 3, 5), (3, 24, 1, 5),
                (2, 256, 7, 9)]


def _stats_against(x, G):
    """Both stats kernels and the plain version on ``x``: sums within
    ``_stats_close`` of the plain ones, two launches of the new kernel equal
    bit for bit, one launch counted a call of each kernel."""
    before = (groupnorm.stats_launches, groupnorm.stats_cluster_launches)
    s1 = groupnorm.groupnorm_partial_stats(x, G)
    s1b = groupnorm.groupnorm_partial_stats(x, G)
    mean = s1 / (x[0].numel() // G)
    s2 = groupnorm.groupnorm_partial_stats(x, G, mean)
    s2b = groupnorm.groupnorm_partial_stats(x, G, mean)
    c1 = groupnorm._groupnorm_partial_stats_cluster(x, G)
    c2 = groupnorm._groupnorm_partial_stats_cluster(x, G, mean)
    torch.cuda.synchronize()
    assert (groupnorm.stats_launches - before[0],
            groupnorm.stats_cluster_launches - before[1]) == (4, 2)
    assert torch.equal(s1, s1b) and torch.equal(s2, s2b)
    want1 = groupnorm.groupnorm_partial_stats_plain(x, G)
    want2 = groupnorm.groupnorm_partial_stats_plain(x, G, mean)
    for got1, got2 in ((s1, s2), (c1, c2)):
        _stats_close(got1, want1, x, G, "sum")
        _stats_close(got2, want2, x, G, "squares")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STATS_SHAPES)
def test_stats_kernel_matches_plain_and_the_earlier_kernel(cuda_device,
                                                            dtype, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x, _, _ = _gn_inputs(shape, dtype, gen, cuda_device)
    _stats_against(x, _groups(shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_kernel_on_an_unaligned_view(cuda_device, dtype):
    """A contiguous x whose data starts one element past a 16-byte
    boundary takes the scalar path of both stats kernels."""
    shape = (2, 128, 16, 32)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    flat = (torch.randn(1 + 2 * 128 * 16 * 32, generator=gen,
                        device=cuda_device) * 2 + 0.5).to(dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    _stats_against(x, _groups(shape[1]))


@pytest.mark.cuda
def test_stats_floor_and_forced_calls_refuse_bad_shapes(cuda_device):
    """The empty kernel launches on the stats plan's grid and returns 0;
    both stats entries and the empty kernel's refuse groups that do not
    divide C, which the wrappers raise."""
    from itsd_tpu_torch.kernels import _build

    x = torch.zeros((2, 64, 4, 4), dtype=torch.bfloat16, device=cuda_device)
    groupnorm._groupnorm_stats_floor(x, 32)
    torch.cuda.synchronize()
    lib = _build.load().lib
    out = torch.zeros((2, 32), device=cuda_device)
    stream = _build.stream_ptr(x)
    code = _build.DTYPE_CODES[x.dtype]
    for entry in ("itsd_groupnorm_partial_stats",
                  "itsd_groupnorm_partial_stats_cluster"):
        assert getattr(lib, entry)(x.data_ptr(), None, out.data_ptr(), 2, 64,
                                   16, 24, code, stream) != 0
    assert lib.itsd_groupnorm_stats_floor(x.data_ptr(), 2, 64, 16, 24, code,
                                          stream) != 0
    with pytest.raises(ValueError, match="do not divide"):
        groupnorm._groupnorm_partial_stats_cluster(x, 24)
    with pytest.raises(ValueError, match="do not divide"):
        groupnorm._groupnorm_stats_floor(x, 24)


@pytest.mark.cuda
def test_wide_entries_refuse_what_they_do_not_take(cuda_device):
    """The wide entry points (the Hopper forward and dk/dv, the mma.sync
    dq, and the mma.sync forward and dk/dv the Hopper kernels replaced)
    take bf16 with C % 16 == 0 and 256 < C <= 1024 only; anything else
    returns an error, which the wrapper raises."""
    from itsd_tpu_torch.kernels import _build

    lib = _build.load().lib
    for dtype, C in ((torch.float32, 512), (torch.bfloat16, 520),
                     (torch.bfloat16, 256), (torch.bfloat16, 1040)):
        q = torch.zeros((1, 8, C), dtype=dtype, device=cuda_device)
        lse = torch.zeros((1, 8), device=cuda_device)
        code = _build.DTYPE_CODES[dtype]
        stream = _build.stream_ptr(q)
        p = q.data_ptr()
        assert lib.itsd_flash_attention_wide(p, p, p, p, None, 1, 8, C, 0.5,
                                             code, stream) != 0
        assert lib.itsd_flash_bwd_dkv_wide(p, p, p, p, lse.data_ptr(),
                                           lse.data_ptr(), p, p, 1, 8, C,
                                           0.5, code, stream) != 0
        assert lib.itsd_flash_bwd_dq_wide(p, p, p, p, lse.data_ptr(),
                                          lse.data_ptr(), p, 1, 8, C, 0.5,
                                          code, stream) != 0
        assert lib.itsd_flash_attention_wide_sync(p, p, p, p, None, 1, 8, C,
                                                  0.5, code, stream) != 0
        assert lib.itsd_flash_bwd_dkv_wide_sync(
            p, p, p, p, lse.data_ptr(), lse.data_ptr(), p, p, 1, 8, C, 0.5,
            code, stream) != 0
    # C=520 passes the wrapper's checks (C % 4 == 0, C <= 1024); the
    # kernel's refusal is raised
    q = torch.zeros((1, 8, 520), dtype=torch.bfloat16, device=cuda_device)
    lse = torch.zeros((1, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="flash_attention_wide: CUDA"):
        attention._launch_forward(q, q, q, 0.5, False, "wide")
    with pytest.raises(RuntimeError, match="flash_bwd_dq_wide: CUDA"):
        attention._launch_dq(q, q, q, q, lse, lse, 0.5, "wide")
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_wide: CUDA"):
        attention._launch_dkv(q, q, q, q, lse, lse, 0.5, "wide")
    with pytest.raises(RuntimeError,
                       match="flash_attention_wide_sync: CUDA"):
        attention._flash_wide_sync(q, q, q, 0.5, emit_lse=False)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_wide_sync: CUDA"):
        attention._flash_bwd_dkv_wide_sync(q, q, q, q, lse, lse, 0.5)


# The wide route's forward and dk/dv run the Hopper kernels
# (csrc/flash_attention_wide_hopper.cu,
# csrc/flash_attention_bwd_dkv_wide_hopper.cu: wgmma, TMA, mbarriers, the
# head dimension split over warpgroups and cluster ranks), which pad C to
# 384, 512 or 1024 through the tensor maps' zero fill; the mma.sync kernels
# they replaced stay as forced calls (``_flash_wide_sync``,
# ``_flash_bwd_dkv_wide_sync``). Shapes: every width class (C=272 and 400
# padded with a column block wholly past C, 528 and 768 on the C=1024
# kernels, 1008) at N of one row, the CFG UNet's maps, one 64-row tile less
# one, one and one more, ragged and whole multi-tile maps; the kernel
# table's shapes (the flagship's batch 1 and 2, the guided eval, the CFG
# UNet's C=1024 maps and 2x2 map at its train batch); then small N past the
# card's 132 SMs, where a tile packs samples (a last tile in part among
# them).
WIDE_HOPPER_SHAPES = ([(2, N, C)
                       for C in (272, 384, 400, 512, 528, 768, 1008, 1024)
                       for N in (1, 4, 16, 63, 64, 65, 200, 256, 1024)]
                      + [(1, 4096, 384), (2, 4096, 384), (16, 256, 512),
                         (256, 64, 1024), (256, 16, 1024), (256, 4, 512)]
                      + [(300, 7, 384), (800, 16, 1024), (1000, 3, 512),
                         (133, 32, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", WIDE_HOPPER_SHAPES)
def test_wide_hopper_forward_matches_plain_and_mma_sync(cuda_device, B, N,
                                                        C):
    """The wide route's forward (the Hopper kernel), with and without lse,
    against its plain version at the bf16 tolerance above (lse 2e-5), and
    the mma.sync kernel it replaced (forced) held to the same limits. Two
    launches agree bit for bit; the variant without lse writes the same
    o; each launch counts on the wide route."""
    assert attention.route(torch.bfloat16, C, "forward") == "wide"
    gen = torch.Generator(device=cuda_device).manual_seed(B + N * 7 + C)
    q, k, v = (torch.randn((B, N, C), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    scale = C ** -0.5
    counts, sync0 = _counts(), attention.wide_sync_launches
    o, lse = attention.attention_with_lse(q, k, v, scale)
    o2 = attention.spatial_attention(q, k, v)
    o3, lse3 = attention.attention_with_lse(q, k, v, scale)
    o_sync, lse_sync = attention._flash_wide_sync(q, k, v, scale,
                                                  emit_lse=True)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    torch.cuda.synchronize()
    assert _launched(counts)[:3] == (4, 0, 3)
    assert attention.wide_sync_launches - sync0 == 1
    assert o.dtype == torch.bfloat16 and o.shape == (B, N, C)
    assert torch.equal(o, o2) and torch.equal(o, o3)
    assert torch.equal(lse, lse3)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse_sync, want_lse, atol=2e-5, rtol=0)
    _close_bf16(o, want_o, v)
    _close_bf16(o_sync, want_o, v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", WIDE_HOPPER_SHAPES)
def test_wide_hopper_dkv_matches_plain_and_mma_sync(cuda_device, B, N, C):
    """The wide route's dk/dv (the Hopper kernel), without and with dlse,
    against its plain version at the bf16 tolerance plus, for dk, the f32
    summation-order bound (``_dk_order_bound``), and the mma.sync kernel
    it replaced (forced) held to the same limit. Two launches agree bit
    for bit; each counts on the wide route."""
    assert attention.route(torch.bfloat16, C, "dkv") == "wide"
    gen = torch.Generator(device=cuda_device).manual_seed(B + N * 5 + C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    bound = _dk_order_bound(q, k, v, do, lse, scale)
    for dlse in (None, torch.randn((B, N), generator=gen,
                                   device=cuda_device)):
        dd = attention.row_dd(o, do, dlse).contiguous()
        args = (q, k, v, do, lse, dd, scale)
        counts, sync0 = _counts(), attention.dkv_wide_sync_launches
        got = attention.flash_bwd_dkv(*args)
        again = attention.flash_bwd_dkv(*args)
        sync = attention._flash_bwd_dkv_wide_sync(*args)
        want = attention.flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        assert _launched(counts)[6:] == (3, 0, 2)
        assert attention.dkv_wide_sync_launches - sync0 == 1
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        for kernel, grads in (("hopper", got), ("mma.sync", sync)):
            for name, g, w, b in zip(("dk", "dv"), grads, want,
                                     (bound, 0.0)):
                assert g.dtype == torch.bfloat16 and g.shape == (B, N, C)
                err = (g.float() - w.float()).abs()
                limit = (BF16_RTOL * w.float().abs().max()
                         + BF16_RTOL * w.float().abs() + b)
                assert (err <= limit).all(), (
                    f"{kernel} {name} dlse={dlse is not None}: max err "
                    f"{err.max().item():.3g}, worst excess "
                    f"{(err - limit).max().item():.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1028, 6])
def test_plain_route_on_the_card(cuda_device, dtype, C):
    """At the widths no kernel takes (C % 4 != 0, C > 1024) ``route`` names
    the plain version ("plain", as JAX takes ``_attention_xla`` there):
    ``spatial_attention``'s output and gradients equal the plain version's
    and autograd's of it bit for bit, ``attention_with_lse`` and
    ``attention_bwd`` the plain versions'; each counts one ``plain_calls``
    and no kernel counter moves."""
    assert all(attention.route(dtype, C, kernel) == "plain"
               for kernel in attention.KERNELS)
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    q, k, v, do = (torch.randn((2, 64, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(4))
    scale = C ** -0.5
    counts = _counts() + (attention.wide_sync_launches,
                          attention.dkv_wide_sync_launches,
                          attention.mma_sync_launches)
    plain0 = attention.plain_calls
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention.spatial_attention(*ins)
    grads = torch.autograd.grad(o, ins, do)
    o_lse, lse = attention.attention_with_lse(q, k, v, scale)
    bwd = attention.attention_bwd(q, k, v, o_lse, lse, do, scale)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention.attention_plain(*ref, scale)
    want_grads = torch.autograd.grad(want, ref, do)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.plain_calls - plain0 == 3
    assert _counts() + (attention.wide_sync_launches,
                        attention.dkv_wide_sync_launches,
                        attention.mma_sync_launches) == counts
    assert o.device.type == "cuda" and torch.equal(o, want)
    assert all(map(torch.equal, grads, want_grads))
    assert torch.equal(o_lse, want_o) and torch.equal(lse, want_lse)
    assert all(map(torch.equal, bwd, attention.attention_bwd_plain(
        q, k, v, o_lse, lse, do, scale)))


# The f32 forward's tensor-core kernel ("tf32x3",
# csrc/flash_attention_tf32x3.cu: mma.sync in TF32, three products a
# product of the operands split as hi + lo), which pads C to 64, 128, 256,
# 384, 512 or 1024 through the copies' zero fill: every width class (C=4
# and 12 on the narrowest, 100, 520 and 1020 padded) at N of one row, a
# packed tile's 4 and 16, one 64-row tile less one, one and one more, and
# several tiles; the UNets' and the inference config's calls (the
# flagship's [1, 4096, 384], [2, 1024, 512], the CFG UNet's C=1024 and
# C=512 small maps at its train batch, where tiles pack samples, and a
# last packed tile in part).
TF32X3_SHAPES = ([(3, N, C)
                  for C in (4, 12, 100, 128, 256, 384, 512, 520, 1020, 1024)
                  for N in (1, 4, 16, 63, 64, 65, 256)]
                 + [(1, 4096, 384), (2, 1024, 512), (256, 16, 1024),
                    (256, 4, 512), (300, 7, 384)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", TF32X3_SHAPES)
def test_tf32x3_forward_matches_plain_and_simt(cuda_device, B, N, C):
    """The f32 forward on its route ("tf32x3"), with and without lse,
    against the plain version at the f32 limits (o and lse within 2e-5),
    two launches equal bit for bit and each counted on the route; the simt
    kernel it replaced (``_flash_simt``) held to the same limits on the
    same inputs."""
    assert attention.route(torch.float32, C, "forward") == "tf32x3"
    gen = torch.Generator(device=cuda_device).manual_seed(B * N + C)
    q, k, v = (torch.randn((B, N, C), generator=gen, device=cuda_device)
               for _ in range(3))
    scale = C ** -0.5
    before = (attention.tf32x3_launches, attention.launches)
    o, lse = attention.attention_with_lse(q, k, v, scale)
    o2, lse2 = attention.attention_with_lse(q, k, v, scale)
    o3 = attention.spatial_attention(q, k, v)
    o4 = attention.spatial_attention(q, k, v)
    torch.cuda.synchronize()
    assert (attention.tf32x3_launches - before[0],
            attention.launches - before[1]) == (4, 4)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o3, o4) and torch.equal(o, o3)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    s_o, s_lse = attention._flash_simt(q, k, v, scale, emit_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and o.shape == (B, N, C)
    for got_o, got_lse in ((o, lse), (s_o, s_lse)):
        torch.testing.assert_close(got_o, want_o, atol=2e-5, rtol=0)
        torch.testing.assert_close(got_lse, want_lse, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_tf32x3_entry_refuses_what_it_does_not_take(cuda_device):
    """The tf32x3 entry point takes f32 with C % 4 == 0 and C <= 1024
    only: bf16, or a width past those, returns an error, which the wrapper
    raises (bf16 passes the wrapper's own checks)."""
    from itsd_tpu_torch.kernels import _build

    lib = _build.load().lib
    for dtype, C in ((torch.bfloat16, 384), (torch.float32, 6),
                     (torch.float32, 1028)):
        q = torch.zeros((1, 8, C), dtype=dtype, device=cuda_device)
        p = q.data_ptr()
        assert lib.itsd_flash_attention_tf32x3(
            p, p, p, p, None, 1, 8, C, 0.5, _build.DTYPE_CODES[dtype],
            _build.stream_ptr(q)) != 0
    q = torch.zeros((1, 8, 384), dtype=torch.bfloat16, device=cuda_device)
    before = attention.tf32x3_launches
    with pytest.raises(RuntimeError, match="flash_attention_tf32x3: CUDA"):
        attention._launch_forward(q, q, q, 0.5, False, "tf32x3")
    assert attention.tf32x3_launches == before


@pytest.mark.cuda
def test_autograd_functions_pass_gradcheck_in_f32(cuda_device):
    """Finite differences of the kernels' forward against their backward:
    f32 differences at eps 1e-3 carry ~1e-4 of rounding noise."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((2, 20, 8), generator=gen, device=cuda_device)
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: attention.flash_attention(q, k, v, 0.35),
        (q, k, v), eps=1e-3, atol=1e-2, rtol=1e-2, fast_mode=True)
    x = (torch.randn((2, 8, 3, 3), generator=gen, device=cuda_device)
         .requires_grad_())
    w = (1 + 0.1 * torch.randn(8, generator=gen, device=cuda_device)
         ).requires_grad_()
    b = (0.1 * torch.randn(8, generator=gen, device=cuda_device)
         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: groupnorm.groupnorm_swish(x, w, b, 4),
        (x, w, b), eps=1e-3, atol=1e-2, rtol=1e-2, fast_mode=True)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    w = torch.ones(32, device=cuda_device)
    x = torch.randn((2, 32, 4, 4), device=cuda_device)
    with pytest.raises(TypeError, match="f32 or bf16"):
        groupnorm.groupnorm_swish(x.half(), w, w, 8)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.groupnorm_swish(x.transpose(2, 3), w, w, 8)
    with pytest.raises(ValueError, match="weight"):
        groupnorm.groupnorm_swish(x, w.cpu(), w, 8)
    # the widths no kernel takes go to the plain versions
    # (test_plain_route_on_the_card); the forced calls, which have none,
    # refuse them
    q = torch.randn((2, 16, 6), device=cuda_device)
    with pytest.raises(ValueError, match="C % 4"):
        attention._flash_simt(q, q, q, 0.5, emit_lse=False)
    q = torch.randn((2, 16, 32), device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        attention.spatial_attention(q, q.bfloat16(), q)
    shifted = torch.randn(2 * 16 * 32 + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.spatial_attention(shifted.view(2, 16, 32), q, q)
    lse = torch.zeros((2, 16), device=cuda_device)
    for C in (6, 1028):
        q = torch.randn((2, 16, C), device=cuda_device)
        with pytest.raises(ValueError, match="C % 4"):
            attention._flash_bwd_dq_simt(q, q, q, q, lse, lse, 0.5)
        with pytest.raises(ValueError, match="C % 4"):
            attention._flash_bwd_dkv_simt(q, q, q, q, lse, lse, 0.5)
    q = torch.randn((2, 16, 32), device=cuda_device)
    with pytest.raises(ValueError, match="lse must be"):
        attention.attention_bwd(q, q, q, q, lse.double(), q, 0.5)


# Picard folds its n-point time grid into the batch: n=50 at batch 8 gives
# the unconditional UNet 400 rows, and CFG doubles the CFG UNet's to 800.
# (rows, N, C) of their attention calls; GroupNorm at their largest and
# smallest maps.
PICARD_ATTENTION = [(400, 256, 256), (800, 1024, 128), (800, 256, 512),
                    (800, 64, 1024), (800, 16, 1024), (800, 4, 512),
                    (800, 1, 256)]
PICARD_GN = [(400, 128, 32, 32), (400, 256, 16, 16), (400, 512, 4, 4),
             (800, 128, 32, 32), (800, 512, 16, 16), (800, 1024, 8, 8),
             (800, 2048, 2, 2), (800, 256, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", PICARD_ATTENTION)
def test_flash_forward_at_picard_folded_batches(cuda_device, B, N, C):
    """The flash forward on the route bf16 takes, and tf32x3 in f32, against
    the plain version at Picard's folded batches."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + N + C)
    scale = C ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(3))
        which = attention.route(dtype, C, "forward")
        counts = _counts()
        o = attention.spatial_attention(q, k, v)
        want = attention.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        fwd, mma, wide = _launched(counts)[:3]
        assert (fwd, mma, wide) == (1, int(which == "mma"),
                                    int(which == "wide"))
        if dtype == torch.float32:
            torch.testing.assert_close(o, want, atol=2e-5, rtol=0)
        else:
            _close_bf16(o, want, v)
        del q, k, v, o, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PICARD_GN)
def test_groupnorm_at_picard_folded_batches(cuda_device, dtype, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] + shape[1])
    x, w, b = _gn_inputs(shape, dtype, gen, cuda_device)
    for act in (True, False):
        got = groupnorm.groupnorm_swish(x, w, b, _groups(shape[1]), act=act)
        want = groupnorm.groupnorm_swish_plain(x, w, b, _groups(shape[1]),
                                               act=act)
        torch.cuda.synchronize()
        _gn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 512),
                                     (torch.float32, 128)])
def test_attention_at_the_grid_cap(cuda_device, dtype, C):
    """A batch at CUDA's gridDim.y cap of 65,535 (where every kernel puts
    the batch) runs as one launch of each kernel and matches the plain
    version: forward with lse, dq and dk/dv with a nonzero dlse. One row
    more raises ValueError before any launch."""
    B, N = attention.MAX_GRID_Y, 4
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    q, k, v, do = (torch.randn((B, N, C), generator=gen, device=cuda_device)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn((B, N), generator=gen, device=cuda_device)
    scale = C ** -0.5
    counts = _counts()
    o, lse = attention.attention_with_lse(q, k, v, scale)
    got = attention.attention_bwd(q, k, v, o, lse, do, scale, dlse)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale, dlse)
    torch.cuda.synchronize()
    launched = _launched(counts)
    assert (launched[0], launched[3], launched[6]) == (1, 1, 1)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    q1 = torch.cat([q, q[:1]])
    counts = _counts()
    with pytest.raises(ValueError, match="gridDim.y"):
        attention.attention_with_lse(q1, q1, q1, scale)
    assert _launched(counts) == (0,) * len(counts)
    del q1
    if dtype == torch.float32:
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=BWD_F32_TOL, rtol=0)
        return
    _close_bf16(o, want_o, v)
    bounds = (_dq_order_bound(q, k, v, do, lse, scale),
              _dk_order_bound(q, k, v, do, lse, scale), 0.0)
    for g, w, bound in zip(got, want, bounds):
        err = (g.float() - w.float()).abs()
        limit = (BF16_RTOL * w.float().abs().max()
                 + BF16_RTOL * w.float().abs() + bound)
        assert (err <= limit).all()


# Gradient search differentiates the sampler with respect to the noise: the
# dq and dk/dv kernels run at eval-sized batches, 8 for the unconditional
# UNet ([8, 256, 256]) and the dual CFG batch of 16 for the CFG UNet (its
# six attention shapes).
GRAD_SEARCH_ATTENTION = [(8, 256, 256), (16, 1024, 128), (16, 256, 512),
                         (16, 64, 1024), (16, 16, 1024), (16, 4, 512),
                         (16, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C", GRAD_SEARCH_ATTENTION)
def test_backward_kernels_at_gradient_search_batches(cuda_device, B, N, C):
    """dq and dk/dv on the route each dtype takes (bf16: mma or wide; f32:
    simt) against the plain backward, without dlse (the UNet's attention
    has none), at the tolerances above."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * 7 + N + C)
    scale = C ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((B, N, C), generator=gen,
                                   device=cuda_device).to(dtype)
                       for _ in range(4))
        o, lse = attention.attention_with_lse(q, k, v, scale)
        counts = _counts()
        got = attention.attention_bwd(q, k, v, o, lse, do, scale)
        want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        which = attention.route(dtype, C, "dq")
        assert which == attention.route(dtype, C, "dkv")
        launched = _launched(counts)
        assert launched[3:] == (1, int(which == "mma"),
                                int(which == "wide"), 1,
                                int(which == "mma"), int(which == "wide"))
        if dtype == torch.float32:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=BWD_F32_TOL, rtol=0)
            continue
        bounds = (_dq_order_bound(q, k, v, do, lse, scale),
                  _dk_order_bound(q, k, v, do, lse, scale), 0.0)
        for name, g, w, bound in zip(("dq", "dk", "dv"), got, want, bounds):
            err = (g.float() - w.float()).abs()
            limit = (BF16_RTOL * w.float().abs().max()
                     + BF16_RTOL * w.float().abs() + bound)
            assert (err <= limit).all(), (
                f"{name} {which}: max err {err.max().item():.3g}")


def _plain_unet():
    """Patches that send the UNet's GroupNorm and attention to their plain
    versions (autograd then runs through plain PyTorch ops)."""
    from unittest import mock

    from itsd_tpu_torch.models import unet

    return (mock.patch.object(unet, "groupnorm_swish",
                              groupnorm.groupnorm_swish_plain),
            mock.patch.object(unet, "spatial_attention",
                              lambda q, k, v, impl="auto":
                              attention.attention_plain(
                                  q, k, v, q.shape[-1] ** -0.5)))


# (config keys, batch): the unconditional UNet at full width (attention at
# [8, 256, 256], mma in bf16) and a narrow conditional one guided by CFG
# (dual batch 16; attention at C=32, 128 on mma and C=512 on wide in bf16).
GRAD_SEARCH_MODELS = {
    "uncond_b8": ["channel=128", "channel_mult=[1,2,2,2]", "attn=[1]"],
    "cfg_b16": ["channel=32", "channel_mult=[1,4,16]", "num_res_blocks=1",
                "model.num_labels=10", "w=1.8"]}
# Relative L2 limits on the gradient of the score with respect to the
# noise, kernels against plain: f32 differs by summation order (~1e-6 an
# op); bf16 rounds every GroupNorm and attention output, and the gradient
# carries roundings at neighbouring bf16 values (2^-8 relative) through
# every layer and solver step, forward and back. Measured on an H100
# (NVIDIA H100 80GB HBM3, 700 W): f32 3.2e-6 and 8.5e-6, bf16 0.0167 and
# 0.0457 (uncond_b8, cfg_b16).
GRAD_SEARCH_REL = {"float32": 5e-5, "bfloat16": 0.1}


def _grad_search_setup(model, dtype, device, T=1000):
    """(eps_fn, sched, noise) of GRAD_SEARCH_MODELS[model] on seeded
    weights, batch 8 (CFG: dual 16), its weights frozen."""
    from itsd_tpu_torch.cli import runner
    from itsd_tpu_torch.models.embeddings import TINY_GAIN
    from itsd_tpu_torch.utils import load_config

    cfg = load_config(None, GRAD_SEARCH_MODELS[model] + [
        f"T={T}", "img_size=32", f"model.dtype={dtype}", "dropout=0.0",
        "train.eval_batch_size=8", "seed=3"])
    net, conditional = runner.build_model(cfg)
    for k, v in runner.init_params(cfg, net).items():
        # the near-zero output layers at Xavier size, so that attention
        # and GroupNorm move the output (as chip_smoke.py:seeded_params)
        if k.endswith(("conv2.weight", "attn.proj.weight",
                       "tail_conv.weight")):
            v.mul_(1.0 / TINY_GAIN)
    net.to(device).eval().requires_grad_(False)
    eps_fn = runner.sampling_eps_fn(cfg, net, conditional, 8)
    sched = runner.build_schedule(cfg, inference=True, device=device)
    noise = torch.randn((8, 32, 32, 3),
                        generator=torch.Generator(device=device)
                        .manual_seed(4), device=device)
    return eps_fn, sched, noise


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(GRAD_SEARCH_MODELS))
def test_gradient_search_kernels_match_plain(cuda_device, model, dtype):
    """The gradient of a verifier's score with respect to the noise through
    DPM-Solver++ (3 steps, gradient search's ``solver_steps`` chain), the
    kernels against the plain path on the same seeded weights, within the
    relative L2 limit of ``GRAD_SEARCH_REL``; every attention call of every
    differentiated forward runs one dq and one dk/dv kernel. The score is
    taken on the unclipped output divided by its largest magnitude: on
    seeded weights the chain's output is O(100), and the sampler's clip
    would pass the gradient of only the pixels left inside [-1, 1], a set
    that bf16 rounding changes between the paths."""
    from itsd_tpu_torch.core import dpm_solver_sample

    eps_fn, sched, noise = _grad_search_setup(model, dtype, cuda_device)

    def chain(x):
        return dpm_solver_sample(sched, eps_fn, x, num_steps=3,
                                 clip_output=False)

    with torch.no_grad():
        scale = chain(noise).abs().max().item()

    def grad():
        x = noise.clone().requires_grad_(True)
        img = chain(x) / scale
        return torch.autograd.grad(-(img - 0.2).square().mean(), x)[0]

    counts = _counts()
    got = grad()
    launched = _launched(counts)
    p_gn, p_attn = _plain_unet()
    with p_gn, p_attn:
        want = grad()
    torch.cuda.synchronize()
    assert launched[0] > 0 and launched[3] == launched[6] == launched[0]
    rel = ((got - want).norm() / want.norm()).item()
    print(f"gradient search {model} {dtype}: relative L2 {rel:.4g} (limit "
          f"{GRAD_SEARCH_REL[dtype]})")
    assert torch.isfinite(got).all() and want.norm() > 0
    assert rel <= GRAD_SEARCH_REL[dtype], rel


# gradient_search itself over its default chain, the ancestral one with each
# step recomputed in the backward (T cut to 10), for 2 iterations, the
# sampler's draws from one seed. The sampler clips its output to [-1, 1]
# and the seeded UNets leave about half the pixels outside, so a pixel
# within the paths' difference of +-1 passes its gradient on one path only:
# bf16's limits, kernels against plain, are looser than f32's. Limits
# (scores and best score absolute, gradient norms relative) about 5x the
# largest first readings on an H100 (NVIDIA H100 80GB HBM3, 700 W): f32
# 1.5e-8 and 1.2e-7, bf16 1.5e-5 and 1.04e-3. The remat'd gradient equals
# the held chain's bit for bit under cuDNN's deterministic algorithms (by
# default cuDNN's f32 convolution backward differs from run to run in the
# last bits: 2.8e-6 relative between two held chains of the narrow CFG
# UNet).
GRAD_SEARCH_REMAT = {"float32": (1e-7, 1e-6), "bfloat16": (1e-4, 5e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(GRAD_SEARCH_MODELS))
def test_gradient_search_remat_chain_matches_plain(cuda_device, model,
                                                   dtype):
    """``gradient_search`` (Adam and best tracking) over the remat'd
    ancestral chain: its scores, best score and gradient norms, kernels
    against plain; and on the kernels, the gradient through
    ``sample(remat=True)`` against ``remat=False`` on the same draws, bit
    for bit under cuDNN's deterministic algorithms, the remat'd backward
    rerunning every step's forward (twice the forward
    launches, one dq and one dk/dv per attention call of each step)."""
    from itsd_tpu_torch.core.sampling import sample
    from itsd_tpu_torch.search import algorithms as A

    T, iters = 10, 2
    score_tol, norm_tol = GRAD_SEARCH_REMAT[dtype]
    eps_fn, sched, noise = _grad_search_setup(model, dtype, cuda_device, T)

    def draws():
        return torch.Generator(device=cuda_device).manual_seed(5)

    def verifier(img):
        return -(img / 2 - 0.2).square().mean()

    def search():
        return A.gradient_search(noise, sched, eps_fn, verifier,
                                 n_iterations=iters, generator=draws())

    got = search()
    p_gn, p_attn = _plain_unet()
    with p_gn, p_attn:
        want = search()
    gs, ws = (torch.cat([r.history["scores"], r.best_score[None]])
              for r in (got, want))
    gn, wn = (r.history["grad_norms"] for r in (got, want))
    s_err = (gs - ws).abs().max().item()
    n_rel = ((gn - wn).abs() / wn).max().item()

    def grad(remat):
        x = noise.clone().requires_grad_(True)
        img = sample(sched, eps_fn, x, generator=draws(), remat=remat)
        return torch.autograd.grad(verifier(img), x)[0]

    launched = {}
    grads = {}
    for remat in (True, False):
        counts = _counts()
        torch.backends.cudnn.deterministic = True
        try:
            grads[remat] = grad(remat)
        finally:
            torch.backends.cudnn.deterministic = False
        launched[remat] = _launched(counts)
    torch.cuda.synchronize()
    rel = ((grads[True] - grads[False]).norm()
           / grads[False].norm()).item()
    print(f"gradient_search remat'd {model} {dtype}: scores {gs.tolist()} "
          f"/ {ws.tolist()}, max err {s_err:.4g} (limit {score_tol}); "
          f"gradient norms {gn.tolist()} / {wn.tolist()}, max relative err "
          f"{n_rel:.4g} (limit {norm_tol}); remat against none, relative "
          f"L2 {rel:.4g} (limit: bit for bit)")
    assert gs[-1] == gs[:-1].max()
    assert s_err <= score_tol and n_rel <= norm_tol
    fwd, dq = launched[False][0], launched[False][3]
    assert fwd > 0 and dq == fwd == launched[False][6]
    assert launched[True][0] == 2 * fwd and launched[True][3] == dq
    assert torch.isfinite(grads[True]).all() and grads[False].norm() > 0
    assert torch.equal(grads[True], grads[False]), rel


# ---------------------------------------------------------------------------
# The metric networks: plain PyTorch (cuDNN convolutions, cuBLAS products)
# in f32 with TF32 off. The card and the CPU sum in other orders: features
# within 1e-4 of the largest CPU value.

EXTRACTOR_REL_TOL = 1e-4


def _rel_to_cpu(card, cpu):
    return float((card.float().cpu() - cpu).abs().max() / cpu.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [32, 299, 320])
def test_inception_extractor_on_the_card_matches_the_cpu(cuda_device, size):
    """The seeded random-weight Inception-V3 (the FID/IS proxy), features
    and logits, from images that preprocess grows, keeps or shrinks."""
    from itsd_tpu_torch.metrics.inception import (inception_from_state_dict,
                                                  init_random_params)

    sd = init_random_params(torch.Generator().manual_seed(42))
    cpu = inception_from_state_dict(sd)
    card = inception_from_state_dict(sd).to(cuda_device)
    x = torch.rand((4, size, size, 3),
                   generator=torch.Generator().manual_seed(size))
    with torch.inference_mode():
        f_cpu, l_cpu = cpu(x)
        f_card, l_card = card(x.to(cuda_device))
    assert _rel_to_cpu(f_card, f_cpu) <= EXTRACTOR_REL_TOL
    assert _rel_to_cpu(l_card, l_cpu) <= EXTRACTOR_REL_TOL


def _seeded_clip(cfg):
    from itsd_tpu_torch.metrics.clip import CLIPModel

    model = CLIPModel(cfg)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen)
                        if name.endswith("weight")
                        else 0.1 * torch.randn(p.shape, generator=gen))
            elif p.dim() >= 2:
                fan_in = p[0].numel() if "embedding" not in name else 50
                p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval().requires_grad_(False)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [32, 256])
def test_clip_extractor_on_the_card_matches_the_cpu(cuda_device, size):
    """A 4-layer CLIP of ViT-B/32's patch and image size: image features
    (bicubic from 32 and 256), text features."""
    from itsd_tpu_torch.metrics.clip import CLIPConfig, preprocess

    cfg = CLIPConfig(vision_width=256, vision_layers=4, vision_heads=4,
                     vision_mlp=1024, text_width=256, text_layers=4,
                     text_heads=4, text_mlp=1024, vocab_size=1000,
                     context_length=16, projection_dim=128)
    cpu = _seeded_clip(cfg)
    card = _seeded_clip(cfg).to(cuda_device)
    x = torch.rand((4, size, size, 3),
                   generator=torch.Generator().manual_seed(size))
    ids = torch.randint(1, 999, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        img_cpu = cpu.image_features(preprocess(x, 224))
        img_card = card.image_features(preprocess(x.to(cuda_device), 224))
        txt_cpu = cpu.text_features(ids)
        txt_card = card.text_features(ids.to(cuda_device))
    assert _rel_to_cpu(img_card, img_cpu) <= EXTRACTOR_REL_TOL
    assert _rel_to_cpu(txt_card, txt_cpu) <= EXTRACTOR_REL_TOL


# The ViT-B/16's attention at 256x256 (256 tokens of 12 heads of width 64,
# folded into the batch): the train batch 16 and the eval batch 8.
VIT_ATTENTION = [(16 * 12, 256, 64), (8 * 12, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,C", VIT_ATTENTION)
def test_vit_attention_on_mma_at_c64(cuda_device, dtype, B, N, C):
    """``mha_attention`` with a gradient, as a ViT block runs it: the
    folded [B*H, N, 64] forward, dq and dk/dv on the route each dtype
    takes (bf16: mma; f32: the forward tf32x3, dq and dk/dv simt), against
    the plain versions of the same
    formula on the folded tensors at the tolerances above (bf16: plus the
    f32 summation-order bound of dq and dk; the backward from the kernel's
    o and lse, as the autograd Function saved them), and the forward
    without a gradient equal to the one with."""
    H = 12
    gen = torch.Generator(device=cuda_device).manual_seed(B + C)
    q, k, v, do = (torch.randn((B // H, N, H, C), generator=gen,
                               device=cuda_device).to(dtype)
                   for _ in range(4))
    which = attention.route(dtype, C, "forward")
    assert which == ("mma" if dtype == torch.bfloat16 else "tf32x3")
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    counts = _counts()
    tf32x3 = attention.tf32x3_launches
    o = attention.mha_attention(*ins)
    got = torch.autograd.grad(o, ins, do)
    with torch.no_grad():
        o_nograd = attention.mha_attention(q, k, v)
    torch.cuda.synchronize()
    mma = int(which == "mma")
    assert _launched(counts) == (2, 2 * mma, 0, 1, mma, 0, 1, mma, 0)
    assert attention.tf32x3_launches - tf32x3 == 2 * (1 - mma)
    assert torch.equal(o.detach(), o_nograd)

    def fold(t):
        return t.transpose(1, 2).reshape(B, N, C)

    def unfold(t):
        return t.reshape(B // H, H, N, C).transpose(1, 2)

    fq, fk, fv, fdo = map(fold, (q, k, v, do))
    scale = C ** -0.5
    want_o, want_lse = attention.attention_plain_stats(fq, fk, fv, scale)
    # the backward's inputs as the autograd Function saved them: the
    # kernel's o and lse (deterministic: a relaunch gives the same bits)
    ko, lse = attention.attention_with_lse(fq, fk, fv, scale)
    assert torch.equal(unfold(ko), o.detach())
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    want = attention.attention_bwd_plain(fq, fk, fv, ko, lse, fdo, scale)
    if dtype == torch.float32:
        torch.testing.assert_close(o, unfold(want_o), atol=2e-5, rtol=0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, unfold(w), atol=BWD_F32_TOL,
                                       rtol=0)
        return
    _close_bf16(o, unfold(want_o), v)
    bounds = (_dq_order_bound(fq, fk, fv, fdo, lse, scale),
              _dk_order_bound(fq, fk, fv, fdo, lse, scale), 0.0)
    for name, g, w, bound in zip(("dq", "dk", "dv"), got, want, bounds):
        err = (fold(g).float() - w.float()).abs()
        limit = (BF16_RTOL * w.float().abs().max()
                 + BF16_RTOL * w.float().abs() + bound)
        assert (err <= limit).all(), f"{name}: max err {err.max().item():.3g}"


def _vit_cfg(dtype, **kw):
    from itsd_tpu_torch.models import ViTConfig

    return ViTConfig(img_size=64, patch_size=8, embed_dim=768, depth=2,
                     num_heads=12, dtype=dtype, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_kernel_path_matches_plain_path(cuda_device, dtype):
    """A ViT at ViT-B's width (768, 12 heads of 64; 2 blocks, 64 tokens)
    through the kernels ("auto": one forward launch a block, on mma in
    bf16) against the same weights through the plain path ("xla"):
    1e-4 of the largest |eps| in f32, 0.05 in bf16 (a rounding to the
    neighbouring bf16 value at the attention output moves every later
    layer)."""
    import dataclasses

    from itsd_tpu_torch.models import ViT

    cfg = _vit_cfg(dtype)
    model = ViT(cfg)
    model.init_weights(torch.Generator().manual_seed(4))
    plain = ViT(dataclasses.replace(cfg, attention_impl="xla"))
    plain.load_state_dict(model.state_dict())
    model.to(cuda_device).eval()
    plain.to(cuda_device).eval()
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((8, 64, 64, 3), generator=gen, device=cuda_device)
    t = torch.tensor([0, 10, 100, 400, 600, 800, 900, 999],
                     device=cuda_device)
    counts = _counts()
    with torch.no_grad():
        got = model(x, t)
        n = _launched(counts)
        want = plain(x, t)
    torch.cuda.synchronize()
    assert n == (2, 2 * (dtype == "bfloat16"), 0, 0, 0, 0, 0, 0, 0)
    assert _launched(counts) == n
    tol = (1e-4 if dtype == "float32" else 0.05) * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["unet", "vit"])
def test_remat_gradient_on_the_card(cuda_device, backbone, dtype):
    """The gradient of <eps, cot> through the remat'd model equals the one
    without remat bit for bit under cuDNN's deterministic algorithms, with
    dropout 0.3 whose masks come from one CUDA generator (the recompute
    draws the same masks and leaves the generator where the forward did);
    the remat'd backward reruns each block's forward (the attention
    forward launches twice a call, dq and dk/dv once)."""
    import dataclasses

    from itsd_tpu_torch.models import UNet, ViT, uncond_unet_config

    if backbone == "unet":
        cfg = uncond_unet_config(ch=64, ch_mult=(1, 2), attn=(1,),
                                 num_res_blocks=1, dropout=0.3, dtype=dtype)
        build, S = UNet, 16
    else:
        cfg = dataclasses.replace(_vit_cfg(dtype), dropout=0.3)
        build, S = ViT, 64
    base = build(cfg)
    base.init_weights(torch.Generator().manual_seed(6))
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((4, S, S, 3), generator=gen, device=cuda_device)
    t = torch.tensor([3, 300, 600, 900], device=cuda_device)
    cot = torch.randn(x.shape, generator=gen, device=cuda_device)
    grads, states, launched = {}, {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            m = build(dataclasses.replace(cfg, remat=remat))
            m.load_state_dict(base.state_dict())
            m.to(cuda_device).train()
            g = torch.Generator(device=cuda_device).manual_seed(8)
            counts = _counts()
            eps = m(x, t, deterministic=False, generator=g)
            (eps * cot).sum().backward()
            torch.cuda.synchronize()
            launched[remat] = _launched(counts)
            grads[remat] = {k: p.grad for k, p in m.named_parameters()}
            states[remat] = g.get_state()
    finally:
        torch.backends.cudnn.deterministic = prev
    calls = launched[False][0]
    assert calls > 0 and launched[False][3] == launched[False][6] == calls
    assert launched[True][0] == 2 * calls
    assert launched[True][3:] == launched[False][3:]
    assert torch.equal(states[True], states[False])
    for k, g in grads[False].items():
        assert torch.equal(grads[True][k], g), k
