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
             (8, 512, 4, 4), (2, 96, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for B, C, H, W in GN_SHAPES:
        x = (torch.randn((B, C, H, W), generator=gen, device=cuda_device)
             * 2 + 0.5).to(dtype)
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=cuda_device)
        b = 0.1 * torch.randn(C, generator=gen, device=cuda_device)
        for act in (True, False):
            got = groupnorm.groupnorm_swish(x, w, b, _groups(C), act=act)
            want = groupnorm.groupnorm_swish_plain(x, w, b, _groups(C),
                                                   act=act)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=BF16_RTOL, atol=1e-3)


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
    q = torch.randn((2, 16, 6), device=cuda_device)
    with pytest.raises(ValueError, match="C % 4"):
        attention.spatial_attention(q, q, q)
    q = torch.randn((2, 16, 32), device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        attention.spatial_attention(q, q.bfloat16(), q)
    shifted = torch.randn(2 * 16 * 32 + 1, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.spatial_attention(shifted.view(2, 16, 32), q, q)
