"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX references (the XLA path, and the Pallas kernels in
interpret mode). test_torch_cuda.py holds each CUDA kernel against its plain
version on the card.

Tolerances:
* f32, same algorithm (two-pass GroupNorm, explicit-softmax attention):
  2e-5 absolute. Only the order of f32 sums differs: ~1e-6 on values O(1).
* f32 against the Pallas GroupNorm: 1e-4, since that kernel takes the
  variance in one pass (E[x^2] - mean^2), which loses a few more bits.
* f32 against the online-softmax flash kernel: 2e-5 (rescaled running sums).
* bf16 outputs: one bf16 rounding step (relative 2^-7) apart, because the
  same f32 value can round to neighbouring bf16 values when the f32
  intermediates differ in their last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.kernels.attention import (_attention_flash,
                                        _attention_flash_stats,
                                        _attention_xla)
from itsd_tpu.kernels.groupnorm import (groupnorm_swish_pallas,
                                        groupnorm_swish_xla)
from itsd_tpu.models.unet import _groups as jax_groups
from itsd_tpu_torch.kernels import _build, attention, groupnorm
from itsd_tpu_torch.models.unet import _groups

from _torch_port import one_torch_thread  # noqa: F401

BF16_RTOL = 2.0 ** -7


def _gn_inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C", [96, 128, 384])
@pytest.mark.parametrize("act", [True, False])
def test_groupnorm_plain_matches_xla(C, act):
    x, scale, bias = _gn_inputs(C, 2, 8, 8, C)
    G = _groups(C)
    want = groupnorm_swish_xla(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), groups=G, act=act)
    got = groupnorm.groupnorm_swish(_nchw(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), G, act=act)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("C", [96, 128, 384])
def test_groupnorm_plain_matches_pallas_interpret(C):
    x, scale, bias = _gn_inputs(C + 1, 2, 8, 8, C)
    G = _groups(C)
    want = groupnorm_swish_pallas(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), groups=G, act=True,
                                  interpret=True)
    got = groupnorm.groupnorm_swish_plain(_nchw(x), torch.from_numpy(scale),
                                          torch.from_numpy(bias), G)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("act", [True, False])
def test_groupnorm_plain_matches_xla_past_48kb_spans(act):
    """[1, 384, 64, 64]: 12 channels of 4096 pixels a group, a span of
    49,152 f32 values (192 KB), past what one block of the old kernel held
    in L1; the plain version the CUDA kernel is held against on the card
    still agrees with the XLA reference to 2e-5 (f32 sums in another
    order)."""
    x, scale, bias = _gn_inputs(11, 1, 64, 64, 384)
    G = _groups(384)
    assert 384 // G * 64 * 64 * 4 > 48 * 1024
    want = groupnorm_swish_xla(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), groups=G, act=act)
    got = groupnorm.groupnorm_swish(_nchw(x), torch.from_numpy(scale),
                                    torch.from_numpy(bias), G, act=act)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_groupnorm_plain_bf16_matches_xla():
    x, scale, bias = _gn_inputs(7, 2, 8, 8, 128)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(groupnorm_swish_xla(xb, jnp.asarray(scale),
                                          jnp.asarray(bias), groups=32),
                      np.float32)
    got = groupnorm.groupnorm_swish(
        _nchw(np.asarray(xb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(scale), torch.from_numpy(bias), 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=BF16_RTOL, atol=1e-3)


@pytest.mark.parametrize("C", [1, 3, 48, 96, 128, 384, 512, 640])
def test_groups_matches_jax(C):
    assert _groups(C) == jax_groups(C)


def _qkv(seed, B, N, C):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, C)).astype(np.float32)
            for _ in range(3)]


def test_attention_plain_matches_xla_and_flash_interpret():
    q, k, v = _qkv(0, 2, 256, 128)
    scale = 128 ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = attention.spatial_attention(*map(torch.from_numpy, (q, k, v)))
    want_xla = np.asarray(_attention_xla(jq, jk, jv, scale))
    want_flash = np.asarray(_attention_flash(jq, jk, jv, scale, block_q=128,
                                             block_k=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), want_xla, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_flash, atol=2e-5, rtol=0)


def test_attention_lse_matches_flash_stats_interpret():
    q, k, v = _qkv(1, 2, 256, 128)
    scale = 128 ** -0.5
    want_o, want_lse = _attention_flash_stats(
        *map(jnp.asarray, (q, k, v)), scale, block_q=128, block_k=64,
        interpret=True)
    o, lse = attention.attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                          scale)
    assert lse.shape == (2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=2e-5, rtol=0)


def test_attention_plain_bf16_matches_xla():
    q, k, v = _qkv(2, 2, 64, 32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(_attention_xla(*jb, 32 ** -0.5), np.float32)
    got = attention.spatial_attention(
        *[torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in jb])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=1e-3)


def test_wrappers_refuse_devices_without_a_path():
    x = torch.empty((1, 32, 4, 4), device="meta")
    w = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="no path"):
        groupnorm.groupnorm_swish(x, w, w, 32)
    q = torch.empty((1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="no path"):
        attention.spatial_attention(q, q, q)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = (groupnorm.launches, attention.launches)
    x = torch.randn(1, 32, 4, 4)
    w = torch.ones(32)
    assert torch.equal(groupnorm.groupnorm_swish(x, w, w, 8),
                       groupnorm.groupnorm_swish_plain(x, w, w, 8))
    q = torch.randn(1, 16, 32)
    assert torch.equal(attention.spatial_attention(q, q, q),
                       attention.attention_plain(q, q, q, 32 ** -0.5))
    assert (groupnorm.launches, attention.launches) == before


@pytest.mark.parametrize("dtype,C,want", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 100, "simt"), (torch.bfloat16, 384, "simt"),
    (torch.bfloat16, 512, "simt"), (torch.float32, 16, "simt"),
    (torch.float32, 256, "simt"), (torch.float32, 384, "simt")])
def test_route_is_chosen_by_dtype_and_width(dtype, C, want, monkeypatch):
    """bf16 rows of a multiple of 16 up to 256 take the tensor-core
    kernels; f32 (kept off the tensor cores) and other widths the CUDA-core
    ones. The forward, dq and dk/dv wrappers each hand their launch the
    route's kernel (the launches are recorded, not made)."""
    assert attention.route(dtype, C) == want
    chosen = []
    for name in ("_launch_forward", "_launch_dq", "_launch_dkv"):
        monkeypatch.setattr(attention, name,
                            lambda *a, name=name: chosen.append((name,
                                                                 a[-1])))
    q = torch.zeros((1, 4, C), dtype=dtype)
    lse = torch.zeros((1, 4))
    attention._flash(q, q, q, 0.5, emit_lse=True)
    attention.flash_bwd_dq(q, q, q, q, lse, lse, 0.5)
    attention.flash_bwd_dkv(q, q, q, q, lse, lse, 0.5)
    mma = want == "mma"
    assert chosen == [("_launch_forward", mma), ("_launch_dq", mma),
                      ("_launch_dkv", mma)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_no_kernel_of_either_route(dtype):
    names = ("launches", "mma_launches", "dq_launches", "dq_mma_launches",
             "dkv_launches", "dkv_mma_launches")
    before = [getattr(attention, n) for n in names]
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 16, 256), generator=gen).to(dtype)
                   for _ in range(4))
    scale = 256 ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(attention.spatial_attention(q, k, v),
                       attention.attention_plain(q, k, v, scale))
    got = attention.attention_bwd(q, k, v, o, lse, do, scale)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [getattr(attention, n) for n in names] == before


def test_build_command_is_one_nvcc_call_for_sm90a(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / "lib.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    srcs = {p.name for p in _build.sources()}
    assert {"groupnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
            "flash_attention_mma.cu", "flash_attention_bwd_mma.cu",
            "flash_attention_bwd_dq_mma.cu"} <= srcs
    assert all(str(p) in cmd for p in _build.sources())
    for p in _build.CSRC.glob("*.cu*"):
        assert "torch/extension.h" not in p.read_text()


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                      "exit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.load.__wrapped__()
    # nothing but the (empty) hashed directory is left behind
    (out_dir,) = (tmp_path / "build").iterdir()
    assert list(out_dir.iterdir()) == []


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_parse_ptxas_report():
    text = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 72 registers, 384 bytes cmem[0]\n")
    assert _build.parse_ptxas(text) == (("_Z3fooPf", 72, 4, 4),)
