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

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.kernels.attention import (_attention_flash,
                                        _attention_flash_bwd,
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


@pytest.mark.parametrize("C", [384, 512, 1024])
def test_attention_at_the_wide_widths_matches_flash_interpret(C):
    """The yardstick of the wide kernels at the CFG UNet's widths and the
    flagship's C=384, on CPU tensors (the plain versions): the forward
    with lse and the backward with dlse against the Pallas forward and
    backward kernels in interpret mode, f32, 2e-5 (measured ~1.7e-6 on
    values up to ~2)."""
    rng = np.random.default_rng(C)
    q, k, v, do = (rng.standard_normal((1, 64, C)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((1, 64)).astype(np.float32)
    scale = C ** -0.5
    want_o, want_lse = _attention_flash_stats(
        *map(jnp.asarray, (q, k, v)), scale, block_q=32, block_k=32,
        interpret=True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention.attention_with_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=2e-5, rtol=0)
    want = _attention_flash_bwd(
        *map(jnp.asarray, (q, k, v, o.numpy())),
        jnp.asarray(lse.numpy())[..., None], jnp.asarray(do), scale,
        block_q=32, block_k=32, interpret=True,
        dlse=jnp.asarray(dlse)[..., None])
    got = attention.attention_bwd(tq, tk, tv, o, lse, tdo, scale,
                                  torch.from_numpy(dlse))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=0)


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


# want: the kernel of all three functions (forward, dq and dk/dv).
@pytest.mark.parametrize("dtype,C,want", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 100, "simt"), (torch.bfloat16, 384, "wide"),
    (torch.bfloat16, 512, "wide"), (torch.float32, 16, "simt"),
    (torch.float32, 256, "simt"), (torch.float32, 384, "simt"),
    (torch.bfloat16, 768, "wide"), (torch.bfloat16, 1024, "wide"),
    (torch.bfloat16, 1040, "simt"), (torch.bfloat16, 520, "simt"),
    (torch.float32, 512, "simt"), (torch.float32, 1024, "simt")])
def test_route_is_chosen_by_dtype_and_width(dtype, C, want, monkeypatch):
    """bf16 rows of a multiple of 16 up to 256 take the tensor-core
    kernels; from 272 to 1024 the wide tensor-core kernels, dq included;
    f32 (kept off the tensor cores) and other widths the CUDA-core ones.
    The forward, dq and dk/dv wrappers each hand their launch the route's
    kernel (the launches are recorded, not made)."""
    routes = dict.fromkeys(attention.KERNELS, want)
    assert {kernel: attention.route(dtype, C, kernel)
            for kernel in routes} == routes
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
    assert chosen == [("_launch_forward", routes["forward"]),
                      ("_launch_dq", routes["dq"]),
                      ("_launch_dkv", routes["dkv"])]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_at_every_width_the_kernels_take(dtype):
    """Every C the kernels take (C % 4 == 0 up to 1024), for all three
    functions: bf16 with C % 16 == 0 goes to "mma" up to 256 and to "wide"
    above; f32 and every other width to "simt"."""
    for C in range(4, attention.MAX_C + 1, 4):
        if dtype != torch.bfloat16 or C % 16:
            want = "simt"
        else:
            want = "mma" if C <= attention.MMA_MAX_C else "wide"
        assert {kernel: attention.route(dtype, C, kernel)
                for kernel in attention.KERNELS} == dict.fromkeys(
                    attention.KERNELS, want), C


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="kernel must be one of"):
        attention.route(torch.bfloat16, 512, "backward")


@pytest.mark.parametrize("B", [1, 800, 65535])
def test_check_batch_takes_a_batch_up_to_the_grid_cap(B):
    """The kernels put the batch in gridDim.y, at most 65,535 (Picard folds
    400 and 800 rows at n=50)."""
    attention.check_batch(B)


@pytest.mark.parametrize("B", [65536, 128000])
def test_check_batch_refuses_a_batch_past_the_grid_cap(B):
    """Past the cap (Picard's fold under CFG at B=64, n=1000 is 128,000
    rows) the check raises a ValueError that names the limit."""
    with pytest.raises(ValueError, match="at most 65535"):
        attention.check_batch(B)


def test_a_batch_past_the_grid_cap_raises_before_any_launch(monkeypatch):
    """Each entry point refuses a batch past the cap before it loads the
    library or counts a launch (a recording stand-in for the library, on
    CPU tensors, which the wrappers are handed directly)."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda: calls.append("load"))
    B, N, C = attention.MAX_GRID_Y + 1, 1, 4
    q, k, v, do = (torch.zeros((B, N, C)) for _ in range(4))
    lse, dd = torch.zeros((B, N)), torch.zeros((B, N))
    before = [getattr(attention, n) for n in COUNTERS]
    for launch in (lambda: attention._flash(q, k, v, 0.5, emit_lse=True),
                   lambda: attention.flash_bwd_dq(q, k, v, do, lse, dd, 0.5),
                   lambda: attention.flash_bwd_dkv(q, k, v, do, lse, dd,
                                                   0.5)):
        with pytest.raises(ValueError, match="gridDim.y"):
            launch()
    assert calls == []
    assert [getattr(attention, n) for n in COUNTERS] == before


COUNTERS = ("launches", "mma_launches", "wide_launches", "dq_launches",
            "dq_mma_launches", "dq_wide_launches", "dkv_launches",
            "dkv_mma_launches", "dkv_wide_launches", "mma_sync_launches",
            "dq_mma_sync_launches", "dkv_mma_sync_launches")


def _plain_path_launches_nothing(dtype, C, N=16):
    before = [getattr(attention, n) for n in COUNTERS]
    gen = torch.Generator().manual_seed(C)
    q, k, v, do = (torch.randn((2, N, C), generator=gen).to(dtype)
                   for _ in range(4))
    scale = C ** -0.5
    o, lse = attention.attention_with_lse(q, k, v, scale)
    want_o, want_lse = attention.attention_plain_stats(q, k, v, scale)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(attention.spatial_attention(q, k, v),
                       attention.attention_plain(q, k, v, scale))
    got = attention.attention_bwd(q, k, v, o, lse, do, scale)
    want = attention.attention_bwd_plain(q, k, v, o, lse, do, scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [getattr(attention, n) for n in COUNTERS] == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_no_kernel_of_either_route(dtype):
    _plain_path_launches_nothing(dtype, 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [512, 1024])
def test_cpu_tensors_at_the_wide_widths_launch_no_kernel(dtype, C):
    """The CFG UNet's C=512 and C=1024, which bf16 sends to the wide
    kernels on the card, take the plain versions for CPU tensors and launch
    no kernel of any route, through the differentiable path too."""
    _plain_path_launches_nothing(dtype, C, N=4)
    before = [getattr(attention, n) for n in COUNTERS]
    q, k, v = (torch.randn((1, 4, C)).to(dtype).requires_grad_()
               for _ in range(3))
    o, _ = attention.flash_attention(q, k, v, C ** -0.5)
    o.float().sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert [getattr(attention, n) for n in COUNTERS] == before


# Each source's widest C (its kMaxC, and kMinC where it has one: the wide
# kernels take only C above it) against the limits ``route`` and ``_check``
# use.
@pytest.mark.parametrize("source,max_c,min_c", [
    ("flash_attention.cu", "MAX_C", None),
    ("flash_attention_bwd.cu", "MAX_C", None),
    ("flash_attention_mma.cu", "MMA_MAX_C", None),
    ("flash_attention_bwd_dq_mma.cu", "MMA_MAX_C", None),
    ("flash_attention_bwd_mma.cu", "MMA_MAX_C", None),
    ("flash_attention_hopper.cu", "MMA_MAX_C", None),
    ("flash_attention_bwd_dq_hopper.cu", "MMA_MAX_C", None),
    ("flash_attention_bwd_dkv_hopper.cu", "MMA_MAX_C", None),
    ("flash_attention_wide.cu", "WIDE_MAX_C", "MMA_MAX_C"),
    ("flash_attention_bwd_dq_wide.cu", "WIDE_MAX_C", "MMA_MAX_C"),
    ("flash_attention_bwd_wide.cu", "WIDE_MAX_C", "MMA_MAX_C")])
def test_kernel_width_limits_match_the_route(source, max_c, min_c):
    text = (_build.CSRC / source).read_text()

    def constant(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", text)
        assert len(found) == 1, f"{source}: {name} defined {len(found)} times"
        return int(found[0])

    assert constant("kMaxC") == getattr(attention, max_c)
    if min_c is not None:
        assert constant("kMinC") == getattr(attention, min_c)


_EXTERN_C = re.compile(r'extern "C" int (itsd_\w+)\(([^)]*)\)')


def test_every_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` entry point of csrc/ has a SIGNATURES entry with
    one ctypes type a parameter: pointers (and the stream) as c_void_p,
    ints as c_int, floats as c_float."""
    kinds = {"c_void_p": ctypes.c_void_p, "int": ctypes.c_int,
             "float": ctypes.c_float}
    found = {}
    for p in _build.sources():
        for name, params in _EXTERN_C.findall(p.read_text()):
            types = []
            for param in params.split(","):
                param = " ".join(param.split())
                types.append(kinds["c_void_p" if "*" in param
                                   else param.split()[-2]])
            found[name] = tuple(types)
    assert {"itsd_flash_attention_wide", "itsd_flash_bwd_dq_wide",
            "itsd_flash_bwd_dkv_wide", "itsd_flash_bwd_dq_mma_sync",
            "itsd_groupnorm_partial_stats_cluster",
            "itsd_groupnorm_stats_floor"} <= set(found)
    assert found == _build.SIGNATURES


def test_build_commands_are_one_nvcc_per_source_for_sm90a(tmp_path):
    cmds = _build.compile_commands("nvcc", tmp_path)
    srcs = _build.sources()
    assert {"groupnorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
            "flash_attention_mma.cu", "flash_attention_bwd_mma.cu",
            "flash_attention_bwd_dq_mma.cu", "flash_attention_wide.cu",
            "flash_attention_bwd_dq_wide.cu",
            "flash_attention_bwd_wide.cu", "flash_attention_hopper.cu",
            "flash_attention_bwd_dq_hopper.cu",
            "flash_attention_bwd_dkv_hopper.cu"} <= {p.name for p in srcs}
    assert len(cmds) == len(srcs)
    for cmd, src in zip(cmds, srcs):
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert cmd[cmd.index("-o") + 1] == str(tmp_path / f"{src.stem}.o")
    link = _build.link_command("nvcc", tmp_path, tmp_path / "lib.so")
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    assert [a for a in link if a.endswith(".o")] == [
        cmd[cmd.index("-o") + 1] for cmd in cmds]
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


@pytest.mark.parametrize("wrapper", ["_flash_mma_sync",
                                     "_flash_bwd_dq_mma_sync",
                                     "_flash_bwd_dkv_mma_sync"])
def test_mma_sync_forced_calls_take_no_cpu_tensor(wrapper):
    """The forced calls of the mma.sync kernels (which the Hopper kernels
    replaced on the mma route) have no plain version to fall back to: a CPU
    tensor raises before any build or launch, and no count moves."""
    q = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 8))
    args = ((q, q, q, 0.125, False) if wrapper == "_flash_mma_sync"
            else (q, q, q, q, lse, lse, 0.125))
    before = [getattr(attention, n) for n in COUNTERS]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        getattr(attention, wrapper)(*args)
    assert [getattr(attention, n) for n in COUNTERS] == before


GN_COUNTERS = ("launches", "stats_launches", "apply_launches",
               "stats_cluster_launches")


@pytest.mark.parametrize("wrapper,with_mean", [
    ("_groupnorm_partial_stats_cluster", False),
    ("_groupnorm_partial_stats_cluster", True),
    ("_groupnorm_stats_floor", False)])
def test_stats_forced_calls_take_no_cpu_tensor(wrapper, with_mean,
                                               monkeypatch):
    """The forced calls of the earlier stats kernel (the new one's
    yardstick) and of the empty kernel on the new plan's grid have no plain
    version: a CPU tensor raises before any build or launch, and no count
    moves."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda: calls.append("load"))
    x = torch.zeros((2, 8, 4, 4), dtype=torch.bfloat16)
    args = (x, 4)
    if with_mean:
        args += (torch.zeros((2, 4)),)
    before = [getattr(groupnorm, n) for n in GN_COUNTERS]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        getattr(groupnorm, wrapper)(*args)
    assert calls == []
    assert [getattr(groupnorm, n) for n in GN_COUNTERS] == before


def test_stats_on_cpu_tensors_take_the_plain_version(monkeypatch):
    """``groupnorm_partial_stats`` hands a CPU tensor to its plain version
    (the sum, and the squared deviations around a given mean) without
    loading the library or counting a launch."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda: calls.append("load"))
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 4, 4), generator=gen).to(torch.bfloat16)
    before = [getattr(groupnorm, n) for n in GN_COUNTERS]
    s1 = groupnorm.groupnorm_partial_stats(x, 4)
    assert torch.equal(s1, groupnorm.groupnorm_partial_stats_plain(x, 4))
    mean = s1 / 32
    assert torch.equal(groupnorm.groupnorm_partial_stats(x, 4, mean),
                       groupnorm.groupnorm_partial_stats_plain(x, 4, mean))
    assert calls == []
    assert [getattr(groupnorm, n) for n in GN_COUNTERS] == before


def test_parse_sass_counts_opcodes_per_kernel():
    """``cuobjdump -sass`` text to {kernel: {opcode: count}}: a mnemonic
    counts under each opcode it starts with, after a predicate guard, and
    a kernel without any counts 0."""
    text = (
        "\tcode for sm_90a\n"
        "\t\tFunction : _Z3fooPf\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;  "
        "/* 0x000fe20000000f00 */\n"
        "        /*0010*/                   UTMALDG.3D [UR8], [UR4] ;  "
        "/* 0x0 */\n"
        "        /*0020*/              @P0  HGMMA.64x64x16.F32.BF16 R24, "
        "gdesc[UR4], RZ, !UPT ;  /* 0x0 */\n"
        "        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, "
        "gdesc[UR8], R24, gsb0 ;  /* 0x0 */\n"
        "\t\tFunction : _Z3barPf\n"
        "        /*0000*/                   EXIT ;  /* 0x0 */\n")
    assert _build.parse_sass(text, ("HGMMA", "UTMALDG")) == {
        "_Z3fooPf": {"HGMMA": 2, "UTMALDG": 1},
        "_Z3barPf": {"HGMMA": 0, "UTMALDG": 0}}


def test_parse_ptxas_report():
    text = (
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 72 registers, 384 bytes cmem[0]\n")
    assert _build.parse_ptxas(text) == (("_Z3fooPf", 72, 4, 4),)
