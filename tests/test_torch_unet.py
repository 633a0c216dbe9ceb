"""The port's UNet, time embedding and weight converter against the JAX
package's.

Weights: the Flax parameter tree's structure comes from the JAX UNet
(``jax.eval_shape`` of its ``init``); its values are drawn with numpy from a
seed at O(1/sqrt(fan_in)) for every kernel, near 1 for GroupNorm scales and
O(0.1) for biases. The JAX init would scale the residual, attention and tail
output layers by 1e-5, which would hide those branches from the comparison.
The same tree goes through ``params_from_jax`` into the port.

Tolerances:
* f32: 1e-5 absolute on outputs O(1). The two frameworks sum conv and
  matmul products in different orders; measured ~2e-6.
* bf16: 2^-5 of the largest output (four bf16 steps there). Both compute in
  bf16 with f32 parameters, but XLA fuses bias and residual adds into f32
  before rounding where torch rounds after every op, so layer outputs land on
  neighbouring bf16 values; measured ~2 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.models.embeddings import \
    sinusoidal_features as jax_sinusoidal_features
from itsd_tpu_torch.models import (UNet, cond_unet_config, params_from_jax,
                                   sinusoidal_features, uncond_unet_config)
from itsd_tpu_torch.models.convert import expected_shapes

from _torch_port import flax_params, one_torch_thread  # noqa: F401

SMALL = dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1)


def _inputs(B=2, S=16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    t = np.array([3, 917][:B], np.int32)
    return x, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_matches_jax(dtype):
    x, t = _inputs()
    jm = JaxUNet(jax_uncond_config(dtype=dtype, **SMALL))
    params = flax_params(jm, x, t, seed=1)
    want, want_rep = jax.jit(
        lambda p, x, t: jm.apply(p, x, t, return_representation=True))(
            params, jnp.asarray(x), jnp.asarray(t))
    want = np.asarray(want)

    model = UNet(uncond_unet_config(dtype=dtype, **SMALL))
    model.load_state_dict(params_from_jax(params, model.cfg))
    with torch.no_grad():
        got, rep = model(torch.from_numpy(x), torch.from_numpy(t),
                         return_representation=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    atol = 1e-5 if dtype == "float32" else 2.0 ** -5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    want_rep = np.asarray(want_rep, np.float32)
    rep_atol = 1e-5 if dtype == "float32" else 2.0 ** -5 * np.abs(
        want_rep).max()
    np.testing.assert_allclose(rep.float().numpy(), want_rep, atol=rep_atol,
                               rtol=0)


def test_sinusoidal_features_match_jax():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jax_sinusoidal_features(jnp.asarray(t), 64))
    got = sinusoidal_features(torch.from_numpy(t), 64).numpy()
    # f32 sin/cos of arguments up to 999 rad: a few ulps of the argument
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(ch=128, ch_mult=(1, 2, 2, 2), attn=(1,), num_res_blocks=2),
    dict(ch=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1),
    dict(ch=16, ch_mult=(1, 2, 3), attn=(0, 2), num_res_blocks=2),
])
def test_param_names_and_shapes_cover_the_flax_tree(kw):
    x, t = _inputs(B=1, S=32)
    shapes = jax.eval_shape(JaxUNet(jax_uncond_config(**kw)).init,
                            jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t[:1]))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = params_from_jax(zeros, uncond_unet_config(**kw))
    assert list(sd) == list(expected_shapes(uncond_unet_config(**kw)))
    n_flax = sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(v.numel() for v in sd.values()) == n_flax


def _small_tree():
    x, t = _inputs()
    shapes = jax.eval_shape(JaxUNet(jax_uncond_config(**SMALL)).init,
                            jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)["params"]


def test_converter_raises_on_missing_key():
    tree = _small_tree()
    del tree["down_1_0"]["attn"]["q"]
    with pytest.raises(KeyError, match="down_1_0.attn.q"):
        params_from_jax(tree, uncond_unet_config(**SMALL))


def test_converter_raises_on_extra_key():
    tree = _small_tree()
    tree["down_0_0"]["cond_proj"] = {"kernel": np.zeros((128, 32)),
                                     "bias": np.zeros(32)}
    with pytest.raises(KeyError, match="cond_proj"):
        params_from_jax(tree, uncond_unet_config(**SMALL))


def test_converter_raises_on_wrong_shape():
    tree = _small_tree()
    tree["head"]["kernel"] = np.zeros((3, 3, 3, 16), np.float32)
    with pytest.raises(ValueError, match="head.weight"):
        params_from_jax(tree, uncond_unet_config(**SMALL))


def test_conv_and_dense_layouts():
    tree = _small_tree()
    rng = np.random.default_rng(3)
    conv = rng.standard_normal((3, 3, 3, 32)).astype(np.float32)   # HWIO
    dense = rng.standard_normal((128, 32)).astype(np.float32)      # in, out
    tree["head"]["kernel"] = conv
    tree["down_0_0"]["temb_proj"]["kernel"] = dense
    tree["tail_norm"]["scale"] = np.arange(32, dtype=np.float32)
    sd = params_from_jax(tree, uncond_unet_config(**SMALL))
    assert np.array_equal(sd["head.weight"].numpy()[5, 2, 1, 0],
                          conv[1, 0, 2, 5])
    assert np.array_equal(sd["down_0_0.temb_proj.weight"].numpy(), dense.T)
    assert np.array_equal(sd["tail_norm.weight"].numpy(), np.arange(32))


@pytest.mark.parametrize("kw", [dict(attention_impl="xla"),
                                dict(attention_impl="flash"),
                                dict(attention_impl="ring")])
def test_unported_variants_raise(kw):
    """Every attention_impl builds, "ring" (sequence-sharded attention)
    too (tests/test_torch_vit.py and tests/test_torch_ring_attention.py
    check what they compute); an unknown one raises."""
    assert UNet(uncond_unet_config(**SMALL, **kw)).cfg.attention_impl \
        == kw["attention_impl"]
    with pytest.raises(ValueError, match="unknown attention_impl"):
        UNet(uncond_unet_config(**SMALL, attention_impl="sparse"))


def test_cond_config_matches_jax():
    want = dataclasses.asdict(jax_cond_config(num_labels=7, ch=32, T=50))
    got = dataclasses.asdict(cond_unet_config(num_labels=7, ch=32, T=50))
    assert got == want


def test_init_weights_is_seeded_and_tiny_on_output_layers():
    a = UNet(uncond_unet_config(**SMALL))
    b = UNet(uncond_unet_config(**SMALL))
    a.init_weights(torch.Generator().manual_seed(5))
    b.init_weights(torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert sd["tail_conv.weight"].abs().max() < 1e-5
    assert sd["down_1_0.attn.proj.weight"].abs().max() < 1e-5
    assert sd["head.weight"].abs().max() > 0.05
    assert torch.equal(sd["down_0_0.norm1.weight"], torch.ones(32))
