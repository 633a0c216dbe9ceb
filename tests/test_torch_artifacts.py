"""The port's UNet and ancestral sampler on trained weights: the committed
checkpoint ``artifacts/shapes32_uncond`` (the unconditional UNet trained on
the shapes dataset at 32x32, stored in bf16) against the JAX package.

The weights are restored with ``itsd_tpu.train.checkpoint.restore_params``
and cast to f32 as ``bench.py:load_artifact_params`` does, then converted in
memory with ``params_from_jax``; nothing is written to ``artifacts/``. Both
sides run in f32.

Tolerances:
* one UNet forward at t=10 and t=900 (|eps| up to 3.85): 1e-5 absolute.
  The frameworks sum conv and matmul products in different orders;
  measured 1.4e-6.
* the first 10 ancestral steps from one x_T (t = 999..990), with the noise
  JAX's chain draws fed to the port through ``noise_fn`` as numpy arrays:
  1e-5 absolute. Each step's eps differs by ~1e-6 and enters x with a
  weight coeff2 ~ 0.02 there, while each step's 1/sqrt(alpha) gain is ~1;
  measured 9.5e-7 on |x| up to 4.1.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.core import denoise_segment as jax_denoise_segment
from itsd_tpu.core import linear_schedule as jax_linear_schedule
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.train.checkpoint import restore_params
from itsd_tpu_torch.core import denoise_segment, linear_schedule
from itsd_tpu_torch.models import UNet, params_from_jax, uncond_unet_config

from _torch_port import one_torch_thread  # noqa: F401

ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "artifacts", "shapes32_uncond")
B, S, CHAIN = 2, 32, 10


@pytest.fixture(scope="module")
def trained():
    """(JAX UNet, f32 params, arch, port UNet with the same weights)."""
    with open(ARTIFACT + ".json") as f:
        meta = json.load(f)
    a = meta["arch"]
    arch = dict(ch=a["ch"], ch_mult=tuple(a["ch_mult"]), attn=tuple(a["attn"]),
                num_res_blocks=a["num_res_blocks"], dropout=a["dropout"])
    params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32)
        if getattr(x, "dtype", None) == jnp.bfloat16 else jnp.asarray(x),
        restore_params(ARTIFACT))
    jm = JaxUNet(jax_uncond_config(**arch))
    model = UNet(uncond_unet_config(**arch))
    model.load_state_dict(params_from_jax(params, model.cfg))
    model.eval()
    return jm, params, meta, model


def test_trained_unet_matches_jax(trained):
    jm, params, meta, model = trained
    assert meta["arch"]["img"] == S and meta["arch"]["num_labels"] is None
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    for t in (10, 900):
        tb = np.full((B,), t, np.int32)
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                            jnp.asarray(tb)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(tb)).numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_trained_chain_matches_jax_with_fed_noise(trained):
    jm, params, meta, model = trained
    T = meta["train_T"]
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda x, k: jax_denoise_segment(
        jax_linear_schedule(1e-4, 0.02, T), lambda x, t: jm.apply(params, x, t),
        x, k, T, T - CHAIN))(jnp.asarray(x_T), key)
    # the noise JAX's chain draws at each step, as numpy arrays
    noises = []
    for _ in range(CHAIN):
        key, nkey = jax.random.split(key)
        noises.append(np.array(jax.random.normal(nkey, x_T.shape,
                                                 jnp.float32)))
    ts = linear_schedule(1e-4, 0.02, T, device="cpu")
    with torch.no_grad():
        got = denoise_segment(ts, model, torch.from_numpy(x_T), T, T - CHAIN,
                              noise_fn=lambda i, t: torch.from_numpy(
                                  noises[i]))
    assert got.shape == x_T.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
