"""The port's schedules, reverse process and ancestral sampler against the
JAX package's.

The schedule tables are computed in float64 by numpy on both sides and cast
to float32, so they must agree bit for bit. The process functions are
elementwise f32 arithmetic in the same order: 1e-6 absolute. The sampler
runs the small UNet in f32 from one x_T with the JAX key chain's noise fed
through ``noise_fn``: each step's eps differs by ~2e-6 (see
test_torch_unet.py) and enters x with a weight coeff2 <= 0.1, so 20 steps
stay within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.core import denoise_segment as jax_denoise_segment
from itsd_tpu.core import linear_schedule as jax_linear_schedule
from itsd_tpu.core import process as jax_process
from itsd_tpu.core import sample as jax_sample
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu_torch.core import (denoise_segment, linear_schedule,
                                 make_schedule, process, sample)
from itsd_tpu_torch.models import UNet, params_from_jax, uncond_unet_config

from _torch_port import flax_params, one_torch_thread  # noqa: F401

FIELDS = ["betas", "alphas", "alphas_bar", "sqrt_alphas_bar",
          "sqrt_one_minus_alphas_bar", "coeff1", "coeff2", "posterior_var",
          "sampler_var"]


@pytest.mark.parametrize("beta_1,beta_T,T", [(1e-4, 0.02, 1000),
                                             (1e-4, 0.028, 2000),
                                             (1e-3, 0.05, 20)])
def test_schedule_tables_equal_jax(beta_1, beta_T, T):
    want = jax_linear_schedule(beta_1, beta_T, T)
    got = linear_schedule(beta_1, beta_T, T, device="cpu")
    assert got.T == want.T == got.num_timesteps
    for f in FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_make_schedule_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown schedule kind"):
        make_schedule(1e-4, 0.02, 10, kind="cosine", device="cpu")


def _process_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 6, 3)) * 1.5).astype(np.float32)
    eps = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    return x, eps, noise, t


@pytest.mark.parametrize("name", ["q_sample", "predict_prev_mean_from_eps",
                                  "predict_x0_from_eps", "p_mean_variance",
                                  "p_sample_step", "p_sample_step_clip"])
def test_process_matches_jax(name):
    x, eps, noise, t = _process_inputs()
    js = jax_linear_schedule(1e-4, 0.02, 1000)
    ts = linear_schedule(1e-4, 0.02, 1000, device="cpu")
    jx, je, jn, jt = map(jnp.asarray, (x, eps, noise, t))
    tx, te, tn, tt = map(torch.from_numpy, (x, eps, noise, t))
    if name == "p_sample_step":
        want = jax_process.p_sample_step(js, jx, jt, je, jn)
        got = process.p_sample_step(ts, tx, tt, te, tn)
    elif name == "p_sample_step_clip":
        want = jax_process.p_sample_step(js, jx, jt, je, jn, clip_x0=True)
        got = process.p_sample_step(ts, tx, tt, te, tn, clip_x0=True)
    elif name == "q_sample":
        want = jax_process.q_sample(js, jx, jt, jn)
        got = process.q_sample(ts, tx, tt, tn)
    else:
        want = getattr(jax_process, name)(js, jx, jt, je)
        got = getattr(process, name)(ts, tx, tt, te)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def test_t0_step_is_noiseless():
    x, eps, noise, _ = _process_inputs()
    ts = linear_schedule(1e-4, 0.02, 1000, device="cpu")
    t = torch.zeros(4, dtype=torch.int64)
    a = process.p_sample_step(ts, torch.from_numpy(x), t,
                              torch.from_numpy(eps), torch.from_numpy(noise))
    b = process.p_sample_step(ts, torch.from_numpy(x), t,
                              torch.from_numpy(eps), torch.zeros(4, 6, 6, 3))
    assert torch.equal(a, b)


def _jax_noise_chain(key, n, shape):
    """The noise JAX's _scan_steps draws at each of ``n`` steps."""
    out = []
    for _ in range(n):
        key, nkey = jax.random.split(key)
        out.append(np.array(jax.random.normal(nkey, shape, jnp.float32)))
    return out


SMALL = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1)


@pytest.mark.parametrize("mode", ["sample", "segment_clip_denoised"])
def test_sampler_matches_jax_with_fed_noise(mode):
    T, B, S = 20, 2, 8
    rng = np.random.default_rng(4)
    x_T = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    jm = JaxUNet(jax_uncond_config(**SMALL))
    params = flax_params(jm, x_T, np.zeros(B, np.int32), seed=2)
    js = jax_linear_schedule(1e-4, 0.02, T)
    key = jax.random.PRNGKey(7)
    eps_j = lambda x, t: jm.apply(params, x, t)
    if mode == "sample":
        t_from, t_to = T, 0
        want = jax.jit(lambda x, k: jax_sample(js, eps_j, x, k))(
            jnp.asarray(x_T), key)
    else:
        t_from, t_to = 12, 3
        want = jax.jit(lambda x, k: jax_denoise_segment(
            js, eps_j, x, k, t_from, t_to, clip_denoised=True))(
                jnp.asarray(x_T), key)
    noises = _jax_noise_chain(key, t_from - t_to, x_T.shape)

    model = UNet(uncond_unet_config(**SMALL))
    model.load_state_dict(params_from_jax(params, model.cfg))
    ts = linear_schedule(1e-4, 0.02, T, device="cpu")
    seen = []

    def noise_fn(i, t):
        seen.append((i, t))
        return torch.from_numpy(noises[i])

    with torch.no_grad():
        if mode == "sample":
            got = sample(ts, model, torch.from_numpy(x_T), noise_fn=noise_fn)
        else:
            got = denoise_segment(ts, model, torch.from_numpy(x_T), t_from,
                                  t_to, noise_fn=noise_fn,
                                  clip_denoised=True)
    assert seen == list(enumerate(range(t_from - 1, t_to - 1, -1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    if mode == "sample":
        assert got.abs().max() <= 1.0


def test_sampler_default_noise_comes_from_the_generator():
    ts = linear_schedule(1e-4, 0.02, 5, device="cpu")
    eps_fn = lambda x, t: torch.zeros_like(x)
    x = torch.zeros(2, 4, 4, 3)
    a = sample(ts, eps_fn, x, generator=torch.Generator().manual_seed(3))
    b = sample(ts, eps_fn, x, generator=torch.Generator().manual_seed(3))
    c = sample(ts, eps_fn, x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_denoise_segment_checks_bounds():
    ts = linear_schedule(1e-4, 0.02, 5, device="cpu")
    with pytest.raises(ValueError, match="t_to < t_from"):
        denoise_segment(ts, lambda x, t: x, torch.zeros(1, 2, 2, 3), 3, 3)
