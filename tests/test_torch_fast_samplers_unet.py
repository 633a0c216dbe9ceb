"""The fast and composite samplers on the small UNets, through
``runner.run_sampler``, against the JAX package's ``run_sampler``.

Both packages read the same config (T=20, ``diffusion.ddim_steps=5``) and
start from one seeded numpy x_T; the UNets carry the same seeded weights,
unconditional and conditional (CFG w=1.8 on labels 1..B). Deterministic
samplers (DDIM at eta 0, DPM-Solver++, Picard) run through the port's
``run_sampler`` as they are. The stochastic ones (DDIM at eta 1, restart)
draw from a torch generator there, so the port's core function runs with
JAX's draws fed through ``noise_fn``, and the port's ``run_sampler`` is
held to that core function on one generator, bit for bit.

Tolerance: 1e-4 absolute. Each eps differs by ~2e-6 (unconditional,
test_torch_unet.py) or 4.6 times the conditional forward's 1e-5 (CFG,
test_torch_guidance.py); DDIM's x0 divides it by sqrt(abar_t) >= 0.91 on
this T=20 chain, and the short chains add up to 5 of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from itsd_tpu.cli import runner as jax_runner
from itsd_tpu.core import linear_schedule as jax_linear_schedule
from itsd_tpu.models import UNet as JaxUNet
from itsd_tpu.models import cond_unet_config as jax_cond_config
from itsd_tpu.models import uncond_unet_config as jax_uncond_config
from itsd_tpu.utils import load_config as jax_load_config
from itsd_tpu_torch import core
from itsd_tpu_torch.cli import runner
from itsd_tpu_torch.core.sampling import segment_cost
from itsd_tpu_torch.models import (UNet, cond_unet_config, params_from_jax,
                                   uncond_unet_config)
from itsd_tpu_torch.utils import load_config

from _torch_port import flax_params, one_torch_thread  # noqa: F401

T, B, SIZE, W = 20, 2, 8, 1.8
UNCOND = dict(ch=16, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
              dropout=0.0, T=T)
COND = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, dropout=0.0, T=T,
            num_labels=10)
TOL = 1e-4
SAMPLERS = {
    "ddim": ["diffusion.sampler=ddim"],
    "ddim_eta1": ["diffusion.sampler=ddim", "diffusion.ddim_eta=1.0"],
    "dpm": ["diffusion.sampler=dpm"],
    "picard": ["diffusion.sampler=picard"],
    "restart_ddpm": ["diffusion.restart_intervals=[[15,5,1]]",
                     "diffusion.clip_denoised=true"],
    "restart_ddim": ["diffusion.sampler=ddim", "diffusion.ddim_eta=0.5",
                     "diffusion.restart_intervals=[[12,4,2]]"],
}


# Each restart case compiles a JAX scan a segment: one family a model.
CASES = ([("uncond", n) for n in SAMPLERS if n != "restart_ddpm"]
         + [("cfg", n) for n in SAMPLERS if n != "restart_ddim"])


@pytest.fixture(scope="module")
def pair(request):
    """(JAX eps_fn, port eps_fn) of the small UNet: unconditional, or
    guided by CFG w=1.8 on labels 1..B."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    t = np.zeros(B, np.int32)
    labels = np.arange(1, B + 1, dtype=np.int32)
    if request.param == "uncond":
        jm = JaxUNet(jax_uncond_config(**UNCOND))
        params = flax_params(jm, x, t, seed=5)
        model = UNet(uncond_unet_config(**UNCOND))
    else:
        jm = JaxUNet(jax_cond_config(attention_impl="xla", **COND))
        params = flax_params(jm, x, t, 6, labels)
        model = UNet(cond_unet_config(**COND))
    model.load_state_dict(params_from_jax(params, model.cfg))
    model.eval()
    cond = request.param == "cfg"
    jeps = jax_runner.make_eps_fn(jm, params, cond,
                                  jnp.asarray(labels) if cond else None, W)
    teps = runner.make_eps_fn(model, cond,
                              torch.from_numpy(labels) if cond else None, W)
    return jeps, teps


def _configs(extra):
    keys = [f"diffusion.T={T}", "diffusion.ddim_steps=5", *extra]
    return jax_load_config(None, keys), load_config(None, keys)


def _split_chain(key, n):
    out = []
    for _ in range(n):
        key, nkey = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(nkey, (B, SIZE, SIZE, 3), jnp.float32))))
    return out


def _jax_draws(cfg, key):
    """noise_fn of the port's core function for JAX's run_sampler draws."""
    d = cfg.diffusion
    if not d.restart_intervals:
        noise = _split_chain(key, d.ddim_steps)
        return lambda i, t: noise[i]
    cost = segment_cost(T, d.sampler, d.ddim_steps)
    (t_max, t_min, k), = d.restart_intervals
    kinds = [cost(T, t_max), cost(t_max, t_min)] + [
        None, cost(t_max, t_min)] * k + [cost(t_min, 0)]
    draws = {}
    for c, n in enumerate(kinds, start=1):
        ck = jax.random.fold_in(key, c)
        draws[c] = ([torch.from_numpy(np.array(jax.random.normal(
            ck, (B, SIZE, SIZE, 3))))] if n is None else _split_chain(ck, n))
    return lambda c, i, t: draws[c][i]


def _core(cfg, sched, eps_fn, x, **noise):
    d = cfg.diffusion
    if d.restart_intervals:
        return core.restart_sample(
            sched, eps_fn, x, restarts=d.restart_intervals,
            sampler=d.sampler, num_steps=d.ddim_steps,
            clip_denoised=d.clip_denoised, eta=d.ddim_eta, **noise)
    return core.ddim_sample(sched, eps_fn, x, num_steps=d.ddim_steps,
                            eta=d.ddim_eta, **noise)


@pytest.mark.parametrize("pair,name", CASES, indirect=["pair"])
def test_run_sampler_matches_jax_on_the_small_unet(pair, name):
    jeps, teps = pair
    jcfg, cfg = _configs(SAMPLERS[name])
    x_T = np.random.default_rng(7).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jax_runner.run_sampler(jcfg, jax_linear_schedule(1e-4, 0.02, T),
                                  jeps, jnp.asarray(x_T), key)
    sched = runner.build_schedule(cfg, inference=True, device="cpu")
    x = torch.from_numpy(x_T)
    with torch.no_grad():
        if name in ("ddim", "dpm", "picard"):
            got = runner.run_sampler(cfg, sched, teps, x,
                                     torch.Generator().manual_seed(0))
        else:
            got = _core(cfg, sched, teps, x,
                        noise_fn=_jax_draws(cfg, key))
            mine = runner.run_sampler(cfg, sched, teps, x,
                                      torch.Generator().manual_seed(1))
            again = _core(cfg, sched, teps, x,
                          generator=torch.Generator().manual_seed(1))
            assert torch.equal(mine, again)
    assert torch.isfinite(got).all() and got.abs().max() <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
