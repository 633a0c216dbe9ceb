"""Gaussian diffusion forward and reverse process: tensor functions.

Counterpart of ``itsd_tpu/core/process.py:31-171``: the training terms and
the sampling half (guidance comes with a later part of the port).

Images are NHWC float32 in [-1, 1]; ``t`` is an integer ``[B]`` tensor of
timestep indices on the images' device, so no step waits on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .schedules import DiffusionSchedule

# eps_fn(x_t [B,...], t [B]) -> predicted noise [B,...]
EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def extract(v: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped [B, 1, 1, ...]."""
    out = v[t].float()
    return out.reshape(t.shape + (1,) * (ndim - 1))


def q_sample(sched: DiffusionSchedule, x_0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward process: x_t = sqrt(a_bar_t) x_0 + sqrt(1 - a_bar_t) eps."""
    nd = x_0.dim()
    return (extract(sched.sqrt_alphas_bar, t, nd) * x_0
            + extract(sched.sqrt_one_minus_alphas_bar, t, nd) * noise)


def diffusion_train_terms(
    sched: DiffusionSchedule, generator: Optional[torch.Generator],
    x_0: torch.Tensor, t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(t, noise, x_t) for one training step: uniform t in [0, T) and
    gaussian noise drawn from ``generator`` (t first), unless passed in.
    JAX draws both from a split threefry key, which torch cannot
    reproduce, so the tests pass JAX's t and noise in."""
    if t is None:
        t = torch.randint(0, sched.T, (x_0.shape[0],), generator=generator,
                          device=x_0.device)
    if noise is None:
        noise = torch.randn(x_0.shape, generator=generator, dtype=x_0.dtype,
                            device=x_0.device)
    return t, noise, q_sample(sched, x_0, t, noise)


def mse_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-element squared error (the reference's ``reduction='none'``)."""
    return torch.square(pred - target)


def snr(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """SNR_t = alphas_bar_t / (1 - alphas_bar_t)."""
    ab = sched.alphas_bar[t]
    return ab / (1.0 - ab)


def min_snr_weight(sched: DiffusionSchedule, t: torch.Tensor,
                   gamma: float = 5.0) -> torch.Tensor:
    """Min-SNR-gamma loss weight for eps-prediction (Hang et al. 2023):
    min(SNR_t, gamma) / SNR_t."""
    s = snr(sched, t)
    return torch.clamp(s, max=gamma) / s


def loss_reduce(loss: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """``mean`` (the unconditional loop) or ``sum_div_b2`` (the CFG loop's
    ``loss.sum() / b ** 2``)."""
    if mode == "mean":
        return loss.mean()
    if mode == "sum_div_b2":
        b = loss.shape[0]
        return loss.sum() / (b * b)
    raise ValueError(f"unknown loss reduction: {mode!r}")


def predict_prev_mean_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor,
                               t: torch.Tensor,
                               eps: torch.Tensor) -> torch.Tensor:
    """mu_theta(x_t, t) = coeff1_t * x_t - coeff2_t * eps."""
    nd = x_t.dim()
    return (extract(sched.coeff1, t, nd) * x_t
            - extract(sched.coeff2, t, nd) * eps)


def p_mean_variance(sched: DiffusionSchedule, x_t: torch.Tensor,
                    t: torch.Tensor, eps: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and the sampler's variance table value."""
    var = extract(sched.sampler_var, t, x_t.dim())
    mean = predict_prev_mean_from_eps(sched, x_t, t, eps)
    return mean, var


def p_sample_step(sched: DiffusionSchedule, x_t: torch.Tensor,
                  t: torch.Tensor, eps: torch.Tensor, noise: torch.Tensor, *,
                  clip_x0: bool = False) -> torch.Tensor:
    """One reverse step: x_{t-1} = mu + sqrt(var) * noise, noiseless at t=0
    by a mask, not a branch.

    ``clip_x0`` clips the implied x_0-hat to [-1, 1] and re-derives eps
    from it before the posterior mean.
    """
    nd = x_t.dim()
    if clip_x0:
        x0 = predict_x0_from_eps(sched, x_t, t, eps).clamp(-1.0, 1.0)
        eps = ((x_t - extract(sched.sqrt_alphas_bar, t, nd) * x0)
               / extract(sched.sqrt_one_minus_alphas_bar, t, nd))
    mean, var = p_mean_variance(sched, x_t, t, eps)
    nonzero = (t > 0).to(x_t.dtype).reshape(t.shape + (1,) * (nd - 1))
    return mean + nonzero * torch.sqrt(var) * noise


def predict_x0_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor,
                        t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """x_0-hat = (x_t - sqrt(1-a_bar) eps) / sqrt(a_bar)."""
    nd = x_t.dim()
    return ((x_t - extract(sched.sqrt_one_minus_alphas_bar, t, nd) * eps)
            / extract(sched.sqrt_alphas_bar, t, nd))
