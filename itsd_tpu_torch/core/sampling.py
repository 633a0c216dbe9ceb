"""Ancestral DDPM sampling as a Python loop over t.

Counterpart of ``itsd_tpu/core/sampling.py:36-115``. The loop runs on the
host but never waits on the device: timesteps are built on the device, the
t=0 step is noiseless by a mask, and there is no per-step ``.item()`` or
NaN check. An eps_fn that sets ``takes_step`` (a guided one) gets the
step's timestep as a Python int, ``step=t``, so that a guidance interval
is decided on the host without reading a device value.

JAX draws each step's noise from a split threefry key, which torch cannot
reproduce. So the noise comes from ``noise_fn(step_index, t)`` when one is
given (the tests feed the JAX key chain's noise through it), and otherwise
from ``torch.randn`` with the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .process import EpsFn, p_sample_step
from .schedules import DiffusionSchedule

NoiseFn = Callable[[int, int], torch.Tensor]


def _scan_steps(sched: DiffusionSchedule, eps_fn: EpsFn, x: torch.Tensor,
                t_hi: int, t_lo: int, *,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None,
                clip_x0: bool = False) -> torch.Tensor:
    """Run reverse steps for t = t_hi-1, ..., t_lo (inclusive)."""
    B = x.shape[0]
    takes_step = getattr(eps_fn, "takes_step", False)
    for i, t in enumerate(range(t_hi - 1, t_lo - 1, -1)):
        tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
        eps = eps_fn(x, tb, step=t) if takes_step else eps_fn(x, tb)
        if noise_fn is not None:
            noise = noise_fn(i, t)
        else:
            noise = torch.randn(x.shape, generator=generator,
                                dtype=x.dtype, device=x.device)
        x = p_sample_step(sched, x, tb, eps, noise, clip_x0=clip_x0)
    return x


def sample(sched: DiffusionSchedule, eps_fn: EpsFn, x_T: torch.Tensor, *,
           generator: Optional[torch.Generator] = None,
           noise_fn: Optional[NoiseFn] = None, clip_output: bool = True,
           clip_denoised: bool = False) -> torch.Tensor:
    """Full ancestral sampling x_T -> x_0, clipped to [-1, 1]."""
    x = _scan_steps(sched, eps_fn, x_T, sched.T, 0, generator=generator,
                    noise_fn=noise_fn, clip_x0=clip_denoised)
    return x.clamp(-1.0, 1.0) if clip_output else x


def denoise_segment(sched: DiffusionSchedule, eps_fn: EpsFn,
                    x_t: torch.Tensor, t_from: int, t_to: int = 0, *,
                    generator: Optional[torch.Generator] = None,
                    noise_fn: Optional[NoiseFn] = None,
                    clip_output: bool = False,
                    clip_denoised: bool = False) -> torch.Tensor:
    """Denoise from state x_{t_from} down to x_{t_to}: the first step
    evaluated is t = t_from - 1; with t_to = 0 this finishes the chain."""
    if not 0 <= t_to < t_from <= sched.T:
        raise ValueError(f"need 0 <= t_to < t_from <= T, got "
                         f"t_from={t_from} t_to={t_to} T={sched.T}")
    x = _scan_steps(sched, eps_fn, x_t, t_from, t_to, generator=generator,
                    noise_fn=noise_fn, clip_x0=clip_denoised)
    return x.clamp(-1.0, 1.0) if clip_output else x
