"""Diffusion noise schedules: the per-timestep coefficient tables.

Counterpart of ``itsd_tpu/core/schedules.py``. The tables are computed in
float64 with numpy and stored as float32 tensors on the schedule's device.
The fast samplers build their timestep grids and coefficients on the host,
from ``alphas_bar_host``: the float32 table upcast to float64, as JAX's
``_host_alphas_bar`` reads it, kept on the host so that no sampler reads a
device tensor back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Every field but ``T`` and ``alphas_bar_host`` is a float32 ``[T]``
    tensor; ``alphas_bar_host`` is ``alphas_bar`` as a float64 numpy array
    on the host."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_bar: torch.Tensor
    sqrt_alphas_bar: torch.Tensor
    sqrt_one_minus_alphas_bar: torch.Tensor
    coeff1: torch.Tensor
    coeff2: torch.Tensor
    posterior_var: torch.Tensor
    # variance the ancestral sampler uses: concat([posterior_var[1:2],
    # betas[1:]])
    sampler_var: torch.Tensor
    alphas_bar_host: np.ndarray
    T: int

    @property
    def num_timesteps(self) -> int:
        return self.T


def linear_schedule(beta_1: float, beta_T: float, T: int,
                    device="cuda") -> DiffusionSchedule:
    """Linear beta schedule, computed in float64 then cast to float32."""
    betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas, axis=0)
    alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])

    coeff1 = np.sqrt(1.0 / alphas)
    coeff2 = coeff1 * (1.0 - alphas) / np.sqrt(1.0 - alphas_bar)
    posterior_var = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)
    sampler_var = np.concatenate([posterior_var[1:2], betas[1:]])

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return DiffusionSchedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_bar=f32(alphas_bar),
        sqrt_alphas_bar=f32(np.sqrt(alphas_bar)),
        sqrt_one_minus_alphas_bar=f32(np.sqrt(1.0 - alphas_bar)),
        coeff1=f32(coeff1),
        coeff2=f32(coeff2),
        posterior_var=f32(posterior_var),
        sampler_var=f32(sampler_var),
        alphas_bar_host=alphas_bar.astype(np.float32).astype(np.float64),
        T=int(T),
    )


def make_schedule(beta_1: float, beta_T: float, T: int, kind: str = "linear",
                  device="cuda") -> DiffusionSchedule:
    """Schedule factory; only the linear schedule exists."""
    if kind == "linear":
        return linear_schedule(beta_1, beta_T, T, device=device)
    raise ValueError(f"unknown schedule kind: {kind!r}")
