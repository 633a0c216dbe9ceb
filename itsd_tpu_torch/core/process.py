"""Gaussian diffusion forward and reverse process: tensor functions.

Counterpart of ``itsd_tpu/core/process.py:31-309``: the training terms,
the sampling half and guidance (classifier-free guidance and
autoguidance).

Images are NHWC float32 in [-1, 1]; ``t`` is an integer ``[B]`` tensor of
timestep indices on the images' device, so no step waits on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from ..parallel import draw, row_windows
from .schedules import DiffusionSchedule

# eps_fn(x_t [B,...], t [B]) -> predicted noise [B,...]. A guided eps_fn
# also takes ``step=``, the step's timestep as a Python int, which the
# sampler passes to eps_fns that set ``takes_step`` (see make_cfg_eps_fn).
EpsFn = Callable[..., torch.Tensor]
# model_eps_fn(x_t, t, labels [B]) -> eps: a conditional model's forward
CondEpsFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     torch.Tensor]


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
    gaussian noise drawn from ``generator`` (t first), unless passed in;
    a ``parallel.RowDraws`` draws them for the global batch (the noise for
    the global images) and keeps this rank's block. JAX draws both from a
    split threefry key, which torch cannot reproduce, so the tests pass
    JAX's t and noise in."""
    if t is None:
        t = draw(functools.partial(torch.randint, 0, sched.T),
                 (x_0.shape[0],), generator, device=x_0.device)
    if noise is None:
        noise = draw(torch.randn, x_0.shape, generator,
                     h_axis=1 if x_0.dim() == 4 else None, dtype=x_0.dtype,
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


def cfg_combine(eps_cond: torch.Tensor, eps_uncond: torch.Tensor,
                w: float) -> torch.Tensor:
    """Classifier-free-guidance mix: (1+w)*eps_cond - w*eps_uncond."""
    return (1.0 + w) * eps_cond - w * eps_uncond


def _validate_interval(interval) -> None:
    """Raise on a guidance interval that would silently disable guidance:
    reversed (lo > hi) or with a fractional endpoint (the timesteps are
    integers). An empty interval (lo == hi) stays legal: it is the
    explicit "guidance off" arm of a sweep (see cfg_nfes)."""
    if interval is None:
        return
    lo, hi = interval
    for v in (lo, hi):
        if isinstance(v, bool) or float(v) != int(v):
            raise ValueError(f"cfg interval ({lo}, {hi}): endpoints must be "
                             "integral timesteps")
    if lo > hi:
        raise ValueError(
            f"cfg interval (lo={lo}, hi={hi}) is reversed: guidance would "
            "never activate; want lo <= hi (lo == hi means guidance off)")


def _tile(labels: torch.Tensor, batch: int) -> torch.Tensor:
    n = labels.shape[0]
    if batch == n:
        return labels
    if batch % n:
        raise ValueError(f"batch {batch} is not a multiple of the "
                         f"{n} labels")
    return labels.repeat(batch // n)


def _tile_labels(labels: torch.Tensor, batch: int) -> torch.Tensor:
    """Labels [B] for a batch that folds several candidates of each
    position (N*B rows): tiled across the fold. On a rank's rows of a fold
    split over the ranks (``parallel.on_local_rows``), the labels are tiled
    over each open window's global rows and cut to the window's, so each
    row has its global row's label."""
    for start, rows, total in row_windows():
        labels = _tile(labels, total)[start:start + rows]
    return _tile(labels, batch)


def _guided_now(interval, step: Optional[int]) -> bool:
    """Whether the step at timestep ``step`` is guided. The decision is
    made on the host from the Python int the sampler passes, never from
    the device tensor t, so a step does not wait on the device."""
    if interval is None:
        return True
    if step is None:
        raise ValueError("a guided eps_fn with a cfg interval needs the "
                         "step's timestep as a Python int (step=...)")
    return interval[0] <= step < interval[1]


def make_cfg_eps_fn(model_eps_fn: CondEpsFn, labels: torch.Tensor, w: float,
                    interval: Optional[Tuple[int, int]] = None) -> EpsFn:
    """A guided eps_fn from a conditional model: ONE dual-batched forward,
    ``cat([x, x])`` with ``[labels, 0]`` (0 is the null class), mixed by
    ``cfg_combine``.

    ``interval=(lo, hi)`` restricts guidance to timesteps lo <= t < hi;
    outside it the step runs one conditional forward at batch B, and the
    dual forward is not spent there (``cfg_nfes`` counts it so). The step
    is read from ``step``, the Python int the sampler passes (``t`` is
    constant across the batch within a step)."""
    _validate_interval(interval)

    def eps_fn(x_t: torch.Tensor, t: torch.Tensor,
               step: Optional[int] = None) -> torch.Tensor:
        lab = _tile_labels(labels, x_t.shape[0])
        if not _guided_now(interval, step):
            return model_eps_fn(x_t, t, lab)
        eps2 = model_eps_fn(torch.cat([x_t, x_t]), torch.cat([t, t]),
                            torch.cat([lab, torch.zeros_like(lab)]))
        eps_c, eps_u = eps2.chunk(2)
        return cfg_combine(eps_c, eps_u, w)

    eps_fn.takes_step = True
    return eps_fn


def make_autoguidance_eps_fn(strong_eps_fn: CondEpsFn, weak_eps_fn: CondEpsFn,
                             labels: torch.Tensor, w: float,
                             interval: Optional[Tuple[int, int]] = None
                             ) -> EpsFn:
    """Autoguidance (Karras et al. 2024): ``(1+w)*eps_strong - w*eps_weak``,
    both forwards conditioned on the same labels. The two carry different
    weights, so they run as two forwards at batch B. ``interval`` restricts
    guidance as in ``make_cfg_eps_fn`` (one strong forward outside it)."""
    _validate_interval(interval)

    def eps_fn(x_t: torch.Tensor, t: torch.Tensor,
               step: Optional[int] = None) -> torch.Tensor:
        lab = _tile_labels(labels, x_t.shape[0])
        if not _guided_now(interval, step):
            return strong_eps_fn(x_t, t, lab)
        return cfg_combine(strong_eps_fn(x_t, t, lab),
                           weak_eps_fn(x_t, t, lab), w)

    eps_fn.takes_step = True
    return eps_fn


def cfg_nfes(T: int, interval: Optional[Tuple[int, int]] = None) -> int:
    """Model evals per image for a T-step guided chain: 2 per step inside
    the guidance interval, 1 outside (2T for full-range guidance)."""
    if interval is None:
        return 2 * T
    lo, hi = int(interval[0]), int(interval[1])
    return T + max(0, min(hi, T) - max(lo, 0))
