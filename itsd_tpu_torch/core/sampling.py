"""The samplers: ancestral DDPM, DDIM, DPM-Solver++(2M), restart sampling,
parallel-in-time Picard iteration, segment denoisers and snapshots.

Counterpart of ``itsd_tpu/core/sampling.py``. Each loop runs on the host
but never waits on the device: timesteps and coefficients are Python
numbers, computed on the host from the schedule's host table
(``alphas_bar_host``), the t=0 step is noiseless by a mask, and there is no
per-step ``.item()`` or NaN check. The one exception is Picard iteration,
which reads its convergence measure back once a sweep to decide whether to
stop (JAX decides it on the device inside ``lax.while_loop``). An eps_fn
that sets ``takes_step`` (a guided one) gets the step's timestep as a
Python int, ``step=t``, so that a guidance interval is decided on the host
without reading a device value.

The timestep grids follow JAX's arithmetic: ``ddim_sample`` rounds a
float32 grid (``ddim_timesteps``), the segments and Picard round float64
numpy grids.

Noise. JAX draws each step's noise from a split threefry key, which torch
cannot reproduce. So every stochastic function (the ancestral steps, DDIM
with eta > 0, ``renoise`` and ``restart_sample``) takes ``generator=``, a
``torch.Generator`` it draws from in order, and ``noise_fn=``, which, when
given, supplies each draw instead:

* ``noise_fn(i, t)`` for one call of a sampler or segment: draw ``i`` of the
  call, counted from 0 in the order of the steps (the ancestral samplers
  and DDIM number a draw by its step, whether or not earlier steps drew),
  at the step's timestep ``t``; ``renoise`` makes draw 0 at ``t_target``.
  ``sample_with_snapshots`` numbers its draws across the whole chain, as
  one ``sample`` call does.
* ``noise_fn(call, i, t)`` for ``restart_sample``: ``call`` numbers its
  segment and renoise calls from 1 in the order they run, as JAX's
  ``fold_in`` counter does, and ``(i, t)`` is as above within that call.

The parity tests feed JAX's noise through it.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import draw, local_rows, on_local_rows, under_row_windows
from .process import EpsFn, p_sample_step
from .schedules import DiffusionSchedule

NoiseFn = Callable[[int, int], torch.Tensor]


def _eps(eps_fn: EpsFn, x: torch.Tensor, t: int) -> torch.Tensor:
    """eps_fn at timestep ``t`` for the whole batch; ``step=t`` for an
    eps_fn that sets ``takes_step``."""
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    if getattr(eps_fn, "takes_step", False):
        return eps_fn(x, tb, step=t)
    return eps_fn(x, tb)


def _draw(x: torch.Tensor, i: int, t: int, generator, noise_fn):
    if noise_fn is not None:
        return noise_fn(i, t)
    return draw(torch.randn, x.shape, generator, dtype=x.dtype,
                device=x.device)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. A CUDA copy goes through pinned memory
    without waiting, so that the sampler makes no synchronizing call."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _f32(v) -> float:
    """A Python float holding the float32 value of ``v``."""
    return float(np.float32(v))


def _scan_steps(sched: DiffusionSchedule, eps_fn: EpsFn, x: torch.Tensor,
                t_hi: int, t_lo: int, *,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None,
                clip_x0: bool = False, remat: bool = False) -> torch.Tensor:
    """Run reverse steps for t = t_hi-1, ..., t_lo (inclusive).

    ``remat`` checkpoints each step (``torch.utils.checkpoint``): its
    activations are dropped after the forward and recomputed in the
    backward, as ``jax.checkpoint`` does in JAX's scan. The checkpoint
    restores only the global generators, so each step's noise is drawn
    before the checkpointed call and passed in: the recompute then sees the
    same noise, and the generator advances once a step. The recompute runs
    under the windows of global rows open at the forward
    (``parallel.under_row_windows``), so a guided eps_fn on a rank's rows
    tiles its labels alike in both."""
    B = x.shape[0]
    takes_step = getattr(eps_fn, "takes_step", False)

    def step(x, noise, t):
        tb = torch.full((B,), t, dtype=torch.int64, device=x.device)
        eps = eps_fn(x, tb, step=t) if takes_step else eps_fn(x, tb)
        return p_sample_step(sched, x, tb, eps, noise, clip_x0=clip_x0)

    if remat:
        step = under_row_windows(step)
    for i, t in enumerate(range(t_hi - 1, t_lo - 1, -1)):
        noise = _draw(x, i, t, generator, noise_fn)
        if remat:
            # nothing inside draws, so no generator state to preserve
            x = checkpoint(step, x, noise, t, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = step(x, noise, t)
    return x


def sample(sched: DiffusionSchedule, eps_fn: EpsFn, x_T: torch.Tensor, *,
           generator: Optional[torch.Generator] = None,
           noise_fn: Optional[NoiseFn] = None, clip_output: bool = True,
           clip_denoised: bool = False, remat: bool = False) -> torch.Tensor:
    """Full ancestral sampling x_T -> x_0, clipped to [-1, 1]. ``remat``
    recomputes each step's activations in the backward instead of holding
    all T steps' (``_scan_steps``): gradient search's chain."""
    x = _scan_steps(sched, eps_fn, x_T, sched.T, 0, generator=generator,
                    noise_fn=noise_fn, clip_x0=clip_denoised, remat=remat)
    return x.clamp(-1.0, 1.0) if clip_output else x


def _check_range(t_from: int, t_to: int, T: int) -> None:
    if not 0 <= t_to < t_from <= T:
        raise ValueError(f"need 0 <= t_to < t_from <= T, got "
                         f"t_from={t_from} t_to={t_to} T={T}")


def denoise_segment(sched: DiffusionSchedule, eps_fn: EpsFn,
                    x_t: torch.Tensor, t_from: int, t_to: int = 0, *,
                    generator: Optional[torch.Generator] = None,
                    noise_fn: Optional[NoiseFn] = None,
                    clip_output: bool = False,
                    clip_denoised: bool = False) -> torch.Tensor:
    """Denoise from state x_{t_from} down to x_{t_to}: the first step
    evaluated is t = t_from - 1; with t_to = 0 this finishes the chain.
    Segments that share one generator draw what one ``sample`` call
    draws."""
    _check_range(t_from, t_to, sched.T)
    x = _scan_steps(sched, eps_fn, x_t, t_from, t_to, generator=generator,
                    noise_fn=noise_fn, clip_x0=clip_denoised)
    return x.clamp(-1.0, 1.0) if clip_output else x


def renoise(sched: DiffusionSchedule, x_t: torch.Tensor, t_now: int,
            t_target: int, *, generator: Optional[torch.Generator] = None,
            noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
    """Push a partially denoised state x_{t_now} forward to the noise level
    of state t_target > t_now, by q(x_{t_target} | x_{t_now}):

        x_{t_target} = sqrt(a_bar_target / a_bar_now) * x_{t_now}
                       + sqrt(1 - a_bar_target / a_bar_now) * eps

    State i has marginal a_bar[i-1] for i >= 1 and is the clean image for
    i = 0. The ratio is float32, as JAX computes it."""
    if not 0 <= t_now < t_target <= sched.T:
        raise ValueError(f"need 0 <= t_now < t_target <= T, got "
                         f"t_now={t_now} t_target={t_target} T={sched.T}")
    ab = sched.alphas_bar_host.astype(np.float32)
    ab_now = np.float32(1.0) if t_now == 0 else ab[t_now - 1]
    ratio = ab[t_target - 1] / ab_now
    eps = _draw(x_t, 0, t_target, generator, noise_fn)
    return (_f32(np.sqrt(ratio)) * x_t
            + _f32(np.sqrt(np.float32(1.0) - ratio)) * eps)


def _segment_state_grid(t_from: int, t_to: int, num_steps: int,
                        targets) -> np.ndarray:
    """Strictly decreasing state grid s_0=t_from > ... > s_n=t_to from a
    host-side target sequence (uniform-t or uniform-lambda values snapped
    to ints)."""
    states = np.asarray(np.round(targets), dtype=np.int64)
    states[0], states[-1] = t_from, t_to
    # Repair only the interior: endpoints are pinned, and num_steps <=
    # t_from - t_to guarantees the interior fits strictly between them.
    for i in range(1, len(states) - 1):       # forward: strictly decreasing
        states[i] = min(states[i], states[i - 1] - 1)
    for i in range(len(states) - 2, 0, -1):   # backward: repair underflow
        states[i] = max(states[i], states[i + 1] + 1)
    assert states[0] == t_from and states[-1] == t_to
    assert (np.diff(states) < 0).all(), states
    return states


def ddim_segment(sched: DiffusionSchedule, eps_fn: EpsFn, x_t: torch.Tensor,
                 t_from: int, t_to: int = 0, *, num_steps: int,
                 eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 noise_fn: Optional[NoiseFn] = None,
                 clip_output: bool = False,
                 clip_denoised: bool = False) -> torch.Tensor:
    """DDIM over a strided sub-range of the reverse chain: state x_{t_from}
    -> x_{t_to} in ``num_steps`` model evaluations on a uniform float64
    grid. ``eta > 0`` adds noise (a draw a step). ``clip_denoised`` clamps
    each step's x0-hat to [-1, 1] and re-derives eps from it."""
    _check_range(t_from, t_to, sched.T)
    num_steps = max(1, min(num_steps, t_from - t_to))
    states = _segment_state_grid(t_from, t_to, num_steps,
                                 np.linspace(t_from, t_to, num_steps + 1))
    ab = sched.alphas_bar_host

    def abar(s):
        return 1.0 if s == 0 else ab[s - 1]

    ab_cur = np.array([abar(s) for s in states[:-1]])
    ab_nxt = np.array([abar(s) for s in states[1:]])
    sigma = (eta * np.sqrt((1.0 - ab_nxt) / (1.0 - ab_cur))
             * np.sqrt(np.clip(1.0 - ab_cur / ab_nxt, 0.0, None)))
    dir_coeff = np.sqrt(np.clip(1.0 - ab_nxt - sigma ** 2, 0.0, None))
    x = x_t
    for i, (s, sa_c, ss_c, sa_n, dc, sg) in enumerate(zip(
            states[:-1], np.sqrt(ab_cur), np.sqrt(1.0 - ab_cur),
            np.sqrt(ab_nxt), dir_coeff, sigma)):
        t = int(s) - 1
        sa_c, ss_c, sa_n, dc, sg = map(_f32, (sa_c, ss_c, sa_n, dc, sg))
        eps = _eps(eps_fn, x, t)
        x0 = (x - ss_c * eps) / sa_c
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
            eps = (x - sa_c * x0) / max(ss_c, _f32(1e-12))
        x = sa_n * x0 + dc * eps
        if sg:
            x = x + sg * _draw(x, i, t, generator, noise_fn)
    return x.clamp(-1.0, 1.0) if clip_output else x


def dpm_segment(sched: DiffusionSchedule, eps_fn: EpsFn, x_t: torch.Tensor,
                t_from: int, t_to: int = 0, *, num_steps: int,
                clip_output: bool = False,
                clip_denoised: bool = False) -> torch.Tensor:
    """DPM-Solver++(2M) over a sub-range: state x_{t_from} -> x_{t_to} in
    ``num_steps`` evaluations on a uniform-log-SNR grid restricted to the
    segment. Deterministic: it draws nothing."""
    _check_range(t_from, t_to, sched.T)
    num_steps = max(1, min(num_steps, t_from - t_to))
    ab = sched.alphas_bar_host
    lam_all = 0.5 * (np.log(ab) - np.log1p(-ab))

    # uniform-lambda targets over the segment's regular states (state 0 is
    # lambda=+inf; when t_to==0 the final transition is the exact x0 step)
    lo_state = max(t_to, 1)
    n_reg = num_steps if t_to >= 1 else num_steps - 1
    if n_reg >= 1:
        lam_grid = np.linspace(lam_all[t_from - 1], lam_all[lo_state - 1],
                               n_reg + 1)
        tgt = [int(np.abs(lam_all - lam).argmin()) + 1 for lam in lam_grid]
        reg = _segment_state_grid(t_from, lo_state, n_reg, tgt)
    else:
        reg = np.asarray([t_from], np.int64)
    states = np.concatenate([reg, [0]]) if t_to == 0 else reg
    ns = len(states) - 1                      # == num_steps

    sig_c = np.sqrt(1.0 - ab[states[:-1] - 1])
    alph_c = np.sqrt(ab[states[:-1] - 1])
    lam_c = np.log(alph_c / sig_c)                 # per evaluated state
    # lambda of each target state (inf at the clean target)
    lam_n = np.array([np.inf if k == 0 else lam_all[k - 1]
                      for k in states[1:]])
    sr = np.zeros(ns)
    an = np.ones(ns)
    ph = np.full(ns, -1.0)
    c1 = np.zeros(ns)
    for j in range(ns):
        k = states[j + 1]
        if k > 0:
            sr[j] = np.sqrt(1.0 - ab[k - 1]) / sig_c[j]
            an[j] = np.sqrt(ab[k - 1])
            ph[j] = np.expm1(-(lam_n[j] - lam_c[j]))
        # else: the clean target keeps (sr=0, an=1, ph=-1): x lands on d
        if 0 < j < ns - 1 and np.isfinite(lam_n[j]):
            h_cur = lam_n[j] - lam_c[j]
            h_prev = lam_c[j] - lam_c[j - 1]
            if h_prev > 0:
                c1[j] = 0.5 * h_cur / h_prev       # 2M multistep weight

    x, x0_prev = x_t, None
    for s, sg, al, r, a, p, c in zip(states[:-1], sig_c, alph_c, sr, an, ph,
                                     c1):
        sg, al, r, c = map(_f32, (sg, al, r, c))
        ap = _f32(np.float32(a) * np.float32(p))
        eps = _eps(eps_fn, x, int(s) - 1)
        x0 = (x - sg * eps) / al
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        d = x0 + c * (x0 - x0_prev) if c else x0
        x = r * x - ap * d
        x0_prev = x0
    return x.clamp(-1.0, 1.0) if clip_output else x


def segment_cost(T: int, sampler: str = "ddpm", num_steps: int = 50):
    """Model evaluations of one segment (hi -> lo) for a sampler family:
    ancestral pays one a step; the fast samplers get a proportional share
    of the full-chain ``num_steps`` budget (diffusion.ddim_steps)."""
    if sampler == "ddpm":
        return lambda hi, lo: hi - lo
    return lambda hi, lo: max(1, min(round(num_steps * (hi - lo) / T),
                                     hi - lo))


def make_segment_denoiser(sched: DiffusionSchedule, eps_fn: EpsFn,
                          sampler: str = "ddpm", num_steps: int = 50,
                          clip_denoised: bool = False, eta: float = 0.0):
    """(denoise_seg, cost) for the forking searches and restart sampling.

    ``denoise_seg(x, t_from, t_to, *, clip_output=False, generator=None,
    noise_fn=None)`` runs the chosen sampler ("ddpm", "ddim" or "dpm") over
    the segment; ``cost(t_from, t_to)`` returns its model evaluations.
    ``num_steps`` is the full-chain budget, of which a segment gets a
    proportional share. ``eta`` applies to DDIM segments."""
    cost = segment_cost(sched.T, sampler, num_steps)
    if sampler == "ddpm":
        def fn(x, hi, lo, *, clip_output=False, generator=None,
               noise_fn=None):
            return denoise_segment(sched, eps_fn, x, hi, lo,
                                   generator=generator, noise_fn=noise_fn,
                                   clip_output=clip_output,
                                   clip_denoised=clip_denoised)
    elif sampler == "ddim":
        def fn(x, hi, lo, *, clip_output=False, generator=None,
               noise_fn=None):
            return ddim_segment(sched, eps_fn, x, hi, lo,
                                num_steps=cost(hi, lo), eta=eta,
                                generator=generator, noise_fn=noise_fn,
                                clip_output=clip_output,
                                clip_denoised=clip_denoised)
    elif sampler == "dpm":
        def fn(x, hi, lo, *, clip_output=False, generator=None,
               noise_fn=None):
            return dpm_segment(sched, eps_fn, x, hi, lo,
                               num_steps=cost(hi, lo),
                               clip_output=clip_output,
                               clip_denoised=clip_denoised)
    else:
        raise ValueError(f"no segment form for sampler {sampler!r}; "
                         "expected ddpm | ddim | dpm")
    return fn, cost


def _validate_restarts(T: int, restarts) -> tuple:
    """Normalise and validate a restart spec: ((t_max, t_min, k), ...) with
    T >= t_max > t_min >= 0 and k >= 1, sorted descending and
    non-overlapping (intervals may touch)."""
    spec = tuple((int(a), int(b), int(c)) for a, b, c in restarts)
    prev_lo = T
    for t_max, t_min, k in spec:
        if not (0 <= t_min < t_max <= T):
            raise ValueError(
                f"restart interval ({t_max}, {t_min}) out of range for "
                f"T={T}: need T >= t_max > t_min >= 0")
        if t_max > prev_lo:
            raise ValueError(
                "restart intervals must be sorted descending and "
                f"non-overlapping; ({t_max}, {t_min}) overlaps the "
                f"previous interval (ends at {prev_lo})")
        if k < 1:
            raise ValueError(f"restart count k={k} must be >= 1")
        prev_lo = t_min
    return spec


def restart_sample(sched: DiffusionSchedule, eps_fn: EpsFn,
                   x_T: torch.Tensor, *, restarts, sampler: str = "ddpm",
                   num_steps: int = 50, clip_output: bool = True,
                   clip_denoised: bool = False, eta: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   noise_fn=None) -> torch.Tensor:
    """Restart sampling (Xu et al. 2023): within each interval
    ``(t_max, t_min, k)`` of ``restarts`` the chain is re-noised from t_min
    back to t_max (``renoise``) and denoised again, k extra times, over
    segments of ``sampler`` (``make_segment_denoiser``; model evaluations
    counted by ``restart_nfes``). ``noise_fn(call, i, t)``: see the module
    docstring."""
    spec = _validate_restarts(sched.T, restarts)
    seg, _ = make_segment_denoiser(sched, eps_fn, sampler,
                                   num_steps=num_steps,
                                   clip_denoised=clip_denoised, eta=eta)
    calls = itertools.count(1)

    def draws():
        call = next(calls)
        return (None if noise_fn is None
                else functools.partial(noise_fn, call))

    x, cur = x_T, sched.T
    for t_max, t_min, k in spec:
        if cur > t_max:
            x = seg(x, cur, t_max, generator=generator, noise_fn=draws())
        x = seg(x, t_max, t_min, generator=generator, noise_fn=draws())
        for _ in range(k):
            x = renoise(sched, x, t_min, t_max, generator=generator,
                        noise_fn=draws())
            x = seg(x, t_max, t_min, generator=generator, noise_fn=draws())
        cur = t_min
    if cur > 0:
        x = seg(x, cur, 0, generator=generator, noise_fn=draws())
    return x.clamp(-1.0, 1.0) if clip_output else x


def restart_nfes(T: int, restarts, seg_cost=None) -> int:
    """Model evaluations of ``restart_sample``: the base chain plus k extra
    traversals of each interval. Pass the ``cost`` half of
    ``make_segment_denoiser`` for DDIM and DPM segments (the default counts
    one evaluation a step, as ancestral segments take)."""
    if seg_cost is None:
        seg_cost = lambda hi, lo: hi - lo  # noqa: E731
    spec = _validate_restarts(T, restarts)
    total, cur = 0, T
    for t_max, t_min, k in spec:
        if cur > t_max:
            total += seg_cost(cur, t_max)
        total += (k + 1) * seg_cost(t_max, t_min)
        cur = t_min
    if cur > 0:
        total += seg_cost(cur, 0)
    return int(total)


def ddim_timesteps(T: int, num_steps: int) -> np.ndarray:
    """``ddim_sample``'s timesteps, T-1 down to 0: the float32 arithmetic of
    JAX's ``jnp.linspace(T - 1, 0, num_steps).round()`` as XLA compiles it,
    ``(T-1) * (1 - i * f32(1 / (num_steps-1)))``, rounded half to even."""
    div = num_steps - 1
    if div < 1:
        return np.zeros(num_steps, np.int64)
    step = np.arange(div, dtype=np.float32) * (np.float32(1) / np.float32(div))
    grid = np.float32(T - 1) * (np.float32(1) - step)
    return np.append(np.rint(grid), 0).astype(np.int64)


def ddim_sample(sched: DiffusionSchedule, eps_fn: EpsFn, x_T: torch.Tensor,
                *, num_steps: int = 50, eta: float = 0.0,
                clip_output: bool = True,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
    """DDIM sampling (Song et al. 2021) over ``num_steps`` strided
    timesteps (``ddim_timesteps``) of the training schedule: deterministic
    at ``eta=0``; ``eta=1`` gives DDPM-like noise on the sub-schedule. The
    coefficients are float32, as JAX computes them on the device."""
    T = sched.T
    if not 1 <= num_steps <= T:
        raise ValueError(f"need 1 <= num_steps <= T={T}, got {num_steps}")
    ts = ddim_timesteps(T, num_steps)
    ab = sched.alphas_bar_host.astype(np.float32)
    one = np.float32(1.0)
    x = x_T
    for i, t in enumerate(ts):
        t = int(t)
        last = i == num_steps - 1
        ab_cur = ab[t]
        ab_next = one if last else ab[ts[i + 1]]
        sigma = (np.float32(eta) * np.sqrt((one - ab_next) / (one - ab_cur))
                 * np.sqrt(one - ab_cur / ab_next))
        sigma = np.float32(0.0) if last else sigma
        dir_coeff = np.sqrt(max(one - ab_next - sigma * sigma,
                                np.float32(0.0)))
        eps = _eps(eps_fn, x, t)
        x0 = (x - _f32(np.sqrt(one - ab_cur)) * eps) / _f32(np.sqrt(ab_cur))
        x = _f32(np.sqrt(ab_next)) * x0 + _f32(dir_coeff) * eps
        if sigma:
            x = x + _f32(sigma) * _draw(x, i, t, generator, noise_fn)
    return x.clamp(-1.0, 1.0) if clip_output else x


def dpm_solver_sample(sched: DiffusionSchedule, eps_fn: EpsFn,
                      x_T: torch.Tensor, *, num_steps: int = 20,
                      clip_output: bool = True,
                      clip_denoised: bool = False) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022) over the whole chain: second-order
    multistep probability-flow sampling, one model evaluation a step, the
    last step first order onto the x0 prediction. Deterministic. Delegates
    to ``dpm_segment`` (t_from=T, t_to=0), as JAX does."""
    T = sched.T
    if not 2 <= num_steps <= T:
        raise ValueError(f"need 2 <= num_steps <= T={T}, got {num_steps}")
    return dpm_segment(sched, eps_fn, x_T, T, 0, num_steps=num_steps,
                       clip_output=clip_output, clip_denoised=clip_denoised)


def parallel_picard_sample(sched: DiffusionSchedule, eps_fn: EpsFn,
                           x_T: torch.Tensor, *, num_steps: int = 50,
                           max_iters: Optional[int] = None,
                           tol: float = 1e-3, clip_output: bool = True,
                           shard=None) -> Tuple[torch.Tensor, int]:
    """Parallel-in-time sampling by Picard iteration (ParaDiGMS, Shih et
    al. 2023) over the deterministic DDIM recurrence
    ``x_{j+1} = c_j x_j + d_j eps(x_j, t_j)`` on a float64 numpy grid.

    Each sweep evaluates the model at all ``num_steps`` grid points in one
    call (the grid folded into the batch: n*B rows, timestep-major), then a
    cumulative sum refreshes the whole trajectory. After k sweeps the first
    k points are exact, so ``max_iters = num_steps`` reproduces sequential
    DDIM where the two grids agree. The loop stops after the first sweep
    whose delta, the largest over the grid points of the mean |change|,
    is <= ``tol``: delta is read back to the host once a sweep. The timesteps
    of a sweep differ, so an eps_fn that decides a guidance interval from
    its step cannot run here. With ``shard`` (a process group;
    ``parallel.mesh``) each sweep's n*B rows are split over its ranks, each
    rank evaluates its ``local_rows`` and the eps are gathered back, so
    every rank refreshes the whole trajectory; the world size must divide
    n*B. Returns ``(x_0, sweeps)``."""
    T = sched.T
    n = num_steps
    if not 2 <= n <= T:
        raise ValueError(f"need 2 <= num_steps <= T={T}, got {n}")
    if max_iters is None:
        max_iters = n
    ab = sched.alphas_bar_host
    ts = np.linspace(T - 1, 0, n).round().astype(np.int64)
    a = np.concatenate([np.sqrt(ab[ts]), [1.0]])        # states 0..n
    s = np.concatenate([np.sqrt(1.0 - ab[ts]), [0.0]])
    c = a[1:] / a[:-1]
    d = s[1:] - a[1:] * s[:-1] / a[:-1]

    B = x_T.shape[0]
    dev = x_T.device
    t_fold = _to_device(np.repeat(ts, B), dev)
    if shard is not None:
        t_fold = local_rows(t_fold, shard)
    bshape = (n,) + (1,) * x_T.dim()
    cm1 = _to_device((c - 1.0).astype(np.float32), dev).reshape(bshape)
    dd = _to_device(d.astype(np.float32), dev).reshape(bshape)
    X = x_T.unsqueeze(0).expand((n,) + x_T.shape)
    final, sweeps = x_T, 0
    while sweeps < max_iters:
        flat = X.reshape((n * B,) + x_T.shape[1:])
        if shard is None:
            eps = eps_fn(flat, t_fold)
        else:
            eps = on_local_rows(lambda rows: eps_fn(rows, t_fold), flat,
                                shard)
        g = cm1 * X + dd * eps.reshape(X.shape)
        cums = torch.cumsum(g, dim=0)
        X_new = torch.cat([X[:1], x_T.unsqueeze(0) + cums[:-1]])
        final = x_T + cums[-1]
        delta = (X_new - X).abs().mean(dim=tuple(range(1, X.dim()))).max()
        X = X_new
        sweeps += 1
        if not delta.item() > tol:
            break
    out = final.clamp(-1.0, 1.0) if clip_output else final
    return out, sweeps


def sample_with_snapshots(
    sched: DiffusionSchedule, eps_fn: EpsFn, x_T: torch.Tensor,
    interval: int, *, clip_output: bool = True, clip_denoised: bool = False,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ancestral sampling that also returns the state every ``interval``
    steps: ``(x_0, snapshot_ts, snapshots)``, where ``snapshots[i]`` is the
    state after denoising down to timestep ``snapshot_ts[i]``. The
    segments run from T, each ``interval`` steps, the last one (nearest
    t=0) taking the remainder: T=10, interval=4 snapshots at t = 6, 2, 0.
    The chain draws what one ``sample`` call draws."""
    T = sched.T
    if not 1 <= interval <= T:
        raise ValueError(f"need 1 <= interval <= T={T}, got {interval}")
    bounds = list(range(T, -1, -interval))
    if bounds[-1] != 0:
        bounds.append(0)
    x, snaps = x_T, []
    for hi, lo in zip(bounds[:-1], bounds[1:]):
        fn = (None if noise_fn is None
              else lambda i, t, o=T - hi: noise_fn(o + i, t))
        x = _scan_steps(sched, eps_fn, x, hi, lo, generator=generator,
                        noise_fn=fn, clip_x0=clip_denoised)
        snaps.append(x)
    x0 = x.clamp(-1.0, 1.0) if clip_output else x
    snap_ts = _to_device(np.asarray(bounds[1:], np.int64), x_T.device)
    return x0, snap_ts, torch.stack(snaps)
