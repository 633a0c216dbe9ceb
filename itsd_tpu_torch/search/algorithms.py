"""Inference-time scaling: search over initial noise.

Counterpart of ``itsd_tpu/search/algorithms.py``. Candidates are folded
into the batch axis and denoise as one batch; selection (argmax, top-k,
resampling) runs on the device, so no algorithm reads a value back to the
host inside its loops. The iteration loops run on the host, as every
sampler of the port does.

  random_search      best-of-N over i.i.d. initial noises
  zero_order_search  pivot-based local search in noise space (additive or
                     norm-preserving "shell" neighbours)
  path_search        fork, renoise and filter over the denoising trajectory
  pruned_search      successive halving over noise (top-k narrows)
  smc_search         Feynman-Kac steering: a weighted particle population
                     with ESS-gated systematic resampling
  gradient_search    Adam on the noise through the sampler: the ancestral
                     chain with each step recomputed in the backward
                     (``sample(remat=True)``), or DPM-Solver++

NFE accounting is returned as metadata (``SearchResult.nfes``, and the
``*_nfes`` functions for the forking searches).

Draws. JAX splits a threefry key for every random quantity, which torch
cannot reproduce. Each algorithm takes ``generator=``, a
``torch.Generator`` that it draws from in the order the draws run, and
``noise_fn=``, which, when given, supplies every draw instead:
``noise_fn(site, i, t)`` with ``site`` naming where the draw is made:

* ``("candidates",)``: the candidate (path, particle) noises, one draw
  ``[N, *noise_shape]`` (i=0, t=0; so are the next two);
* ``("neighbors", it)``: zero-order's eps of iteration ``it``,
  ``[n_neighbors, *pivot.shape]``;
* ``("denoise", it)``: the sampler's draws inside ``denoise_fn`` (random:
  it=0; zero-order and gradient: iteration ``it``, and ``n_iterations``
  for the returned images), numbered ``(i, t)`` as the sampler numbers
  them (``core.sampling``);
* ``("segment", k)``: the draws of the k-th segment call of a forking
  search, counted from 0 in the order they run;
* ``("renoise", k)``: path search's renoise at its k-th injection step;
* ``("uniform", k)``: SMC's one uniform draw (a 0-d tensor in [0, 1)) at
  its k-th resample point, drawn whether or not it resamples.

The parity tests feed JAX's draws through it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.process import EpsFn, predict_x0_from_eps
from ..core.sampling import (_eps, dpm_solver_sample, make_segment_denoiser,
                             renoise, sample)
from ..core.schedules import DiffusionSchedule

# denoise_fn(noise [B,...], generator, noise_fn(i, t) or None) -> images
DenoiseFn = Callable[..., torch.Tensor]
# verifier_fn(images [B,...]) -> scalar score (higher is better)
VerifierFn = Callable[[torch.Tensor], torch.Tensor]
# noise_fn(site, i, t) -> a draw; see the module docstring
SearchNoiseFn = Callable[[tuple, int, int], torch.Tensor]


def _nan_to_neg_inf(scores: torch.Tensor) -> torch.Tensor:
    """NaN-safe selection: argmax and top-k treat NaN as the maximum, so
    one NaN-scoring candidate would beat every finite one. Mask NaN to
    -inf before any selection."""
    return torch.where(torch.isnan(scores),
                       torch.full_like(scores, -math.inf), scores)


@dataclasses.dataclass
class SearchResult:
    best_noise: torch.Tensor
    best_score: torch.Tensor
    best_images: Optional[torch.Tensor]
    history: dict
    nfes: int  # number of full denoising runs (x T model evals; x2 for CFG)


def _site(noise_fn: Optional[SearchNoiseFn], *site):
    """The sampler-style ``noise_fn(i, t)`` of one draw site, or None."""
    return None if noise_fn is None else functools.partial(noise_fn, site)


def _normal(shape, site, t, generator, noise_fn) -> torch.Tensor:
    if noise_fn is not None:
        return noise_fn(site, 0, t)
    if generator is None:
        raise ValueError("a search draws from generator= (or noise_fn=)")
    return torch.randn(shape, generator=generator, device=generator.device)


def _pick(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d device index, without reading it on the host."""
    return a.index_select(0, i.reshape(1))[0]


def _argmax(scores: torch.Tensor) -> torch.Tensor:
    """The first index of the largest score, NaN counted as -inf."""
    return torch.argmax(_nan_to_neg_inf(scores))


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` best scores in descending order, ties to the
    lower index (``lax.top_k``'s order), NaN counted as -inf: a stable
    descending sort."""
    return torch.sort(_nan_to_neg_inf(scores), descending=True,
                      stable=True).indices[:k]


def _score_candidates(verifier_fn: VerifierFn,
                      images: torch.Tensor) -> torch.Tensor:
    """[N] scores of [N, B, ...] candidate images, one verifier call each
    (JAX vmaps the verifier over the candidate axis)."""
    return torch.stack([verifier_fn(images[n]) for n in range(len(images))])


def _x0_hat(sched: DiffusionSchedule, eps_fn: EpsFn, x: torch.Tensor,
            t: int) -> torch.Tensor:
    """The clamped x0 prediction of state x at timestep t (one model
    evaluation)."""
    tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    return predict_x0_from_eps(sched, x, tb, _eps(eps_fn, x, t)).clamp(
        -1.0, 1.0)


def _denoise_candidates(denoise_fn: DenoiseFn, noises: torch.Tensor,
                        generator, noise_fn=None) -> torch.Tensor:
    """[N, B, ...] candidate noises -> [N, B, ...] images through ONE
    batched sampler call (candidates folded into the batch axis)."""
    n, b = noises.shape[:2]
    flat = noises.reshape((n * b,) + tuple(noises.shape[2:]))
    images = denoise_fn(flat, generator, noise_fn)
    return images.reshape((n, b) + tuple(images.shape[1:]))


def random_search(noise_shape: Tuple[int, ...], denoise_fn: DenoiseFn,
                  verifier_fn: VerifierFn, n_candidates: int = 4,
                  return_images: bool = True, *,
                  generator: Optional[torch.Generator] = None,
                  noise_fn: Optional[SearchNoiseFn] = None) -> SearchResult:
    """Best-of-N over i.i.d. initial noises; ``noise_shape`` is one
    candidate's batch (B, H, W, C)."""
    noises = _normal((n_candidates,) + tuple(noise_shape), ("candidates",),
                     0, generator, noise_fn)
    images = _denoise_candidates(denoise_fn, noises, generator,
                                 _site(noise_fn, "denoise", 0))
    scores = _score_candidates(verifier_fn, images)
    best = _argmax(scores)
    return SearchResult(
        best_noise=_pick(noises, best),
        best_score=_pick(scores, best),
        best_images=_pick(images, best) if return_images else None,
        history={"scores": scores},
        nfes=n_candidates,
    )


def _sample_neighbors(pivot: torch.Tensor, n_neighbors: int,
                      lambda_radius: float, mode: str, *,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_neighbors`` candidates around ``pivot`` from eps ~ N(0, I)
    (drawn from ``generator`` unless given): "additive" pivot + (1 -
    lambda) eps, which drifts off the Gaussian shell over many iterations;
    "shell" lambda pivot + sqrt(1 - lambda^2) eps, which keeps N(0, I)."""
    if eps is None:
        eps = torch.randn((n_neighbors,) + tuple(pivot.shape),
                          generator=generator, device=pivot.device)
    if mode == "additive":
        return pivot[None] + eps * (1.0 - lambda_radius)
    if mode == "shell":
        return (lambda_radius * pivot[None]
                + float(np.sqrt(np.float32(1.0 - lambda_radius ** 2)))
                * eps)
    raise ValueError(f"unknown neighbor mode: {mode!r}")


def zero_order_search(
    initial_noise: torch.Tensor,
    denoise_fn: DenoiseFn,
    verifier_fn: VerifierFn,
    n_neighbors: int = 4,
    lambda_radius: float = 0.95,
    n_iterations: int = 10,
    neighbor_mode: str = "additive",
    return_images: bool = False, *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[SearchNoiseFn] = None,
) -> SearchResult:
    """Pivot-based local search in noise space. Per iteration all
    neighbours denoise as one batch; the pivot moves to the best neighbour
    only when its (unmasked) score beats the best so far, a device-side
    select."""
    pivot = best_noise = initial_noise
    best_score = torch.full((), -math.inf, device=initial_noise.device)
    hist = []
    for it in range(n_iterations):
        eps = (None if noise_fn is None
               else noise_fn(("neighbors", it), 0, 0))
        neighbors = _sample_neighbors(pivot, n_neighbors, lambda_radius,
                                      neighbor_mode, generator=generator,
                                      eps=eps)
        images = _denoise_candidates(denoise_fn, neighbors, generator,
                                     _site(noise_fn, "denoise", it))
        scores = _score_candidates(verifier_fn, images)
        i = _argmax(scores)
        it_best_score = _pick(scores, i)
        it_best = _pick(neighbors, i)
        improved = it_best_score > best_score
        best_score = torch.where(improved, it_best_score, best_score)
        best_noise = torch.where(improved, it_best, best_noise)
        pivot = torch.where(improved, it_best, pivot)
        hist.append(scores)

    result_images = None
    if return_images:
        result_images = denoise_fn(best_noise, generator,
                                   _site(noise_fn, "denoise", n_iterations))
    return SearchResult(
        best_noise=best_noise,
        best_score=best_score,
        best_images=result_images,
        history={"scores": torch.stack(hist),   # [n_iterations, n_neighbors]
                 "candidates_per_iter": n_neighbors},
        nfes=n_iterations * n_neighbors + (1 if return_images else 0),
    )


def path_search_nfes(T: int, n_paths: int, injection_steps: Sequence[int],
                     delta_f: int, seg_cost=None) -> int:
    """NFE of ``path_search`` (full-denoise equivalents). ``seg_cost(t_from,
    t_to)`` is the model evaluations of one segment: pass the cost half of
    ``make_segment_denoiser`` for DDIM and DPM segments; the default, the
    ancestral ``t_from - t_to``, overstates them."""
    if seg_cost is None:
        seg_cost = lambda hi, lo: hi - lo  # noqa: E731
    steps = sorted(set(int(s) for s in injection_steps), reverse=True)
    t_prev, nfes = T, 0.0
    for t_inj in steps:
        nfes += n_paths * seg_cost(t_prev, t_inj) / T  # denoise to injection
        nfes += n_paths / T                      # x0-hat scoring eval
        t_prev = min(t_inj + delta_f, T)
    nfes += n_paths * seg_cost(t_prev, 0) / T    # final descent
    return int(round(nfes))


def _segment(sched, eps_fn, segment, clip_denoised):
    if segment is None:
        segment = make_segment_denoiser(sched, eps_fn, "ddpm",
                                        clip_denoised=clip_denoised)
    return segment


def path_search(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    verifier_fn: VerifierFn,
    noise_shape: Tuple[int, ...],
    n_paths: int = 4,
    n_active: int = 2,
    injection_steps: Sequence[int] = (400,),
    delta_f: int = 50,
    return_images: bool = True,
    clip_denoised: bool = False,
    segment=None, *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[SearchNoiseFn] = None,
) -> SearchResult:
    """Search over paths: ``n_paths`` noises denoise together to the first
    injection step; there each path's x0-hat is scored (one extra model
    evaluation), the ``n_active`` best survive, and each is expanded into
    ``n_paths // n_active`` copies renoised forward by ``delta_f`` steps,
    which then denoise to the next injection step; after the last, all
    finish to 0 and the best final sample wins. ``segment`` = (denoise_seg,
    cost) from ``make_segment_denoiser`` runs the segments on DDIM or DPM;
    the default is ancestral, with the per-step x0-hat clamp when
    ``clip_denoised``."""
    if n_paths % n_active or n_paths < n_active:
        raise ValueError(f"n_paths={n_paths} must be a multiple of "
                         f"n_active={n_active}")
    seg_fn, seg_cost = _segment(sched, eps_fn, segment, clip_denoised)
    expand = n_paths // n_active
    steps = sorted(set(int(s) for s in injection_steps), reverse=True)
    if not all(0 < s < sched.T for s in steps):
        raise ValueError(f"injection steps {steps} must lie in (0, "
                         f"T={sched.T})")

    noise_shape = tuple(noise_shape)
    x = _normal((n_paths,) + noise_shape, ("candidates",), 0, generator,
                noise_fn)
    x = x.reshape((-1,) + noise_shape[1:])
    per_path = lambda a: a.reshape((n_paths,) + noise_shape)  # noqa: E731

    score_log = []
    t_prev = sched.T
    nfes = 0.0
    for k, t_inj in enumerate(steps):
        x = seg_fn(x, t_prev, t_inj, generator=generator,
                   noise_fn=_site(noise_fn, "segment", k))
        nfes += n_paths * seg_cost(t_prev, t_inj) / sched.T
        x0_hat = _x0_hat(sched, eps_fn, x, t_inj - 1)
        scores = _score_candidates(verifier_fn, per_path(x0_hat))
        score_log.append(scores)
        nfes += n_paths / sched.T
        top_idx = _top_k(scores, n_active)
        survivors = per_path(x).index_select(0, top_idx)
        tiled = survivors.repeat_interleave(expand, dim=0)
        t_prev = min(t_inj + delta_f, sched.T)
        x = renoise(sched, tiled.reshape((-1,) + noise_shape[1:]), t_inj,
                    t_prev, generator=generator,
                    noise_fn=_site(noise_fn, "renoise", k))

    x = seg_fn(x, t_prev, 0, clip_output=True, generator=generator,
               noise_fn=_site(noise_fn, "segment", len(steps)))
    nfes += n_paths * seg_cost(t_prev, 0) / sched.T
    finals = per_path(x)
    final_scores = _score_candidates(verifier_fn, finals)
    best = _argmax(final_scores)
    winner = _pick(finals, best)
    return SearchResult(
        best_noise=winner,  # the final sample of the winning path
        best_score=_pick(final_scores, best),
        best_images=winner if return_images else None,
        history={"scores": torch.stack(score_log) if score_log else None,
                 "final_scores": final_scores,
                 "injection_points": steps},
        nfes=int(round(nfes)),
    )


def pruned_search_nfes(T: int, n_candidates: int,
                       prune_schedule: Sequence[Sequence[int]],
                       seg_cost=None) -> int:
    """NFE of ``pruned_search`` (full-denoise units); ``seg_cost`` as in
    ``path_search_nfes``."""
    if seg_cost is None:
        seg_cost = lambda hi, lo: hi - lo  # noqa: E731
    t_prev, n_now, nfes = T, n_candidates, 0.0
    for t_p, keep in sorted((tuple(map(int, p)) for p in prune_schedule),
                            reverse=True):
        nfes += n_now * seg_cost(t_prev, t_p) / T  # denoise to prune point
        nfes += n_now / T                    # x0-hat scoring eval
        t_prev, n_now = t_p, keep
    nfes += n_now * seg_cost(t_prev, 0) / T  # survivors' final descent
    return int(round(nfes))


def pruned_search(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    verifier_fn: VerifierFn,
    noise_shape: Tuple[int, ...],
    n_candidates: int = 16,
    prune_schedule: Sequence[Sequence[int]] = ((500, 4),),
    return_images: bool = True,
    clip_denoised: bool = False,
    segment=None, *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[SearchNoiseFn] = None,
) -> SearchResult:
    """Successive halving over noise: ``n_candidates`` noises denoise
    together; at each ``(t, keep)`` of ``prune_schedule`` every candidate's
    x0-hat is scored (one extra model evaluation) and the ``keep`` best
    survive; the survivors finish to t=0. Pruning only narrows, so a
    winner is a true sample of the chain. ``segment`` as in
    ``path_search``."""
    sched_pairs = sorted((tuple(map(int, p)) for p in prune_schedule),
                         reverse=True)
    seen_t = [t for t, _ in sched_pairs]
    if len(set(seen_t)) != len(seen_t):
        raise ValueError(
            f"prune_schedule has duplicate timesteps: {sched_pairs} — "
            "merge them into one (t, keep) entry")
    n_now = int(n_candidates)
    for t_p, keep in sched_pairs:
        if not 0 < t_p < sched.T:
            raise ValueError(f"prune step {t_p} must lie in (0, "
                             f"T={sched.T})")
        if not 0 < keep <= n_now:
            raise ValueError(
                f"prune_schedule keep={keep} must be in (0, {n_now}]")
        n_now = keep

    noise_shape = tuple(noise_shape)
    seg_fn, seg_cost = _segment(sched, eps_fn, segment, clip_denoised)
    eval_units = 0.0
    n_now = int(n_candidates)
    x = _normal((n_now,) + noise_shape, ("candidates",), 0, generator,
                noise_fn)
    x = x.reshape((-1,) + noise_shape[1:])
    per_cand = lambda a, n: a.reshape((n,) + noise_shape)  # noqa: E731

    score_log = []
    t_prev = sched.T
    for k, (t_p, keep) in enumerate(sched_pairs):
        x = seg_fn(x, t_prev, t_p, generator=generator,
                   noise_fn=_site(noise_fn, "segment", k))
        eval_units += n_now * (seg_cost(t_prev, t_p) + 1) / sched.T
        x0_hat = _x0_hat(sched, eps_fn, x, t_p - 1)
        scores = _score_candidates(verifier_fn, per_cand(x0_hat, n_now))
        score_log.append(scores)
        top_idx = _top_k(scores, keep)
        x = per_cand(x, n_now).index_select(0, top_idx)
        n_now = keep
        x = x.reshape((-1,) + noise_shape[1:])
        t_prev = t_p

    x = seg_fn(x, t_prev, 0, clip_output=True, generator=generator,
               noise_fn=_site(noise_fn, "segment", len(sched_pairs)))
    eval_units += n_now * seg_cost(t_prev, 0) / sched.T
    finals = per_cand(x, n_now)
    final_scores = _score_candidates(verifier_fn, finals)
    best = _argmax(final_scores)
    winner = _pick(finals, best)
    return SearchResult(
        best_noise=winner,
        best_score=_pick(final_scores, best),
        best_images=winner if return_images else None,
        history={"prune_scores": score_log,
                 "final_scores": final_scores,
                 "prune_schedule": sched_pairs},
        nfes=int(round(eval_units)),
    )


def smc_search_nfes(T: int, n_particles: int,
                    resample_steps: Sequence[int], seg_cost=None) -> int:
    """NFE of ``smc_search`` (full-denoise units); ``seg_cost`` as in
    ``path_search_nfes``."""
    if seg_cost is None:
        seg_cost = lambda hi, lo: hi - lo  # noqa: E731
    steps = sorted(set(int(s) for s in resample_steps), reverse=True)
    t_prev, nfes = T, 0.0
    for t_r in steps:
        nfes += n_particles * (seg_cost(t_prev, t_r) + 1) / T
        t_prev = t_r
    nfes += n_particles * seg_cost(t_prev, 0) / T
    return int(round(nfes))


def _systematic_resample(u: torch.Tensor, log_w: torch.Tensor
                         ) -> torch.Tensor:
    """Systematic (low-variance) resampling from ONE uniform draw ``u`` in
    [0, 1): particle i is kept floor(N w_i) or ceil(N w_i) times. The
    indices come from ``searchsorted`` over the cumulative weights, on the
    device."""
    n = log_w.shape[0]
    w = torch.softmax(log_w, dim=0)
    positions = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(torch.cumsum(w, dim=0), positions)
    return idx.clamp(0, n - 1)


def smc_search(
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    verifier_fn: VerifierFn,
    noise_shape: Tuple[int, ...],
    n_particles: int = 16,
    resample_steps: Sequence[int] = (700, 400, 150),
    lambda_temp: float = 10.0,
    ess_threshold: float = 0.5,
    return_images: bool = True,
    clip_denoised: bool = False,
    segment=None,
    return_population: bool = False,
    lambda_scale: str = "absolute", *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[SearchNoiseFn] = None,
) -> SearchResult:
    """Sequential Monte Carlo steering over the denoising trajectory
    (Feynman-Kac steering, Singhal et al. 2025). ``n_particles`` noises
    denoise together; at each resample step the x0-hat is scored (one
    extra model evaluation) and the log-weights take the difference
    potential ``lambda_temp * (score_t - score_prev)``, which telescopes to
    ``lambda_temp * score(final)``. When the effective sample size drops
    below ``ess_threshold * N`` the population is systematically resampled
    and the weights reset: a device-side select, so the host never waits.
    ``lambda_scale="spread"`` divides each increment by the population's
    standard deviation of the increments (over the finite ones), making
    ``lambda_temp`` a dimensionless selection pressure."""
    if lambda_scale not in ("absolute", "spread"):
        raise ValueError(f"lambda_scale must be 'absolute' or 'spread', "
                         f"got {lambda_scale!r}")
    steps = sorted(set(int(s) for s in resample_steps), reverse=True)
    if not steps:
        raise ValueError("smc_search needs >=1 resample step — with none "
                         "it degenerates to best-of-N (use random_search)")
    if not all(0 < s < sched.T for s in steps):
        raise ValueError(f"resample steps {steps} must lie in (0, "
                         f"T={sched.T})")
    n = int(n_particles)
    noise_shape = tuple(noise_shape)
    seg_fn, seg_cost = _segment(sched, eps_fn, segment, clip_denoised)
    per_particle = lambda a: a.reshape((n,) + noise_shape)  # noqa: E731

    x = _normal((n,) + noise_shape, ("candidates",), 0, generator,
                noise_fn)
    dev = x.device
    x = x.reshape((-1,) + noise_shape[1:])
    log_w = torch.zeros((n,), device=dev)
    prev_score = torch.zeros((n,), device=dev)
    arange = torch.arange(n, device=dev)

    score_log, ess_log, resampled_log = [], [], []
    t_prev = sched.T
    nfes = 0.0
    for k, t_r in enumerate(steps):
        x = seg_fn(x, t_prev, t_r, generator=generator,
                   noise_fn=_site(noise_fn, "segment", k))
        nfes += n * seg_cost(t_prev, t_r) / sched.T
        x0_hat = _x0_hat(sched, eps_fn, x, t_r - 1)
        scores = _nan_to_neg_inf(
            _score_candidates(verifier_fn, per_particle(x0_hat)))
        nfes += n / sched.T
        score_log.append(scores)
        # difference potential; a -inf (NaN-masked) score zeroes the weight
        d = scores - prev_score
        if lambda_scale == "spread":
            fin = torch.isfinite(d)
            cnt = fin.sum().clamp(min=1)
            zero = torch.zeros_like(d)
            mu = torch.where(fin, d, zero).sum() / cnt
            sd = torch.sqrt(torch.where(fin, (d - mu) ** 2, zero).sum() / cnt)
            d = d / (sd + 1e-6)
        log_w = log_w + lambda_temp * d
        finite = torch.isfinite(log_w)
        log_w = torch.where(finite, log_w, torch.full_like(log_w, -math.inf))
        # every particle NaN'd out -> no signal: keep uniform weights
        log_w = torch.where(finite.any(), log_w, torch.zeros_like(log_w))
        w = torch.softmax(log_w, dim=0)
        ess = 1.0 / (w * w).sum()
        ess_log.append(ess)
        do_resample = ess < ess_threshold * n
        resampled_log.append(do_resample)
        u = (noise_fn(("uniform", k), 0, 0) if noise_fn is not None
             else torch.rand((), generator=generator, device=dev))
        idx = torch.where(do_resample, _systematic_resample(u, log_w),
                          arange)
        x = per_particle(x).index_select(0, idx).reshape(
            (-1,) + noise_shape[1:])
        prev_score = scores.index_select(0, idx)
        log_w = torch.where(do_resample, torch.zeros_like(log_w),
                            log_w.index_select(0, idx))
        t_prev = t_r

    x = seg_fn(x, t_prev, 0, clip_output=True, generator=generator,
               noise_fn=_site(noise_fn, "segment", len(steps)))
    nfes += n * seg_cost(t_prev, 0) / sched.T
    finals = per_particle(x)
    final_scores = _score_candidates(verifier_fn, finals)
    best = _argmax(final_scores)
    winner = _pick(finals, best)
    return SearchResult(
        best_noise=winner,  # the final sample of the winning particle
        best_score=_pick(final_scores, best),
        best_images=winner if return_images else None,
        history={"scores": score_log[0],
                 "resample_scores": score_log,
                 "final_scores": final_scores,
                 "ess": torch.stack(ess_log),
                 "resampled": torch.stack(resampled_log),
                 "resample_steps": steps,
                 # the steered population [N, B, ...]
                 **({"finals": finals} if return_population else {})},
        nfes=int(round(nfes)),
    )


def _adam_step(g, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One ``optax.adam`` update of gradient ``g``: (update, mu, nu), in
    optax's order of operations (bias corrections in float32)."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return -lr * update, mu, nu


def gradient_search(
    initial_noise: torch.Tensor,
    sched: DiffusionSchedule,
    eps_fn: EpsFn,
    verifier_fn: VerifierFn,
    n_iterations: int = 20,
    lr: float = 0.01,
    return_images: bool = False,
    solver_steps: Optional[int] = None,
    clip_denoised: bool = False, *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[SearchNoiseFn] = None,
) -> SearchResult:
    """Adam on the noise tensor against a differentiable verifier. By
    default the gradient flows through the ancestral chain with each step
    recomputed in the backward (``sample(remat=True)``: the activations of
    one step at a time, not T). With ``solver_steps`` it flows through the
    deterministic DPM-Solver++(2M) chain instead (``solver_steps``
    evaluations an iteration, activations of all of them held). Best
    tracking is a device-side select on the score at the pre-update noise;
    the model's parameters should not require grad."""
    def score_of(noise, it):
        if solver_steps is not None:
            images = dpm_solver_sample(sched, eps_fn, noise,
                                       num_steps=solver_steps)
        else:
            images = sample(sched, eps_fn, noise, generator=generator,
                            noise_fn=_site(noise_fn, "denoise", it),
                            remat=True, clip_denoised=clip_denoised)
        return verifier_fn(images)

    noise = initial_noise.detach()
    mu = torch.zeros_like(noise)
    nu = torch.zeros_like(noise)
    best_noise = noise
    best_score = torch.full((), -math.inf, device=noise.device)
    scores, grad_norms = [], []
    for it in range(n_iterations):
        with torch.enable_grad():
            x = noise.clone().requires_grad_(True)
            loss = -score_of(x, it)
            (g,) = torch.autograd.grad(loss, x)
        loss = loss.detach()
        score = _nan_to_neg_inf(-loss)
        # the score was evaluated AT `noise` (pre-update), so `noise` is
        # the incumbent for best tracking
        improved = score > best_score
        best_noise = torch.where(improved, noise, best_noise)
        best_score = torch.maximum(score, best_score)
        update, mu, nu = _adam_step(g, mu, nu, it + 1, lr)
        noise = noise + update
        scores.append(-loss)
        grad_norms.append(torch.sqrt((g * g).sum()))

    result_images = None
    if return_images:
        with torch.no_grad():
            if solver_steps is not None:
                result_images = dpm_solver_sample(sched, eps_fn, best_noise,
                                                  num_steps=solver_steps)
            else:
                result_images = sample(
                    sched, eps_fn, best_noise, generator=generator,
                    noise_fn=_site(noise_fn, "denoise", n_iterations),
                    clip_denoised=clip_denoised)
    return SearchResult(
        best_noise=best_noise,
        best_score=best_score,
        best_images=result_images,
        history={"scores": torch.stack(scores),
                 "grad_norms": torch.stack(grad_norms)},
        nfes=n_iterations + (1 if return_images else 0),
    )
