"""End-to-end pipelines of the port: ``train`` and ``evaluate``.

Counterpart of ``itsd_tpu/cli/runner.py`` (``build_model``,
``build_schedule``, ``load_dataset`` and ``init_params`` at 49-135,
``load_eval_params`` 137-160, ``_cli_segment`` 163-177, ``run_sampler``
179-226, ``_validated_launch_segments`` 228-240,
``make_eps_fn`` and ``load_weak_params`` 277-319, ``make_train_key`` and
``resolve_track_metrics`` 322-350, ``train`` 389-600,
``_sample_grid_during_training`` 639-662, ``evaluate`` 668-712,
``build_cli_verifier`` 927-1007 and ``run_search`` 1010-1338), with the
conditional model, classifier-free guidance, autoguidance, every sampler
and noise search. Spatial meshes, metric-tracked training, profiling,
representation extraction, the CLIP and ensemble verifiers, the cross-T
surgery of a table time embedding and the T-extension fine-tune are not
yet ported and raise.

Entry points run on ``device="cuda"`` unless the caller passes another.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..core import (ddim_sample, dpm_solver_sample, linear_schedule,
                    make_segment_denoiser, parallel_picard_sample,
                    restart_sample, sample)
from ..core.process import make_autoguidance_eps_fn, make_cfg_eps_fn
from ..data import (BatchIterator, load_cifar10, load_image_folder,
                    prefetch_to_device, shapes_dataset, synthetic_dataset,
                    threaded_prefetch)
from ..models import UNet, cond_unet_config, uncond_unet_config
from ..train import (OptimizerConfig, create_train_state, make_optimizer,
                     make_train_step)
from ..train.checkpoint import (AsyncCheckpointManager, is_full_checkpoint,
                                restore_params, save_checkpoint)
from ..utils import Config, MetricsLogger, save_image_grid


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported")


def build_model(cfg: Config):
    """(model, conditional) for ``cfg.model``: the unconditional UNet, or
    the conditional one when ``model.num_labels`` is set (its table time
    embedding has ``diffusion.T`` rows, unless ``model.time_embed`` is
    "functional"). Sampling a table embedding at another ``inference_T``
    needs the cross-T surgery, which is not yet ported: that raises here,
    from the config alone."""
    m, d = cfg.model, cfg.diffusion
    if m.backbone != "unet":
        raise _not_ported(f"model.backbone={m.backbone!r}")
    if m.remat:
        raise _not_ported("model.remat")
    if m.time_embed == "table" and d.inference_T and d.inference_T != d.T:
        raise _not_ported(
            f"diffusion.inference_T={d.inference_T} with the table time "
            f"embedding of T={d.T} rows (the cross-T surgery)")
    kw = dict(ch=m.channel, ch_mult=tuple(m.channel_mult),
              num_res_blocks=m.num_res_blocks, dropout=m.dropout, T=d.T,
              dtype=m.dtype, attention_impl=m.attention_impl)
    conditional = m.num_labels is not None
    if conditional:
        ucfg = cond_unet_config(num_labels=m.num_labels, **kw)
        if m.time_embed == "functional":
            ucfg = dataclasses.replace(ucfg, time_embed="functional")
    else:
        ucfg = uncond_unet_config(attn=tuple(m.attn),
                                  time_embed=m.time_embed, **kw)
    return UNet(ucfg), conditional


def build_schedule(cfg: Config, inference: bool = False, device="cuda"):
    d = cfg.diffusion
    T = d.inference_T if (inference and d.inference_T) else d.T
    return linear_schedule(d.beta_1, d.beta_T, T, device=device)


def init_params(cfg: Config, model: UNet) -> dict:
    """Seeded Xavier-uniform weights for ``model`` (drawn on the CPU from
    ``cfg.seed``, so every device gets the same weights); returns its state
    dict."""
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    return model.state_dict()


def load_dataset(cfg: Config):
    """(images [N, S, S, 3] in [-1, 1], labels [N]) for ``cfg.data``."""
    d = cfg.data
    ratio = None if d.use_full_dataset else d.train_subset_ratio
    if d.dataset == "cifar10":
        return load_cifar10(d.root, train=True, subset_ratio=ratio,
                            seed=d.seed)
    if d.dataset == "imagefolder":
        return load_image_folder(d.root, img_size=d.img_size,
                                 subset_ratio=ratio, seed=d.seed)
    if d.dataset == "synthetic":
        n_labels = cfg.model.num_labels or 10
        return synthetic_dataset(n=max(cfg.train.batch_size * 4, 256),
                                 img_size=d.img_size, num_labels=n_labels,
                                 seed=d.seed)
    if d.dataset == "shapes":
        n_labels = cfg.model.num_labels or 10
        n = max(cfg.train.batch_size * 8, 2048)
        if ratio is not None:
            n = max(1, int(n * ratio))
        return shapes_dataset(n=n, img_size=d.img_size,
                              num_labels=n_labels, seed=d.seed)
    raise ValueError(f"unknown dataset: {d.dataset!r}")


def load_eval_params(cfg: Config, name: Optional[str] = None) -> dict:
    """The weights at ``save_weight_dir/<name or test_load_weight>``: the
    EMA (else the raw weights) of a full training checkpoint, or a
    weights-only state dict. Orbax checkpoints of the JAX package cannot
    be read here."""
    name = name or cfg.test_load_weight
    if not name:
        raise ValueError("eval needs test_load_weight (a checkpoint or a "
                         "torch.save'd state dict under save_weight_dir)")
    obj = restore_params(os.path.join(cfg.save_weight_dir, name))
    if is_full_checkpoint(obj):
        return obj["ema_params"] or obj["params"]
    return obj


def load_weights(cfg: Config, model: UNet, params: dict) -> None:
    """``model.load_state_dict(params)``, after checking that a table time
    embedding in ``params`` has the rows the T wanted needs. A checkpoint
    of another T needs the cross-T surgery (JAX's ``load_eval_params``
    extends the table), which is not yet ported: that raises."""
    table = params.get("time_embedding.table")
    want_T = cfg.diffusion.inference_T or cfg.diffusion.T
    if table is not None and table.shape[0] != want_T:
        raise _not_ported(
            f"a checkpoint whose time table has {table.shape[0]} rows, "
            f"sampled at T={want_T} (the cross-T surgery)")
    model.load_state_dict(params)


def make_eps_fn(model: UNet, conditional: bool = False, labels=None,
                w: float = 0.0, cfg_interval=None, weak_model=None):
    """eps_fn for the sampler: the model's forward when unconditional;
    for the conditional model the dual-batched classifier-free-guidance
    mix (``core.process.make_cfg_eps_fn``) on ``labels``, or with
    ``weak_model`` (diffusion.guidance=auto) autoguidance against it
    (``make_autoguidance_eps_fn``). ``cfg_interval=(lo, hi)`` restricts
    guidance to lo <= t < hi."""
    if not conditional:
        return lambda x, t: model(x, t)
    if labels is None:
        raise ValueError("the conditional model samples with labels")
    strong = lambda x, t, lab: model(x, t, lab)  # noqa: E731
    if weak_model is not None:
        return make_autoguidance_eps_fn(
            strong, lambda x, t, lab: weak_model(x, t, lab), labels, w,
            interval=cfg_interval)
    return make_cfg_eps_fn(strong, labels, w, interval=cfg_interval)


def load_weak_params(cfg: Config, conditional: bool):
    """The weak model's weights for diffusion.guidance=auto, or None for
    "cfg"; any other value raises. Loaded as the eval weights are."""
    d = cfg.diffusion
    if d.guidance not in ("cfg", "auto"):
        raise ValueError(f"unknown diffusion.guidance {d.guidance!r}; "
                         "expected cfg | auto")
    if d.guidance != "auto":
        return None
    if not d.weak_load_weight:
        raise ValueError(
            "diffusion.guidance=auto needs diffusion.weak_load_weight "
            "(an under-trained checkpoint of the same architecture)")
    if not conditional:
        raise ValueError(
            "diffusion.guidance=auto requires a conditional model "
            "(autoguidance mixes two label-conditioned forwards)")
    return load_eval_params(cfg, d.weak_load_weight)


def sampling_eps_fn(cfg: Config, model: UNet, conditional: bool,
                    batch: int, weak_params=None, labels=None):
    """The eps_fn that ``evaluate``, the training grids and the Trainer
    sample ``batch`` images with: plain, or (conditional) guided by
    ``diffusion.w`` over ``diffusion.cfg_interval`` on ``labels``, by
    default ``(arange(batch) % num_labels) + 1``, against the weak model
    built from ``weak_params`` when given (autoguidance). ``model`` is in
    eval mode on its device."""
    if not conditional:
        return make_eps_fn(model)
    device = next(model.parameters()).device
    if labels is None:
        labels = torch.arange(batch, device=device) % cfg.model.num_labels + 1
    weak = None
    if weak_params is not None:
        weak, _ = build_model(cfg)
        load_weights(cfg, weak, weak_params)
        weak.to(device).eval().requires_grad_(False)
    d = cfg.diffusion
    interval = tuple(d.cfg_interval) if d.cfg_interval else None
    return make_eps_fn(model, True, labels.to(device), d.w,
                       cfg_interval=interval, weak_model=weak)


def _cli_segment(cfg: Config, sched, eps_fn):
    """(denoise_seg, cost) for the forking searches from
    ``diffusion.sampler``: DDIM or DPM segments when configured, else None
    (the searches then build their ancestral default; picard has no
    segment form)."""
    d = cfg.diffusion
    if d.sampler not in ("ddim", "dpm"):
        return None
    return make_segment_denoiser(sched, eps_fn, d.sampler,
                                 num_steps=min(d.ddim_steps, sched.T),
                                 clip_denoised=d.clip_denoised,
                                 eta=d.ddim_eta)


def run_sampler(cfg: Config, sched, eps_fn, x_T: torch.Tensor,
                generator: torch.Generator, noise_fn=None) -> torch.Tensor:
    """The sampler ``cfg.diffusion.sampler`` names: ancestral DDPM, DDIM,
    DPM-Solver++ or Picard, ``diffusion.ddim_steps`` the step budget of
    the last three. A non-empty ``diffusion.restart_intervals`` wraps the
    ddpm, ddim or dpm family in restart sampling. Picard cannot run with a
    guidance interval: a sweep evaluates every timestep of its grid in one
    call, so guidance cannot be switched per timestep (JAX decides it for
    the whole sweep from the first grid point). ``noise_fn`` supplies the
    draws of a stochastic sampler instead of ``generator``
    (``core.sampling``: ``(i, t)``, restart ``(call, i, t)``)."""
    d = cfg.diffusion
    steps = min(d.ddim_steps, sched.T)
    if d.restart_intervals:
        if d.sampler not in ("ddpm", "ddim", "dpm"):
            raise ValueError(
                "diffusion.restart_intervals requires sampler "
                f"ddpm | ddim | dpm, got {d.sampler!r} (picard has no "
                "segment form)")
        return restart_sample(sched, eps_fn, x_T,
                              restarts=d.restart_intervals,
                              sampler=d.sampler, num_steps=steps,
                              clip_denoised=d.clip_denoised,
                              eta=d.ddim_eta, generator=generator,
                              noise_fn=noise_fn)
    if d.sampler == "ddim":
        return ddim_sample(sched, eps_fn, x_T, num_steps=steps,
                           eta=d.ddim_eta, generator=generator,
                           noise_fn=noise_fn)
    if d.sampler == "dpm":
        return dpm_solver_sample(sched, eps_fn, x_T, num_steps=steps)
    if d.sampler == "picard":
        if d.cfg_interval:
            raise ValueError(
                "diffusion.sampler=picard cannot run with "
                f"diffusion.cfg_interval={list(d.cfg_interval)}: a Picard "
                "sweep evaluates all its timesteps in one call, so guidance "
                "cannot be switched per timestep")
        imgs, _ = parallel_picard_sample(sched, eps_fn, x_T,
                                         num_steps=steps)
        return imgs
    if d.sampler != "ddpm":
        raise ValueError(f"unknown diffusion.sampler {d.sampler!r}; "
                         "expected ddpm | ddim | dpm | picard")
    return sample(sched, eps_fn, x_T, generator=generator,
                  noise_fn=noise_fn, clip_denoised=d.clip_denoised)


def _validated_launch_segments(cfg: Config) -> int:
    """``diffusion.launch_segments``, validated: it splits the ancestral
    chain, so more than one segment requires sampler=ddpm without
    restart_intervals. JAX splits the chain into launches to bound the
    device time of one; here every step is its own launches, so an
    accepted count changes nothing: the chain is one ``sample`` call."""
    d = cfg.diffusion
    seg_n = max(1, int(d.launch_segments or 1))
    if seg_n > 1 and (d.sampler != "ddpm" or d.restart_intervals):
        raise ValueError(
            "diffusion.launch_segments splits the ancestral T-step chain "
            "into segments; it requires diffusion.sampler=ddpm without "
            "restart_intervals")
    return seg_n


def evaluate(cfg: Config, params=None, device="cuda") -> dict:
    """Sample ``eval_batch_size`` images with the sampler ``run_sampler``
    picks; write the initial-noise grid and the sample grid under
    ``cfg.sampled_dir``. Returns ``{"images": [B,H,W,3] numpy in [-1, 1],
    "path": grid path}``."""
    _validated_launch_segments(cfg)
    if cfg.train.spatial_shard > 1:
        raise _not_ported("train.spatial_shard > 1 (spatial meshes)")
    model, conditional = build_model(cfg)
    weak = load_weak_params(cfg, conditional) if conditional else None
    if params is None:
        params = load_eval_params(cfg)
    load_weights(cfg, model, params)
    model.to(device).eval()

    sched = build_schedule(cfg, inference=True, device=device)
    eval_bs = cfg.train.eval_batch_size or min(cfg.train.batch_size, 64)
    size = cfg.data.img_size
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    x_T = torch.randn((eval_bs, size, size, 3), generator=gen, device=device)
    os.makedirs(cfg.sampled_dir, exist_ok=True)
    save_image_grid((x_T * 0.5).clamp(-1, 1).cpu().numpy(),
                    os.path.join(cfg.sampled_dir, cfg.sampled_noisy_img_name),
                    nrow=cfg.nrow)
    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak)
    with torch.inference_mode():
        imgs = run_sampler(cfg, sched, eps_fn, x_T, gen)
    images = imgs.cpu().numpy()
    out_path = os.path.join(cfg.sampled_dir, cfg.sampled_img_name)
    save_image_grid(images, out_path, nrow=cfg.nrow)
    return {"images": images, "path": out_path}


# ---------------------------------------------------------------------------
# Search


def build_cli_verifier(cfg: Config, conditional: bool, eval_bs: int,
                       device="cuda"):
    """The verifier ``search.verifier`` names: the heuristics (oracle,
    self_supervised, aesthetic) or classifier (a SmallCNN checkpoint,
    ``search.classifier_ckpt``, scoring ``search.target_label`` or, for the
    conditional model, the classes of the sampler's labels). clip and
    ensemble need the CLIP and Inception networks, which are not yet
    ported."""
    from ..search import (aesthetic_score, batch_pixel_variance_score,
                          classifier_verifier, self_supervised_verifier)

    s = cfg.search
    simple = {
        "oracle": batch_pixel_variance_score,
        "self_supervised": self_supervised_verifier(),
        "aesthetic": aesthetic_score,
    }.get(s.verifier)
    if simple is not None:
        return simple

    if s.verifier == "classifier":
        if not s.classifier_ckpt:
            raise ValueError(
                "search.verifier=classifier needs search.classifier_ckpt "
                "(save one with models.classifier.save_classifier)")
        from ..models import load_classifier
        path = s.classifier_ckpt
        if not os.path.isabs(path):
            path = os.path.join(cfg.save_weight_dir, path)
        logit_fn, _, ccfg = load_classifier(path, device=device)
        if s.target_label is not None:
            targets = torch.full((eval_bs,), int(s.target_label),
                                 dtype=torch.int64)
        elif conditional:
            # the sampler conditions on labels (arange % num_labels) + 1;
            # the classifier scores the corresponding true classes
            targets = torch.arange(eval_bs) % cfg.model.num_labels
        else:
            raise ValueError(
                "unconditional classifier search needs search.target_label")
        if int(targets.max()) >= ccfg.num_classes:
            raise ValueError(f"target labels exceed classifier classes "
                             f"({ccfg.num_classes})")
        return classifier_verifier(logit_fn, targets.to(device))

    if s.verifier in ("clip", "ensemble"):
        net = "CLIP" if s.verifier == "clip" else "Inception"
        raise _not_ported(f"search.verifier={s.verifier} (the {net} "
                          "network)")

    raise ValueError(
        f"unknown search.verifier {s.verifier!r}; expected oracle | "
        "self_supervised | aesthetic | classifier | clip | ensemble")


def _guard(cfg: Config, res, sched, eps_fn, denoise_fn, shape,
           device) -> dict:
    """The verifier-hacking guard: the winner's pooled-pixel Fréchet proxy
    (``make_fid_proxy``, independent of every verifier) against the mean
    of ``search.guard_baseline_draws`` unsearched samples of the chain the
    winner came from; flagged when the winner's is ``guard_ratio`` times
    worse. The baseline draws come from a generator of their own, seeded
    ``seed + 0x6a7d``."""
    from ..search.verifiers import make_fid_proxy

    s, d = cfg.search, cfg.diffusion
    images, _ = load_dataset(cfg)
    proxy = make_fid_proxy(images[: s.guard_num_real])
    # path, pruned and SMC winners are ancestral unless their segments ride
    # ddim | dpm; gradient follows the sampler only when it is dpm; random
    # and zero-order denoise with the configured sampler
    ancestral = ((s.algorithm in ("path", "pruned", "smc")
                  and d.sampler not in ("ddim", "dpm"))
                 or (s.algorithm == "gradient" and d.sampler != "dpm"))
    if ancestral:
        base_fn = lambda n, g: sample(  # noqa: E731
            sched, eps_fn, n, generator=g, clip_denoised=d.clip_denoised)
    else:
        base_fn = lambda n, g: denoise_fn(n, g, None)  # noqa: E731
    draws = max(1, int(s.guard_baseline_draws))
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 0x6a7d)
    base_vals = []
    with torch.inference_mode():
        for _ in range(draws):
            x = torch.randn(shape, generator=gen, device=device)
            base_vals.append(float(proxy(base_fn(x, gen))))
    base_mean = float(np.mean(base_vals))
    base_std = float(np.std(base_vals))
    guard = {"winner_fid_proxy": float(proxy(res.best_images)),
             "baseline_fid_proxy": base_mean,
             "baseline_fid_proxy_std": base_std,
             "baseline_fid_proxy_draws": base_vals,
             "ratio_threshold": s.guard_ratio}
    guard["flagged"] = bool(
        guard["winner_fid_proxy"] > s.guard_ratio * max(base_mean, 1e-9))
    if guard["flagged"]:
        print(f"[search] WARNING: verifier-hacking guard tripped — "
              f"winner FID-proxy {guard['winner_fid_proxy']:.3f} vs "
              f"unsearched baseline {base_mean:.3f} +- {base_std:.3f} "
              f"(n={draws} draws, >{s.guard_ratio}x): the verifier "
              f"score improved at the expense of independent sample "
              f"quality. Reduce the search budget or strengthen the "
              f"verifier.", file=sys.stderr)
    return guard


def run_search(cfg: Config, params=None, verifier_fn=None, device="cuda",
               noise_fn=None) -> dict:
    """Search over initial noise with ``search.algorithm`` (random |
    zero_order | path | pruned | smc | gradient), scored by
    ``verifier_fn`` or the verifier ``build_cli_verifier`` builds, at
    ``train.eval_batch_size`` (default 8) images a candidate; the
    conditional model samples labels ``(arange % num_labels) + 1``, guided
    as ``evaluate`` guides it. Random and zero-order search denoise with
    ``run_sampler``; path, pruned and SMC run their segments on DDIM or DPM
    when ``diffusion.sampler`` names one, else ancestral; gradient search
    differentiates through DPM-Solver++ when sampler=dpm, else through the
    recomputed ancestral chain. Every algorithm but gradient runs under
    ``torch.inference_mode``; gradient runs with the weights frozen.

    Draws come from one generator seeded ``cfg.seed``. ``noise_fn`` (the
    seam of ``search.algorithms``) replaces them: the initial noise of
    zero-order and gradient search is the site ``("initial",)``, and random
    search's chunk c sees each site with c appended (``("candidates",
    c)``).

    Writes ``sampled_dir/search_<algorithm>_best.png``; returns
    ``{"best_score", "nfes", "guard", "result"}``. With
    ``search.guard_proxy`` the winner is checked for verifier hacking
    (``_guard``)."""
    from ..search import algorithms as A

    if cfg.train.spatial_shard > 1:
        raise _not_ported("train.spatial_shard > 1 (spatial meshes)")
    model, conditional = build_model(cfg)
    weak = load_weak_params(cfg, conditional) if conditional else None
    if params is None:
        params = load_eval_params(cfg)
    load_weights(cfg, model, params)
    model.to(device).eval().requires_grad_(False)
    sched = build_schedule(cfg, inference=True, device=device)
    s, d = cfg.search, cfg.diffusion
    eval_bs = cfg.train.eval_batch_size or 8
    shape = (eval_bs, cfg.data.img_size, cfg.data.img_size, 3)

    chunk = s.n_candidates
    if s.algorithm == "random" and s.candidate_chunk:
        chunk = min(s.candidate_chunk, s.n_candidates)
        if s.n_candidates % chunk:
            raise ValueError(
                f"search.candidate_chunk={chunk} must divide "
                f"n_candidates={s.n_candidates}")

    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak)

    def denoise_fn(noise, generator, nf):
        return run_sampler(cfg, sched, eps_fn, noise, generator, nf)

    if verifier_fn is None:
        verifier_fn = build_cli_verifier(cfg, conditional, eval_bs, device)

    if _validated_launch_segments(cfg) > 1 and s.algorithm != "random":
        raise ValueError(
            "diffusion.launch_segments applies to eval and random "
            "search only (the other search algorithms interleave "
            "scoring with the chain)")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    def initial():
        if noise_fn is not None:
            return noise_fn(("initial",), 0, 0)
        return torch.randn(shape, generator=gen, device=device)

    with torch.inference_mode(s.algorithm != "gradient"):
        if s.algorithm == "random":
            # the host keeps the running argmax: one read a chunk
            best, all_scores = None, []
            for ci in range(s.n_candidates // chunk):
                nf = (None if noise_fn is None else
                      lambda site, i, t, c=ci: noise_fn(site + (c,), i, t))
                r = A.random_search(shape, denoise_fn, verifier_fn,
                                    n_candidates=chunk, generator=gen,
                                    noise_fn=nf)
                read = torch.cat([r.best_score.reshape(1),
                                  r.history["scores"]]).float().cpu()
                bsc = float(read[0])
                all_scores.append(read[1:].numpy())
                # NaN-aware: a NaN chunk must not beat a later finite one
                if best is None or np.isnan(best[1]) or bsc > best[1]:
                    best = (r.best_noise, bsc, r.best_images)
            res = A.SearchResult(best[0], best[1], best[2],
                                 {"scores": np.concatenate(all_scores)},
                                 s.n_candidates)
        elif s.algorithm == "zero_order":
            res = A.zero_order_search(
                initial(), denoise_fn, verifier_fn,
                n_neighbors=s.n_neighbors, lambda_radius=s.lambda_radius,
                n_iterations=s.n_iterations, neighbor_mode=s.neighbor_mode,
                return_images=True, generator=gen, noise_fn=noise_fn)
        elif s.algorithm == "path":
            steps = tuple(s.injection_steps)
            r = A.path_search(
                sched, eps_fn, verifier_fn, shape, n_paths=s.n_paths,
                n_active=s.n_active, injection_steps=steps,
                delta_f=s.delta_f, clip_denoised=d.clip_denoised,
                segment=_cli_segment(cfg, sched, eps_fn), generator=gen,
                noise_fn=noise_fn)
            res = A.SearchResult(
                r.best_noise, r.best_score, r.best_images,
                {"scores": r.history["scores"],
                 "final_scores": r.history["final_scores"],
                 "injection_points": list(steps)}, r.nfes)
        elif s.algorithm == "pruned":
            psched = tuple(tuple(int(v) for v in p)
                           for p in s.prune_schedule)
            r = A.pruned_search(
                sched, eps_fn, verifier_fn, shape,
                n_candidates=s.n_candidates, prune_schedule=psched,
                clip_denoised=d.clip_denoised,
                segment=_cli_segment(cfg, sched, eps_fn), generator=gen,
                noise_fn=noise_fn)
            psc, fsc = r.history["prune_scores"], r.history["final_scores"]
            # "scores": the whole initial pool's x0-hat scores (round 0)
            res = A.SearchResult(
                r.best_noise, r.best_score, r.best_images,
                {"scores": psc[0] if psc else fsc, "final_scores": fsc,
                 "prune_scores": [a.cpu().numpy() for a in psc],
                 "prune_schedule": list(psched)}, r.nfes)
        elif s.algorithm == "smc":
            rsteps = tuple(int(t) for t in s.smc_resample_steps)
            r = A.smc_search(
                sched, eps_fn, verifier_fn, shape,
                n_particles=s.n_candidates, resample_steps=rsteps,
                lambda_temp=s.smc_lambda,
                ess_threshold=s.smc_ess_threshold,
                lambda_scale=s.smc_lambda_scale,
                clip_denoised=d.clip_denoised,
                segment=_cli_segment(cfg, sched, eps_fn), generator=gen,
                noise_fn=noise_fn)
            ess = r.history["ess"].cpu().numpy()
            resampled = r.history["resampled"].cpu().numpy()
            # "scores": the initial pool's first-checkpoint x0-hat scores
            res = A.SearchResult(
                r.best_noise, r.best_score, r.best_images,
                {"scores": r.history["scores"],
                 "final_scores": r.history["final_scores"],
                 "resample_scores": [a.cpu().numpy()
                                     for a in r.history["resample_scores"]],
                 "ess": ess, "resampled": resampled,
                 "resample_steps": list(rsteps)}, r.nfes)
            print(f"[search] smc ess per resample point: "
                  f"{np.round(ess, 2).tolist()} "
                  f"(resampled: {resampled.tolist()})")
        elif s.algorithm == "gradient":
            solver_steps = (min(d.ddim_steps, sched.T)
                            if d.sampler == "dpm" else None)
            res = A.gradient_search(
                initial(), sched, eps_fn, verifier_fn,
                n_iterations=s.n_iterations, lr=s.gradient_lr,
                return_images=True, solver_steps=solver_steps,
                clip_denoised=d.clip_denoised, generator=gen,
                noise_fn=noise_fn)
        else:
            raise ValueError(f"unknown search algorithm: {s.algorithm!r}")

    guard = None
    if s.guard_proxy and res.best_images is not None:
        guard = _guard(cfg, res, sched, eps_fn, denoise_fn, shape, device)

    os.makedirs(cfg.sampled_dir, exist_ok=True)
    if res.best_images is not None:
        save_image_grid(res.best_images.float().cpu().numpy(),
                        os.path.join(cfg.sampled_dir,
                                     f"search_{s.algorithm}_best.png"),
                        nrow=cfg.nrow)
    return {"best_score": float(res.best_score), "nfes": res.nfes,
            "guard": guard, "result": res}


# ---------------------------------------------------------------------------
# Training


def make_train_key(cfg: Config, device="cuda") -> torch.Generator:
    """The training run's generator, seeded from ``cfg.seed``: it draws t,
    the noise, the label-dropout uniforms (conditional model) and the
    dropout masks of every step, in that order. It is
    torch's own (Philox on a GPU); ``train.prng_impl`` names JAX's
    generators and is not read."""
    return torch.Generator(device=device).manual_seed(cfg.seed)


def resolve_track_metrics(cfg: Config) -> bool:
    """train.track_metrics=None means auto: tracked eval on, except on the
    test-only synthetic blobs or under a restart spec."""
    t = cfg.train.track_metrics
    if cfg.diffusion.restart_intervals and (t is None or t):
        import warnings
        warnings.warn(
            "train.track_metrics disabled: diffusion.restart_intervals "
            "is set and the metric-tracked sampler only follows the "
            "plain ancestral chain (see sample_with_metrics).",
            stacklevel=2)
        return False
    if t is None:
        return cfg.data.dataset != "synthetic"
    return bool(t)


def _check_train_options(cfg: Config) -> None:
    t = cfg.train
    if resolve_track_metrics(cfg):
        raise _not_ported(
            "metric-tracked eval during training (train.track_metrics, on "
            "by default for every dataset but synthetic; set "
            "train.track_metrics=false)")
    if t.spatial_shard > 1:
        raise _not_ported("train.spatial_shard > 1 (spatial meshes)")
    if t.profile_steps > 0:
        raise _not_ported("train.profile_steps > 0 (profiling)")
    if t.extract_representation_freq:
        raise _not_ported("train.extract_representation_freq "
                          "(representation extraction)")


def train(cfg: Config, max_steps: Optional[int] = None,
          device="cuda") -> dict:
    """The training loop: ``cfg.train.epoch`` epochs (or ``max_steps``
    steps) over ``cfg.data``, writing ``train_metrics.jsonl`` (one record a
    step with its loss and pre-clip gradient norm, one an epoch) under
    ``metrics_save_dir``, full checkpoints ``ckpt_{epoch}`` under
    ``save_weight_dir`` every ``model_save_freq`` epochs and at the end,
    and a sample grid ``epoch_{epoch}_sampled.png`` under ``sampled_dir``
    every ``eval_freq`` epochs. Returns the final loss, the step count, the
    checkpoint paths, the per-step losses and the ``TrainState``."""
    _check_train_options(cfg)
    model, conditional = build_model(cfg)
    weak = load_weak_params(cfg, conditional) if conditional else None
    sched = build_schedule(cfg, device=device)
    images, labels = load_dataset(cfg)
    it = BatchIterator(images, labels if conditional else None,
                       cfg.train.batch_size, seed=cfg.data.seed)
    if len(it) == 0:
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} exceeds the dataset "
            f"({len(images)} images): no full batch can be formed")

    init_params(cfg, model)
    if cfg.train.training_load_weight:
        model.load_state_dict(restore_params(os.path.join(
            cfg.save_weight_dir, cfg.train.training_load_weight)))
    model.to(device)
    tx = make_optimizer(OptimizerConfig(
        lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
        grad_clip=cfg.train.grad_clip, multiplier=cfg.train.multiplier,
        epochs=cfg.train.epoch, steps_per_epoch=len(it),
        ema_decay=cfg.train.ema_decay), model.parameters())
    state = create_train_state(model, tx,
                               ema=cfg.train.ema_decay is not None)
    step_fn = make_train_step(
        sched, conditional=conditional,
        loss_reduction=cfg.train.loss_reduction,
        loss_weighting=cfg.train.loss_weighting,
        snr_gamma=cfg.train.snr_gamma, label_dropout=cfg.train.label_dropout,
        ema_decay=cfg.train.ema_decay)

    logger = MetricsLogger(
        os.path.join(cfg.metrics_save_dir, "train_metrics.jsonl"))
    generator = make_train_key(cfg, device)
    prefetch = (threaded_prefetch if cfg.train.threaded_input
                else prefetch_to_device)
    ckpt_mgr = AsyncCheckpointManager() if cfg.train.async_checkpoint else None
    losses, ckpts, step, t0 = [], [], 0, time.time()
    for epoch in range(cfg.train.epoch):
        metrics = []  # device scalars: synced once an epoch, not a step
        for batch in prefetch(it, size=2, device=device):
            metrics.append(step_fn(state, batch, generator))
            step += 1
            if max_steps is not None and step >= max_steps:
                break
        if metrics:
            loss_v, norm_v = torch.stack(
                [torch.stack([m["loss"], m["grad_norm"]]) for m in metrics]
            ).float().cpu().T.tolist()
            first = step - len(metrics) + 1
            for i, (lv, nv) in enumerate(zip(loss_v, norm_v)):
                logger.log({"step": first + i, "loss": lv, "grad_norm": nv},
                           echo=False)
            losses.extend(loss_v)
        logger.log({"epoch": epoch, "step": step,
                    "loss": losses[-1] if losses else float("nan"),
                    "elapsed_s": time.time() - t0})
        if (epoch + 1) % cfg.train.model_save_freq == 0 or \
                epoch == cfg.train.epoch - 1:
            path = os.path.join(cfg.save_weight_dir, f"ckpt_{epoch}")
            if ckpt_mgr is not None:
                ckpt_mgr.save(path, state)
            else:
                save_checkpoint(path, state)
            ckpts.append(path)
        if (epoch + 1) % cfg.train.eval_freq == 0:
            _sample_grid_during_training(cfg, state, epoch, device,
                                         conditional, weak)
        if max_steps is not None and step >= max_steps:
            break
    if ckpt_mgr is not None:
        ckpt_mgr.close()
    logger.close()
    return {"final_loss": losses[-1] if losses else None, "steps": step,
            "checkpoints": ckpts, "losses": losses, "state": state}


def _sample_grid_during_training(cfg: Config, state, epoch: int,
                                 device="cuda", conditional: bool = False,
                                 weak_params=None) -> str:
    """A grid of ``eval_batch_size`` samples from the EMA weights (guided
    as ``evaluate`` guides, for the conditional model), written to
    ``sampled_dir/epoch_{epoch}_sampled.png``."""
    sched = build_schedule(cfg, inference=True, device=device)
    eval_bs = cfg.train.eval_batch_size or min(cfg.train.batch_size, 64)
    model = copy.deepcopy(state.model)
    model.load_state_dict(state.ema_state_dict())
    model.eval()
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed * 1_000_003 + epoch + 1)
    size = cfg.data.img_size
    x_T = torch.randn((eval_bs, size, size, 3), generator=gen, device=device)
    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak_params)
    with torch.inference_mode():
        imgs = run_sampler(cfg, sched, eps_fn, x_T, gen)
    path = os.path.join(cfg.sampled_dir, f"epoch_{epoch}_sampled.png")
    os.makedirs(cfg.sampled_dir, exist_ok=True)
    save_image_grid(imgs.cpu().numpy(), path, nrow=cfg.nrow)
    return path


def finetune_extended_T(cfg: Config, max_steps: Optional[int] = None,
                        device="cuda") -> dict:
    raise _not_ported("finetune-t (the T-extension fine-tune and its "
                      "time-embedding surgery)")
