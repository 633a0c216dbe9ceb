"""End-to-end pipelines of the port: ``train``, ``evaluate``,
``inference_metrics``, ``run_search`` and ``finetune_extended_T``.

Counterpart of ``itsd_tpu/cli/runner.py`` (``build_model``,
``build_schedule``, ``load_dataset`` and ``init_params`` at 49-135,
``load_eval_params`` 137-160, ``_cli_segment`` 163-177, ``run_sampler``
179-226, ``_validated_launch_segments`` 228-240,
``make_eps_fn`` and ``load_weak_params`` 277-319, ``make_train_key`` and
``resolve_track_metrics`` 322-350, ``train`` 389-600,
``_sample_grid_during_training`` 639-662, ``evaluate`` 668-712,
``compute_real_features``, ``resolve_is_logit_fn``,
``sample_with_metrics`` and ``inference_metrics`` 715-922,
``build_cli_verifier`` 927-1007, ``run_search`` 1010-1338 and
``finetune_extended_T`` 1345-1405), with the UNet (unconditional and
conditional) and the ViT, classifier-free guidance, autoguidance, every
sampler, noise search, FID / IS / CLIP tracking, the cross-T surgery of a
table time embedding, representation extraction and profiling.

Under ``torchrun`` (``parallel.mesh``) every rank runs the entry point:
``train`` splits each global batch of ``train.batch_size`` rows over the
ranks (data parallel), ``run_search`` splits the folded candidates where
JAX's does, and the other entry points run whole on every rank. Rank 0
alone writes files.

``train.spatial_shard=K`` factors the ranks into (data = W/K, seq = K), as
JAX's ``_train_mesh`` (``parallel.make_seq_mesh``), and the image rows
shard over the seq ranks (``parallel.spatial``): ``train`` trains on the
rank's block of each batch, and ``evaluate``, ``sample_with_metrics`` and
the training grid sample on the rank's block of the images, gathered
before they are saved or scored (``_spatial_mesh``: a note, and the
unsharded run, where K does not divide the world size or the rows).
``run_search`` and ``finetune_extended_T`` print JAX's notes and run
unsharded. The UNet and the ViT both run on row shards; each raises
ValueError where the seq ranks cannot split its rows (``check_rows``: a
UNet level, or the ViT's patches), where JAX's GSPMD pads or reshards.

Unlike JAX's, the model that samples is built with the time-table rows
it samples (``build_model(cfg, inference=True)``), so that a checkpoint
extended to ``inference_T`` loads into it: JAX builds the table from
``diffusion.T`` and fails there (ROADMAP.md, Queue 3).

Unlike JAX's, the metric-tracked path swallows no error of a metric: a
metric is NaN only when its extractor or its real features are absent.

Entry points run on ``device="cuda"`` unless the caller passes another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..core import (ddim_sample, dpm_solver_sample, linear_schedule,
                    make_segment_denoiser, parallel_picard_sample,
                    restart_sample, sample, sample_with_snapshots)
from ..core.process import make_autoguidance_eps_fn, make_cfg_eps_fn
from ..data import (BatchIterator, load_cifar10, load_image_folder,
                    prefetch_to_device, shapes_dataset, synthetic_dataset,
                    threaded_prefetch)
from ..metrics.frechet import frechet_from, gaussian_stats
from ..metrics.is_score import inception_score_from_probs, softmax_probs
from ..models import (UNet, ViT, ViTConfig, cond_unet_config,
                      uncond_unet_config)
from ..parallel import (data_group, is_main, make_seq_mesh,
                        replicate, seq_mesh_scope, world_size)
from ..parallel.spatial import (all_reduce_sum, gather_image, on_image_rows,
                                row_shards, splits_batch)
from ..train import (OptimizerConfig, create_train_state, make_optimizer,
                     make_train_step)
from ..train.checkpoint import (AsyncCheckpointManager, is_full_checkpoint,
                                restore_params, save_checkpoint,
                                save_params)
from ..train.surgery import (detect_checkpoint_T, extend_time_embedding,
                             freeze_except_time_embedding)
from ..utils import Config, MetricsLogger, save_image_grid
from ..utils.plotting import plot_loss_curve, plot_metrics_curves
from ..utils.profiling import trace_steps


def build_model(cfg: Config, inference: bool = False):
    """(model, conditional) for ``cfg.model``: the ViT
    (``model.backbone=vit``, unconditional), the unconditional UNet, or
    the conditional one when ``model.num_labels`` is set. A table time
    embedding has ``diffusion.T`` rows, or with ``inference`` the rows the
    sampler walks, ``inference_T or T``; ``load_weights`` extends a
    checkpoint's table to them."""
    m, d = cfg.model, cfg.diffusion
    if m.backbone == "vit":
        return ViT(ViTConfig(
            img_size=cfg.data.img_size, patch_size=m.patch_size,
            embed_dim=m.embed_dim, depth=m.depth, num_heads=m.num_heads,
            mlp_ratio=m.mlp_ratio, dropout=m.dropout,
            attention_impl=m.attention_impl, dtype=m.dtype,
            remat=m.remat)), False
    if m.backbone != "unet":
        raise ValueError(f"unknown model.backbone {m.backbone!r}; expected "
                         "unet | vit")
    T = (d.inference_T or d.T) if inference else d.T
    kw = dict(ch=m.channel, ch_mult=tuple(m.channel_mult),
              num_res_blocks=m.num_res_blocks, dropout=m.dropout, T=T,
              dtype=m.dtype, attention_impl=m.attention_impl,
              remat=m.remat)
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


def init_params(cfg: Config, model) -> dict:
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


def load_weights(cfg: Config, model, params: dict) -> None:
    """``model.load_state_dict(params)``, after the cross-T surgery where
    the checkpoint's time table has other rows than the model's:
    ``extend_time_embedding`` with ``train.time_embedding_strategy``, as
    JAX's ``load_eval_params``. The check reads the checkpoint's table,
    not the config. A model built to sample
    (``build_model(cfg, inference=True)``) has ``inference_T or T``
    rows."""
    table = getattr(getattr(model, "time_embedding", None), "table", None)
    if table is not None:
        params = extend_time_embedding(
            params, table.shape[0],
            strategy=cfg.train.time_embedding_strategy)
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
        weak, _ = build_model(cfg, inference=True)
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
        if world_size() == 1:
            import warnings
            warnings.warn(
                "diffusion.sampler=picard on one GPU is measured SLOWER than "
                "sequential DDIM 50: 0.745x its speed unconditional and "
                "0.229x under CFG (Picard 50 against DDIM 50 at full width, "
                "NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 13). "
                "The convolutions are compute-bound, so folding the time "
                "grid into the batch buys nothing without ranks to split it "
                "over (parallel_picard_sample(shard=...)). Use sampler=ddim "
                "or dpm here.", stacklevel=2)
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


def _spatial_mesh(cfg: Config, img_h: int):
    """``train.spatial_shard`` at inference, as JAX's ``_spatial_mesh``:
    the (data, seq) layout to sample on, or None for one process's run,
    with a note where K does not divide the world size or the image
    rows."""
    K = max(1, int(cfg.train.spatial_shard))
    if K == 1:
        return None
    n = world_size()
    if n % K or img_h % K:
        if is_main():
            print(f"[runner] spatial_shard={K} ignored at inference: needs "
                  f"K | device_count ({n}) and K | H ({img_h})")
        return None
    return make_seq_mesh(K)


def _sample_images(mesh, fn, x_T, generator, noise_fn=None, h_axis=1,
                   batch_axis=0):
    """``fn(x_T, generator, noise_fn)``, a sampler over NHWC images
    returning a tensor of images (their rows on ``h_axis``, their batch on
    ``batch_axis``): on this rank's block of them under ``mesh``
    (``parallel.spatial.on_image_rows``; batch rows over the data ranks
    where they divide), gathered back on every rank; else whole."""
    if mesh is None:
        return fn(x_T, generator, noise_fn)
    batch = splits_batch(mesh, x_T.shape[0])
    return gather_image(on_image_rows(fn, x_T, generator, noise_fn, mesh,
                                      batch), mesh, h_axis, batch,
                        batch_axis)


def evaluate(cfg: Config, params=None, device="cuda") -> dict:
    """Sample ``eval_batch_size`` images with the sampler ``run_sampler``
    picks; write the initial-noise grid and the sample grid under
    ``cfg.sampled_dir``. Returns ``{"images": [B,H,W,3] numpy in [-1, 1],
    "path": grid path}``. Under ``train.spatial_shard`` (``_spatial_mesh``)
    the chain runs on this rank's block of the images."""
    _validated_launch_segments(cfg)
    model, conditional = build_model(cfg, inference=True)
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
    if is_main():
        os.makedirs(cfg.sampled_dir, exist_ok=True)
        save_image_grid((x_T * 0.5).clamp(-1, 1).cpu().numpy(),
                        os.path.join(cfg.sampled_dir,
                                     cfg.sampled_noisy_img_name),
                        nrow=cfg.nrow)
    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak)
    mesh = _spatial_mesh(cfg, size)
    with torch.inference_mode(), seq_mesh_scope(mesh):
        imgs = _sample_images(
            mesh, lambda x, g, nf: run_sampler(cfg, sched, eps_fn, x, g, nf),
            x_T, gen)
    images = imgs.cpu().numpy()
    out_path = os.path.join(cfg.sampled_dir, cfg.sampled_img_name)
    if is_main():
        save_image_grid(images, out_path, nrow=cfg.nrow)
    return {"images": images, "path": out_path}


# ---------------------------------------------------------------------------
# Metric-tracked inference


def compute_real_features(images_unit: np.ndarray, feature_fn,
                          num_samples: int = 5000, batch_size: int = 64,
                          device="cuda") -> np.ndarray:
    """Features of the first ``num_samples`` images (numpy, in [0, 1]),
    through ``feature_fn`` on ``device`` in batches, gathered on the
    host."""
    n = min(num_samples, len(images_unit))
    feats = []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            x = torch.from_numpy(np.ascontiguousarray(
                images_unit[i:min(i + batch_size, n)], np.float32))
            feats.append(feature_fn(x.to(device)).float().cpu().numpy())
    return np.concatenate(feats)


def resolve_is_logit_fn(cfg: Config, inception_logit_fn,
                        inception_provenance: str, device="cuda"):
    """The logit source of tracked IS (``train.is_logit_source``):
    "inception"; "auto", which takes pretrained Inception, else the
    port's SmallCNN checkpoint ``classifier_{dataset}{img_size}`` in
    ``save_weight_dir`` when one is there, else the Inception proxy as it
    is; or the path of a SmallCNN checkpoint. Returns (logit_fn,
    provenance)."""
    src = (cfg.train.is_logit_source or "auto").strip()
    if src == "inception":
        return inception_logit_fn, inception_provenance
    if src == "auto":
        if inception_provenance == "pretrained":
            return inception_logit_fn, inception_provenance
        cand = os.path.join(
            cfg.save_weight_dir,
            f"classifier_{cfg.data.dataset}{cfg.data.img_size}")
        if not os.path.exists(cand):
            return inception_logit_fn, inception_provenance
        src = cand
    from ..models import load_classifier_extractors
    _, logit_fn, provenance = load_classifier_extractors(src, device)
    return logit_fn, provenance


def _host(*tensors) -> list:
    """Float32 numpy copies of ``tensors``: one device-to-host read."""
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    out, at = [], 0
    host = flat.cpu().numpy()
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _snapshot_metrics(unit, feature_fn, logit_fn, clip_fn, fid_to_real,
                      real_clip, is_splits: int):
    """(FID, IS, CLIP) of one snapshot ``unit`` in [0, 1] on the device:
    the extractors run there and their outputs come back in one read. A
    metric whose extractor or real features are absent is NaN."""
    names, outs = [], []
    run_both = getattr(feature_fn, "run_both", None)
    shared = run_both is not None and run_both is getattr(
        logit_fn, "run_both", None) and fid_to_real is not None
    if shared:
        feats, logits = run_both(unit)
        names += ["feats", "probs"]
        outs += [feats, torch.softmax(logits.float(), dim=-1)]
    else:
        if feature_fn is not None and fid_to_real is not None:
            names.append("feats")
            outs.append(feature_fn(unit))
        if logit_fn is not None:
            names.append("probs")
            outs.append(softmax_probs(logit_fn, unit))
    if clip_fn is not None and real_clip is not None:
        names.append("clip")
        outs.append(clip_fn(unit))
    got = dict(zip(names, _host(*outs))) if outs else {}
    fid = is_mean = clip_s = float("nan")
    if "feats" in got:
        fid = fid_to_real(*gaussian_stats(got["feats"]))
    if "probs" in got:
        # the split protocol, clamped so that no split is empty
        splits = max(1, min(is_splits, len(unit)))
        is_mean, _ = inception_score_from_probs(got["probs"], splits)
    if "clip" in got:
        # the mean fake-real cosine of CLIP features
        f = got["clip"]
        f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-8)
        r = np.asarray(real_clip)
        r = r / (np.linalg.norm(r, axis=-1, keepdims=True) + 1e-8)
        clip_s = float((f @ r.T).mean())
    return fid, is_mean, clip_s


def sample_with_metrics(cfg: Config, params, feature_fn=None,
                        logit_fn=None, real_features=None,
                        clip_feature_fn=None, real_clip_features=None,
                        tag: str = "", device="cuda", x_T=None,
                        noise_fn=None) -> dict:
    """Sample ``eval_batch_size`` images with the ancestral chain (guided
    as ``evaluate`` guides the conditional model) and track FID, IS and
    CLIP every ``train.eval_metric_interval`` (else ``metric_interval``)
    steps. The chain keeps its snapshots on the device
    (``core.sample_with_snapshots``) and reads nothing back; the
    extractors then score each snapshot there, and the float64 statistics
    run on the host. Writes ``metrics_history{_tag}.json`` (and its
    curves) under ``metrics_save_dir`` and the final grid under
    ``sampled_dir``. ``x_T`` and ``noise_fn(i, t)`` replace the draws of
    the generator seeded ``cfg.seed``. Returns ``{"images", "history"}``,
    the history rows ``(t, fid, is, clip)``."""
    if cfg.diffusion.restart_intervals:
        raise ValueError(
            "diffusion.restart_intervals is not supported on the "
            "metric-tracked sampling path (inference-metrics / training "
            "tracked eval) — restart chains re-traverse intervals, so "
            "per-step snapshots would not be the monotone t-history the "
            "metrics report. Use `eval` or `search` with restarts, or "
            "clear restart_intervals here.")
    model, conditional = build_model(cfg, inference=True)
    weak = load_weak_params(cfg, conditional) if conditional else None
    load_weights(cfg, model, params)
    model.to(device).eval()
    sched = build_schedule(cfg, inference=True, device=device)
    eval_bs = cfg.train.eval_batch_size or min(cfg.train.batch_size, 64)
    size = cfg.data.img_size
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    if x_T is None:
        x_T = torch.randn((eval_bs, size, size, 3), generator=gen,
                          device=device)
    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak)
    interval = cfg.train.eval_metric_interval or cfg.train.metric_interval
    mesh = _spatial_mesh(cfg, size)
    snap_ts = []

    def chain(x, g, nf):
        """x_0 and the snapshots, stacked: [1 + points, B, H, W, C]."""
        x0, ts, snaps = sample_with_snapshots(
            sched, eps_fn, x, interval,
            clip_denoised=cfg.diffusion.clip_denoised, generator=g,
            noise_fn=nf)
        snap_ts.append(ts)
        return torch.cat([x0[None], snaps])

    with torch.inference_mode(), seq_mesh_scope(mesh):
        states = _sample_images(mesh, chain, x_T.to(device), gen, noise_fn,
                                h_axis=2, batch_axis=1)
        x0, snaps, ts = states[0], states[1:], snap_ts[0]
        fid_to_real = (None if real_features is None
                       else frechet_from(*gaussian_stats(real_features)))
        history = []
        for t, snap in zip(ts.tolist(), snaps):
            unit = (snap.float().clamp(-1.0, 1.0) + 1.0) / 2.0
            history.append((int(t),) + _snapshot_metrics(
                unit, feature_fn, logit_fn, clip_feature_fn, fid_to_real,
                real_clip_features, cfg.train.is_splits))

    images = x0.float().cpu().numpy()
    if is_main():
        os.makedirs(cfg.metrics_save_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        with open(os.path.join(cfg.metrics_save_dir,
                               f"metrics_history{suffix}.json"), "w") as f:
            json.dump([{"t": h[0], "fid": h[1], "is": h[2], "clip": h[3]}
                       for h in history], f, indent=2, default=float)
        plot_metrics_curves(history, os.path.join(
            cfg.metrics_save_dir, f"metrics_curves{suffix}.png"), T=sched.T)
        final_fid = history[-1][1] if history else float("nan")
        stamp = time.strftime("%Y%m%d_%H%M%S")
        name = (f"sampled{suffix}_T{sched.T}_bs{eval_bs}"
                f"_fid{final_fid:.2f}_{stamp}.png")
        save_image_grid(images, os.path.join(cfg.sampled_dir, name),
                        nrow=cfg.nrow)
    return {"images": images, "history": history}


def inference_metrics(cfg: Config, feature_fn=None, logit_fn=None,
                      clip_feature_fn=None, device="cuda") -> dict:
    """Metric-tracked sampling from the checkpoint ``test_load_weight``
    (a full checkpoint's EMA weights, or a weights-only one): the default
    extractors unless given (``metrics.default_extractors``, the IS logits
    from ``resolve_is_logit_fn``, CLIP from ``$ITSD_CLIP_WEIGHTS``), the
    real features of the configured dataset, then
    ``sample_with_metrics``. When the dataset is not on disk (its loader
    raises FileNotFoundError) FID and CLIP are NaN.
    Writes ``metrics_meta.json`` beside the history."""
    params = load_eval_params(cfg)
    provenance = is_provenance = "custom"
    if feature_fn is None:
        from ..metrics import default_extractors
        feature_fn, default_logit_fn, provenance = default_extractors(
            device=device)
        if logit_fn is None:
            logit_fn, is_provenance = resolve_is_logit_fn(
                cfg, default_logit_fn, provenance, device)
        print(f"feature extractor: {provenance}; IS logits: "
              f"{is_provenance}")
    if clip_feature_fn is None:
        from ..metrics import make_clip_feature_fn
        clip_feature_fn = make_clip_feature_fn(device=device)

    real_features = real_clip_features = None
    try:
        images, _ = load_dataset(cfg)
    except FileNotFoundError as e:
        print(f"no real dataset available ({e}); FID/CLIP will be NaN")
        images = None
    if images is not None:
        unit = (images + 1.0) / 2.0
        if feature_fn is not None:
            real_features = compute_real_features(
                unit, feature_fn, num_samples=cfg.train.fid_num_real_samples,
                device=device)
        if clip_feature_fn is not None:
            real_clip_features = compute_real_features(
                unit, clip_feature_fn,
                num_samples=cfg.train.clip_num_real_samples, device=device)
    out = sample_with_metrics(
        cfg, params, feature_fn=feature_fn, logit_fn=logit_fn,
        real_features=real_features, clip_feature_fn=clip_feature_fn,
        real_clip_features=real_clip_features, device=device)
    if is_main():
        with open(os.path.join(cfg.metrics_save_dir, "metrics_meta.json"),
                  "w") as f:
            json.dump({"feature_extractor": provenance,
                       "is_logit_source": is_provenance,
                       "clip_tracking": clip_feature_fn is not None,
                       "is_splits": cfg.train.is_splits,
                       "comparable_to_published_fid":
                           provenance == "pretrained"}, f, indent=2)
    out["provenance"] = provenance
    out["is_logit_source"] = is_provenance
    return out


# ---------------------------------------------------------------------------
# Search


def build_cli_verifier(cfg: Config, conditional: bool, eval_bs: int,
                       device="cuda"):
    """The verifier ``search.verifier`` names: the heuristics (oracle,
    self_supervised, aesthetic), classifier (a SmallCNN checkpoint,
    ``search.classifier_ckpt``, scoring ``search.target_label`` or, for the
    conditional model, the classes of the sampler's labels), clip (CLIP
    image features from ``$ITSD_CLIP_WEIGHTS`` against
    ``search.clip_text_features``, else their mean norm) or ensemble
    (-FID + ``ensemble_is_weight`` * IS from one Inception forward, the
    FID against ``ensemble_num_real`` dataset images)."""
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

    if s.verifier == "clip":
        from ..metrics import make_clip_feature_fn
        from ..search import supervised_verifier
        clip_fn = make_clip_feature_fn(device=device)
        if clip_fn is None:
            raise ValueError(
                "search.verifier=clip needs CLIP weights: set "
                "$ITSD_CLIP_WEIGHTS to an OpenAI CLIP state dict")
        text_feats = None
        if s.clip_text_features:
            text_feats = torch.from_numpy(
                np.load(s.clip_text_features)).to(device)
        # with text features the text-image cosine; without, the mean
        # feature norm (the reference's no-prompt proxy)
        return supervised_verifier(clip_fn, text_feats)

    if s.verifier == "ensemble":
        from ..metrics import make_inception_extractors
        from ..search import ensemble_fid_is_verifier
        feature_fn, _, provenance = make_inception_extractors(device=device)
        images, _ = load_dataset(cfg)
        real_feats = compute_real_features(
            (images + 1.0) / 2.0, feature_fn,
            num_samples=s.ensemble_num_real, device=device)
        print(f"[search] ensemble verifier: -FID + {s.ensemble_is_weight}"
              f"*IS, inception={provenance}, "
              f"{len(real_feats)} real images")
        # one Inception forward feeds both the FID features and IS logits
        return ensemble_fid_is_verifier(
            feature_fn.run_both, torch.from_numpy(real_feats).to(device),
            is_weight=s.ensemble_is_weight)

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
    if guard["flagged"] and is_main():
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
    (``_guard``).

    Under ``torchrun`` the candidates folded into the batch (``n_fold``
    rows, JAX's count) are split over the ranks when there are several and
    they divide ``n_fold``, as JAX's candidate sharding; rank 0 writes.
    ``train.spatial_shard`` > 1 does not apply: each candidate runs
    whole, after JAX's note."""
    from ..search import algorithms as A

    if cfg.train.spatial_shard > 1 and is_main():
        print("[runner] note: train.spatial_shard applies to train/eval/"
              "inference-metrics; search runs unsharded per candidate "
              "(candidates are the sharded axis)")
    model, conditional = build_model(cfg, inference=True)
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
    n_fold = eval_bs * {"random": chunk, "zero_order": s.n_neighbors,
                        "path": s.n_paths, "pruned": s.n_candidates,
                        "smc": s.n_candidates}.get(s.algorithm, 1)
    ranks, shard = world_size(), None
    if ranks > 1 and n_fold % ranks == 0:
        shard = data_group()
        replicate(model, shard)
        if is_main():
            print(f"[search] sharding {n_fold} candidate rows over {ranks} "
                  "devices")

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
                                    noise_fn=nf, shard=shard)
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
                return_images=True, generator=gen, noise_fn=noise_fn,
                shard=shard)
        elif s.algorithm == "path":
            steps = tuple(s.injection_steps)
            r = A.path_search(
                sched, eps_fn, verifier_fn, shape, n_paths=s.n_paths,
                n_active=s.n_active, injection_steps=steps,
                delta_f=s.delta_f, clip_denoised=d.clip_denoised,
                segment=_cli_segment(cfg, sched, eps_fn), generator=gen,
                noise_fn=noise_fn, shard=shard)
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
                noise_fn=noise_fn, shard=shard)
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
                noise_fn=noise_fn, shard=shard)
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
            if is_main():
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
                noise_fn=noise_fn, shard=shard)
        else:
            raise ValueError(f"unknown search algorithm: {s.algorithm!r}")

    guard = None
    if s.guard_proxy and res.best_images is not None:
        guard = _guard(cfg, res, sched, eps_fn, denoise_fn, shape, device)

    if is_main():
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


def train(cfg: Config, max_steps: Optional[int] = None,
          device="cuda") -> dict:
    """The training loop: ``cfg.train.epoch`` epochs (or ``max_steps``
    steps) over ``cfg.data``, writing ``train_metrics.jsonl`` (one record a
    step with its loss and pre-clip gradient norm, one an epoch) and the
    loss curve under ``metrics_save_dir`` and full checkpoints
    ``ckpt_{epoch}`` under ``save_weight_dir`` every ``model_save_freq``
    epochs and at the end. Every ``eval_freq`` epochs it samples from the
    EMA weights: with tracked metrics (``resolve_track_metrics``)
    ``sample_with_metrics`` against a held-out val split, logging
    ``eval_fid``, ``eval_is`` and ``eval_clip``; else a grid
    ``epoch_{epoch}_sampled.png`` under ``sampled_dir``.

    The conditional model's representations (``train.
    extract_representation_freq``): every that many batches of an epoch,
    the post-step weights' activation before ``tail_norm`` on the batch at
    t = T // 2 and labels + 1 (deterministic), averaged over the pixels;
    kept on the device and, with ``train.save_representations``, written
    once an epoch to ``save_weight_dir/representations/epoch_{e}.npz``
    (``representations`` [n, C] float32, ``labels`` [n]). With
    ``train.profile_steps`` = n the first n steps are traced into
    ``metrics_save_dir/trace/trace.json`` (``utils.profiling``).

    Under ``torchrun`` this is data parallel: ``train.batch_size`` is the
    global batch, which the world size must divide; each rank trains on its
    rows (``make_train_step(mesh=...)``), the representations are gathered
    to the global batch's rows, and rank 0 alone writes the checkpoints,
    ``train_metrics.jsonl``, the loss curve, the sample grids, the trace
    and the representations. The in-train evals run on every rank. With
    ``train.spatial_shard=K`` (``_train_mesh``) the W ranks are data = W/K
    by seq = K: the data ranks must divide the batch, and each rank trains
    on its image rows of its batch rows.

    Returns the final loss, the step count, the checkpoint paths, the
    per-step losses, the metric histories, the trace's path (or None) and
    the ``TrainState``."""
    mesh = _train_mesh(cfg)
    with seq_mesh_scope(mesh):
        return _train(cfg, mesh, max_steps, device)


def _train_mesh(cfg: Config):
    """The run's (data, seq) layout, as JAX's ``_train_mesh``: with
    ``train.spatial_shard=K`` > 1, data = W/K by seq = K (ValueError unless
    K divides the world size W and ``data.img_size``); with K = 1, seq
    groups of one (pure data parallelism; with ``attention_impl=ring``,
    local attention and JAX's note)."""
    K = max(1, int(cfg.train.spatial_shard))
    if K == 1:
        if cfg.model.attention_impl == "ring" and is_main():
            print("[runner] attention_impl=ring with spatial_shard=1: "
                  "ring runs with a size-1 seq axis during training "
                  "(local attention, full data parallelism); set "
                  "train.spatial_shard>1 to actually shard tokens")
        return make_seq_mesh(1)
    n = world_size()
    if n % K:
        raise ValueError(
            f"train.spatial_shard={K} must divide device count {n}")
    if cfg.data.img_size % K:
        raise ValueError(
            f"train.spatial_shard={K} must divide img_size "
            f"{cfg.data.img_size} (image rows shard evenly)")
    return make_seq_mesh(K)


def _train(cfg: Config, mesh, max_steps: Optional[int], device) -> dict:
    """``train`` under its (data, seq) layout ``mesh``."""
    ranks = world_size()
    if cfg.train.batch_size % mesh.data:
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} is the global batch: "
            + (f"the world size {ranks}" if mesh.seq == 1 else
               f"its {mesh.data} data ranks (world size {ranks} / "
               f"spatial_shard {mesh.seq})") + " must divide it")
    main = is_main()
    model, conditional = build_model(cfg)
    weak = load_weak_params(cfg, conditional) if conditional else None
    sched = build_schedule(cfg, device=device)
    images, labels = load_dataset(cfg)
    track = resolve_track_metrics(cfg)
    if track:
        images, labels, tracked = _tracked_eval_setup(cfg, images, labels,
                                                      device)
    it = BatchIterator(images, labels if conditional else None,
                       cfg.train.batch_size, seed=cfg.data.seed, mesh=mesh)
    if len(it) == 0:
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} exceeds the dataset "
            f"({len(images)} images): no full batch can be formed")

    init_params(cfg, model)
    if cfg.train.training_load_weight:
        model.load_state_dict(restore_params(os.path.join(
            cfg.save_weight_dir, cfg.train.training_load_weight)))
    model.to(device)
    replicate(model)
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
        ema_decay=cfg.train.ema_decay, mesh=mesh)

    logger = MetricsLogger(
        os.path.join(cfg.metrics_save_dir, "train_metrics.jsonl")
        if main else None, also_print=main)
    generator = make_train_key(cfg, device)
    prefetch = (threaded_prefetch if cfg.train.threaded_input
                else prefetch_to_device)
    ckpt_mgr = (AsyncCheckpointManager()
                if cfg.train.async_checkpoint and main else None)
    profiler = trace_steps(cfg.train.profile_steps if main else 0,
                           os.path.join(cfg.metrics_save_dir, "trace"))
    extract_freq = cfg.train.extract_representation_freq if conditional \
        else 0
    losses, ckpts, step, t0 = [], [], 0, time.time()
    metrics_history = []
    for epoch in range(cfg.train.epoch):
        metrics = []  # device scalars: synced once an epoch, not a step
        reps = []     # (representations, labels) on the device
        for batch_i, batch in enumerate(prefetch(it, size=2,
                                                 device=device)):
            with profiler.step():
                metrics.append(step_fn(state, batch, generator))
            step += 1
            if extract_freq and batch_i % extract_freq == 0:
                reps.append(tuple(
                    gather_image(a, mesh, None)
                    for a in _representation(state.model, batch, sched.T,
                                             mesh)))
            if max_steps is not None and step >= max_steps:
                break
        if reps and cfg.train.save_representations and main:
            rep_dir = os.path.join(cfg.save_weight_dir, "representations")
            os.makedirs(rep_dir, exist_ok=True)
            np.savez(os.path.join(rep_dir, f"epoch_{epoch}.npz"),
                     representations=torch.cat([r for r, _ in reps])
                     .cpu().numpy(),
                     labels=torch.cat([lab for _, lab in reps])
                     .cpu().numpy())
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
            elif main:
                save_checkpoint(path, state)
            ckpts.append(path)
        if (epoch + 1) % cfg.train.eval_freq == 0:
            if track:
                out = sample_with_metrics(
                    cfg, state.ema_state_dict(), **tracked,
                    tag=f"epoch_{epoch}", device=device)
                metrics_history.append({"epoch": epoch,
                                        "history": out["history"]})
                if out["history"]:
                    _, fid, is_mean, clip_s = out["history"][-1]
                    logger.log({"epoch": epoch, "eval_fid": fid,
                                "eval_is": is_mean, "eval_clip": clip_s})
            else:
                _sample_grid_during_training(cfg, state, epoch, device,
                                             conditional, weak)
        if max_steps is not None and step >= max_steps:
            break
    if ckpt_mgr is not None:
        ckpt_mgr.close()
    profiler.close()
    if losses and main:
        plot_loss_curve(losses, os.path.join(cfg.metrics_save_dir,
                                             "loss_curve.png"))
    logger.close()
    return {"final_loss": losses[-1] if losses else None, "steps": step,
            "checkpoints": ckpts, "losses": losses, "state": state,
            "metrics_history": metrics_history, "trace": profiler.path}


def _representation(model, batch: dict, T: int, mesh=None):
    """(the activation before ``tail_norm`` averaged over the pixels,
    [B, C] float32; the batch's labels) of the conditional ``model`` on
    ``batch`` at t = T // 2 and labels + 1, deterministic, without a
    gradient: JAX's ``repr_fn`` hook. Under ``mesh`` the batch holds this
    rank's image rows, and the mean is over the whole images."""
    x, labels = batch["image"], batch["label"]
    t = torch.full((x.shape[0],), T // 2, dtype=torch.int64,
                   device=x.device)
    with torch.no_grad(), row_shards(mesh):
        _, rep = model(x, t, labels.long() + 1, return_representation=True)
    rep = rep.float().mean(dim=(1, 2))
    if mesh is not None and mesh.seq > 1:
        rep = all_reduce_sum(rep, mesh.seq_group) / mesh.seq
    return rep, labels


def _tracked_eval_setup(cfg: Config, images, labels, device):
    """The tracked eval of ``train``: a val split of ``data.val_ratio``
    (held out of training when ``train.use_val_for_eval``, else only
    read), the extractors and the val split's real features. Returns
    (train images, train labels, ``sample_with_metrics``' extractor
    keywords)."""
    from ..metrics import default_extractors, make_clip_feature_fn

    n_val = max(1, int(len(images) * cfg.data.val_ratio))
    perm = np.random.default_rng(cfg.data.seed).permutation(len(images))
    val_unit = (images[perm[:n_val]] + 1.0) / 2.0
    if cfg.train.use_val_for_eval:
        images = images[perm[n_val:]]
        if labels is not None:
            labels = labels[perm[n_val:]]
    feature_fn, logit_fn, provenance = default_extractors(device=device)
    logit_fn, is_provenance = resolve_is_logit_fn(cfg, logit_fn, provenance,
                                                  device)
    clip_fn = make_clip_feature_fn(device=device)
    print(f"[train] tracked-metric extractor: {provenance}; "
          f"IS logits: {is_provenance}")
    real = compute_real_features(
        val_unit, feature_fn, num_samples=cfg.train.fid_num_real_samples,
        device=device)
    real_clip = None
    if clip_fn is not None:
        real_clip = compute_real_features(
            val_unit, clip_fn, num_samples=cfg.train.clip_num_real_samples,
            device=device)
    return images, labels, dict(
        feature_fn=feature_fn, logit_fn=logit_fn, real_features=real,
        clip_feature_fn=clip_fn, real_clip_features=real_clip)


def _sample_grid_during_training(cfg: Config, state, epoch: int,
                                 device="cuda", conditional: bool = False,
                                 weak_params=None) -> str:
    """A grid of ``eval_batch_size`` samples from the EMA weights (guided
    as ``evaluate`` guides, for the conditional model), written to
    ``sampled_dir/epoch_{epoch}_sampled.png``."""
    sched = build_schedule(cfg, inference=True, device=device)
    eval_bs = cfg.train.eval_batch_size or min(cfg.train.batch_size, 64)
    model, _ = build_model(cfg, inference=True)
    load_weights(cfg, model, state.ema_state_dict())
    model.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed * 1_000_003 + epoch + 1)
    size = cfg.data.img_size
    x_T = torch.randn((eval_bs, size, size, 3), generator=gen, device=device)
    eps_fn = sampling_eps_fn(cfg, model, conditional, eval_bs, weak_params)
    mesh = _spatial_mesh(cfg, size)
    with torch.inference_mode(), seq_mesh_scope(mesh):
        imgs = _sample_images(
            mesh, lambda x, g, nf: run_sampler(cfg, sched, eps_fn, x, g, nf),
            x_T, gen)
    path = os.path.join(cfg.sampled_dir, f"epoch_{epoch}_sampled.png")
    if is_main():
        os.makedirs(cfg.sampled_dir, exist_ok=True)
        save_image_grid(imgs.cpu().numpy(), path, nrow=cfg.nrow)
    return path


def finetune_extended_T(cfg: Config, max_steps: Optional[int] = None,
                        device="cuda") -> dict:
    """The T-extension fine-tune: load ``test_load_weight`` (a full
    checkpoint's EMA weights, else its weights, or a weights-only state
    dict), extend its time table to ``diffusion.T``
    (``train.time_embedding_strategy``), freeze every parameter outside the
    time embedding and train the time embedding alone at
    ``train.fine_tune_lr``, with train's loss options and no EMA, for
    ``train.epoch`` epochs (or ``max_steps`` steps). After each epoch the
    weights-only checkpoint ``fine_tuned_T{T}_epoch_{e}`` is written under
    ``save_weight_dir``. Returns ``final_loss``, the per-step ``losses``,
    the ``steps``, the ``checkpoints``, the ``TrainState`` and
    ``ckpt_T_detected`` (the checkpoint's table rows, None for a
    functional embedding). ``train.spatial_shard`` > 1 does not apply:
    it prints JAX's note and runs unsharded."""
    if cfg.train.spatial_shard > 1 and is_main():
        print("[runner] note: train.spatial_shard is not applied by "
              "finetune-t (small embedding-only updates); it runs "
              "unsharded")
    model, conditional = build_model(cfg)
    sched = build_schedule(cfg, device=device)
    params = load_eval_params(cfg)
    ckpt_T = detect_checkpoint_T(params)
    load_weights(cfg, model, params)
    del params
    model.to(device)
    images, labels = load_dataset(cfg)
    it = BatchIterator(images, labels if conditional else None,
                       cfg.train.batch_size, seed=cfg.data.seed)
    if len(it) == 0:
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} exceeds the dataset "
            f"({len(images)} images): no full batch can be formed")
    tx = make_optimizer(OptimizerConfig(
        lr=cfg.train.fine_tune_lr, weight_decay=cfg.train.weight_decay,
        grad_clip=cfg.train.grad_clip, multiplier=cfg.train.multiplier,
        epochs=cfg.train.epoch, steps_per_epoch=len(it), ema_decay=None),
        freeze_except_time_embedding(model))
    state = create_train_state(model, tx, ema=False)
    step_fn = make_train_step(
        sched, conditional=conditional, ema_decay=None,
        loss_reduction=cfg.train.loss_reduction,
        loss_weighting=cfg.train.loss_weighting,
        snr_gamma=cfg.train.snr_gamma, label_dropout=cfg.train.label_dropout)
    generator = make_train_key(cfg, device)
    prefetch = (threaded_prefetch if cfg.train.threaded_input
                else prefetch_to_device)
    losses, ckpts, step = [], [], 0
    for epoch in range(cfg.train.epoch):
        epoch_losses = []  # device scalars: synced once an epoch
        for batch in prefetch(it, size=2, device=device):
            epoch_losses.append(step_fn(state, batch, generator)["loss"])
            step += 1
            if max_steps is not None and step >= max_steps:
                break
        if epoch_losses:
            losses.extend(torch.stack(epoch_losses).float().cpu().tolist())
        path = os.path.join(cfg.save_weight_dir,
                            f"fine_tuned_T{cfg.diffusion.T}_epoch_{epoch}")
        if is_main():
            save_params(path, model.state_dict())
        ckpts.append(path)
        if max_steps is not None and step >= max_steps:
            break
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "steps": step, "checkpoints": ckpts, "state": state,
            "ckpt_T_detected": ckpt_T}
