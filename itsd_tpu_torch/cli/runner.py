"""End-to-end pipelines of the port: ``train`` and ``evaluate``.

Counterpart of ``itsd_tpu/cli/runner.py`` (``build_model``,
``build_schedule``, ``load_dataset`` and ``init_params`` at 49-135,
``load_eval_params`` 137-160, ``_cli_segment`` 163-177, ``run_sampler``
179-226, ``_validated_launch_segments`` 228-240,
``make_eps_fn`` and ``load_weak_params`` 277-319, ``make_train_key`` and
``resolve_track_metrics`` 322-350, ``train`` 389-600,
``_sample_grid_during_training`` 639-662 and ``evaluate`` 668-712), with
the conditional model, classifier-free guidance, autoguidance and every
sampler. Search, spatial meshes, metric-tracked training, profiling,
representation extraction, the cross-T surgery of a table time embedding
and the T-extension fine-tune are not yet ported and raise.

Entry points run on ``device="cuda"`` unless the caller passes another.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Optional

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
        weak.to(device).eval()
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
                generator: torch.Generator) -> torch.Tensor:
    """The sampler ``cfg.diffusion.sampler`` names: ancestral DDPM, DDIM,
    DPM-Solver++ or Picard, ``diffusion.ddim_steps`` the step budget of
    the last three. A non-empty ``diffusion.restart_intervals`` wraps the
    ddpm, ddim or dpm family in restart sampling. Picard cannot run with a
    guidance interval: a sweep evaluates every timestep of its grid in one
    call, so guidance cannot be switched per timestep (JAX decides it for
    the whole sweep from the first grid point)."""
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
                              eta=d.ddim_eta, generator=generator)
    if d.sampler == "ddim":
        return ddim_sample(sched, eps_fn, x_T, num_steps=steps,
                           eta=d.ddim_eta, generator=generator)
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
                  clip_denoised=d.clip_denoised)


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
