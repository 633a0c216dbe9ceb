"""End-to-end pipelines of the port: ``train`` and ``evaluate``.

Counterpart of ``itsd_tpu/cli/runner.py`` (``build_model``,
``build_schedule``, ``load_dataset`` and ``init_params`` at 49-135,
``load_eval_params`` 137-160, ``run_sampler``'s ancestral branch 179-227,
``make_eps_fn`` 277-284, ``make_train_key`` and ``resolve_track_metrics``
322-350, ``train`` 389-600, ``_sample_grid_during_training`` 639-662 and
``evaluate`` 668-712). Search, the fast samplers, guidance, segmented
launches, spatial meshes, metric-tracked training, profiling,
representation extraction and the T-extension fine-tune are not yet ported
and raise.

Entry points run on ``device="cuda"`` unless the caller passes another.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

import torch

from ..core import linear_schedule, sample
from ..data import (BatchIterator, load_cifar10, load_image_folder,
                    prefetch_to_device, shapes_dataset, synthetic_dataset,
                    threaded_prefetch)
from ..models import UNet, uncond_unet_config
from ..train import (OptimizerConfig, create_train_state, make_optimizer,
                     make_train_step)
from ..train.checkpoint import (AsyncCheckpointManager, is_full_checkpoint,
                                restore_params, save_checkpoint)
from ..utils import Config, MetricsLogger, save_image_grid


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported")


def build_model(cfg: Config):
    """(model, conditional) for ``cfg.model``: the unconditional UNet."""
    m = cfg.model
    if m.backbone != "unet":
        raise _not_ported(f"model.backbone={m.backbone!r}")
    if m.num_labels is not None:
        raise _not_ported("the conditional UNet (model.num_labels)")
    if m.remat:
        raise _not_ported("model.remat")
    ucfg = uncond_unet_config(
        ch=m.channel, ch_mult=tuple(m.channel_mult), attn=tuple(m.attn),
        num_res_blocks=m.num_res_blocks, dropout=m.dropout,
        time_embed=m.time_embed,
        dtype=m.dtype, attention_impl=m.attention_impl)
    return UNet(ucfg), False


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


def make_eps_fn(model: UNet, conditional: bool = False):
    """eps_fn(x, t) for the sampler."""
    if conditional:
        raise _not_ported("guided sampling (CFG and autoguidance)")
    return lambda x, t: model(x, t)


def run_sampler(cfg: Config, sched, eps_fn, x_T: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """The sampler ``cfg.diffusion.sampler`` names; only ancestral DDPM is
    ported."""
    d = cfg.diffusion
    if d.restart_intervals:
        raise _not_ported("restart sampling (diffusion.restart_intervals)")
    if d.sampler in ("ddim", "dpm", "picard"):
        raise _not_ported(f"diffusion.sampler={d.sampler!r}")
    if d.sampler != "ddpm":
        raise ValueError(f"unknown diffusion.sampler {d.sampler!r}; "
                         "expected ddpm | ddim | dpm | picard")
    return sample(sched, eps_fn, x_T, generator=generator,
                  clip_denoised=d.clip_denoised)


def evaluate(cfg: Config, params=None, device="cuda") -> dict:
    """Sample ``eval_batch_size`` images with the ancestral sampler; write
    the initial-noise grid and the sample grid under ``cfg.sampled_dir``.
    Returns ``{"images": [B,H,W,3] numpy in [-1, 1], "path": grid path}``."""
    if max(1, int(cfg.diffusion.launch_segments or 1)) > 1:
        raise _not_ported("diffusion.launch_segments > 1")
    if cfg.train.spatial_shard > 1:
        raise _not_ported("train.spatial_shard > 1 (spatial meshes)")
    model, conditional = build_model(cfg)
    if params is None:
        params = load_eval_params(cfg)
    model.load_state_dict(params)
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
    with torch.inference_mode():
        imgs = run_sampler(cfg, sched, make_eps_fn(model, conditional), x_T,
                           gen)
    images = imgs.cpu().numpy()
    out_path = os.path.join(cfg.sampled_dir, cfg.sampled_img_name)
    save_image_grid(images, out_path, nrow=cfg.nrow)
    return {"images": images, "path": out_path}


# ---------------------------------------------------------------------------
# Training


def make_train_key(cfg: Config, device="cuda") -> torch.Generator:
    """The training run's generator, seeded from ``cfg.seed``: it draws t,
    the noise and the dropout masks of every step, in that order. It is
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
    sched = build_schedule(cfg, device=device)
    images, _ = load_dataset(cfg)
    it = BatchIterator(images, None, cfg.train.batch_size, seed=cfg.data.seed)
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
        snr_gamma=cfg.train.snr_gamma, ema_decay=cfg.train.ema_decay)

    logger = MetricsLogger(
        os.path.join(cfg.metrics_save_dir, "train_metrics.jsonl"))
    generator = make_train_key(cfg, device)
    prefetch = (threaded_prefetch if cfg.train.threaded_input
                else prefetch_to_device)
    ckpt_mgr = AsyncCheckpointManager() if cfg.train.async_checkpoint else None
    losses, ckpts, step, t0 = [], [], 0, time.time()
    for epoch in range(cfg.train.epoch):
        metrics = []  # device scalars: synced once an epoch, not a step
        for batch in prefetch(({"image": b["image"]} for b in it), size=2,
                              device=device):
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
            _sample_grid_during_training(cfg, state, epoch, device)
        if max_steps is not None and step >= max_steps:
            break
    if ckpt_mgr is not None:
        ckpt_mgr.close()
    logger.close()
    return {"final_loss": losses[-1] if losses else None, "steps": step,
            "checkpoints": ckpts, "losses": losses, "state": state}


def _sample_grid_during_training(cfg: Config, state, epoch: int,
                                 device="cuda") -> str:
    """A grid of ``eval_batch_size`` samples from the EMA weights, written
    to ``sampled_dir/epoch_{epoch}_sampled.png``."""
    sched = build_schedule(cfg, inference=True, device=device)
    eval_bs = cfg.train.eval_batch_size or min(cfg.train.batch_size, 64)
    model = copy.deepcopy(state.model)
    model.load_state_dict(state.ema_state_dict())
    model.eval()
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed * 1_000_003 + epoch + 1)
    size = cfg.data.img_size
    x_T = torch.randn((eval_bs, size, size, 3), generator=gen, device=device)
    with torch.inference_mode():
        imgs = run_sampler(cfg, sched, make_eps_fn(model), x_T, gen)
    path = os.path.join(cfg.sampled_dir, f"epoch_{epoch}_sampled.png")
    os.makedirs(cfg.sampled_dir, exist_ok=True)
    save_image_grid(imgs.cpu().numpy(), path, nrow=cfg.nrow)
    return path


def finetune_extended_T(cfg: Config, max_steps: Optional[int] = None,
                        device="cuda") -> dict:
    raise _not_ported("finetune-t (the T-extension fine-tune and its "
                      "time-embedding surgery)")
