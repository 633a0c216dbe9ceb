"""End-to-end pipelines of the port: so far, ``evaluate``.

Counterpart of ``itsd_tpu/cli/runner.py`` (``build_model``,
``build_schedule`` and ``init_params`` at 49-84 and 127-135,
``run_sampler``'s ancestral branch 179-227, ``make_eps_fn`` 277-284 and
``evaluate`` 668-712). Training, search, the fast samplers, guidance,
segmented launches and spatial meshes are not yet ported and raise.

Entry points run on ``device="cuda"`` unless the caller passes another.
"""

from __future__ import annotations

import os

import torch

from ..core import linear_schedule, sample
from ..models import UNet, uncond_unet_config
from ..utils import Config, save_image_grid


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
        num_res_blocks=m.num_res_blocks, time_embed=m.time_embed,
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


def load_eval_params(cfg: Config) -> dict:
    """The state dict at ``save_weight_dir/test_load_weight``, a file written
    by ``torch.save(model.state_dict())``. Orbax checkpoints of the JAX
    package cannot be read here."""
    if not cfg.test_load_weight:
        raise ValueError("eval needs test_load_weight (a torch.save'd state "
                         "dict under save_weight_dir)")
    path = os.path.join(cfg.save_weight_dir, cfg.test_load_weight)
    return torch.load(path, map_location="cpu", weights_only=True)


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
