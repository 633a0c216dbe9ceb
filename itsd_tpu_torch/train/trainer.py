"""Class-based Trainer facade.

Counterpart of ``itsd_tpu/train/trainer.py``: a thin, stateful wrapper over
the runner's pipelines, for interactive use: ``fit``, ``sample``,
``evaluate``, ``save`` and ``load``. ``search`` and the T-extension
fine-tune are not yet ported and raise.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..utils import Config
from .checkpoint import is_full_checkpoint, restore_params, save_checkpoint
from .loop import TrainState


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        from ..cli import runner  # late import: runner pulls most modules
        self.cfg = cfg
        self.device = device
        self._runner = runner
        self.model, self.conditional = runner.build_model(cfg)
        self.state: Optional[TrainState] = None

    # -- training ----------------------------------------------------------

    def fit(self, max_steps: Optional[int] = None) -> dict:
        out = self._runner.train(self.cfg, max_steps=max_steps,
                                 device=self.device)
        self.state = out["state"]
        self.model = self.state.model
        return out

    def finetune_extended_T(self, max_steps: Optional[int] = None) -> dict:
        return self._runner.finetune_extended_T(self.cfg, max_steps=max_steps,
                                                device=self.device)

    # -- inference ---------------------------------------------------------

    @property
    def params(self) -> dict:
        """The weights to sample from: the EMA where there is one."""
        assert self.state is not None, "no params: fit() or load() first"
        return self.state.ema_state_dict()

    def _eval_model(self):
        model, _ = self._runner.build_model(self.cfg)
        model.load_state_dict(self.params)
        return model.to(self.device).eval()

    def sample(self, n: int,
               generator: Optional[torch.Generator] = None) -> np.ndarray:
        """``n`` images [n, H, W, 3] in [-1, 1], through the sampler
        ``cfg.diffusion.sampler`` names."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                cfg.seed)
        sched = self._runner.build_schedule(cfg, inference=True,
                                            device=self.device)
        size = cfg.data.img_size
        x_T = torch.randn((n, size, size, 3), generator=generator,
                          device=self.device)
        eps_fn = self._runner.make_eps_fn(self._eval_model(),
                                          self.conditional)
        with torch.inference_mode():
            imgs = self._runner.run_sampler(cfg, sched, eps_fn, x_T,
                                            generator)
        return imgs.cpu().numpy()

    def search(self, verifier_fn=None) -> dict:
        raise NotImplementedError("Trainer.search: search is not yet ported")

    def evaluate(self) -> dict:
        return self._runner.evaluate(self.cfg, params=self.params,
                                     device=self.device)

    # -- checkpointing -----------------------------------------------------

    def save(self, name: str = "ckpt") -> str:
        assert self.state is not None
        path = os.path.join(self.cfg.save_weight_dir, name)
        save_checkpoint(path, self.state)
        return path

    def load(self, name: str) -> None:
        """Load a full checkpoint (its step, weights and EMA) or a
        weights-only state dict onto this trainer's device, for sampling.
        The optimizer state is not restored (``restore_checkpoint`` into a
        ``TrainState`` does that)."""
        obj = restore_params(os.path.join(self.cfg.save_weight_dir, name))
        full = is_full_checkpoint(obj)
        model = self.model.to(self.device)
        model.load_state_dict(obj["params"] if full else obj)
        ema = None
        if full and obj["ema_params"] is not None:
            ema = OrderedDict((k, v.to(self.device))
                              for k, v in obj["ema_params"].items())
        self.state = TrainState(step=int(obj["step"]) if full else 0,
                                model=model, tx=None, ema=ema)
