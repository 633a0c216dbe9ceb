"""The training step and its state.

Counterpart of ``itsd_tpu/train/loop.py``. The step is the optax chain of the
JAX package written out by hand: global-norm clip, AdamW on the
warmup-cosine schedule, then the EMA of the parameters. It matches optax's
arithmetic, not torch's helpers:

* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  computed as ``(g / norm) * max_norm`` with no epsilon (torch's
  ``clip_grad_norm_`` adds 1e-6);
* the schedule is read at the step count before the update (a ``LambdaLR``
  stepped after the optimizer);
* AdamW decays every parameter, including those without a gradient;
* the EMA is ``e * d + p * (1 - d)``, taken after the update.

Unlike the JAX step, which is pure, this one updates the model, the
optimizer's moments and the EMA in place. It makes no host sync: the loss
and the pre-clip gradient norm come back as device tensors.

Data parallel (``shard``, a process group): each rank holds the model and
takes its rows of the global batch; every draw is made for the global batch
and cut to the rank's rows (``parallel.RowDraws``), and the gradients and
the loss are summed over the ranks and scaled to the global batch's before
the clip, so that the clip, AdamW and the EMA run alike on every rank and
the result does not depend on the world size.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import torch

from ..core.process import (diffusion_train_terms, loss_reduce,
                            min_snr_weight, mse_elementwise)
from ..core.schedules import DiffusionSchedule
from ..parallel import RowDraws, all_reduce_sum_, draw, local_rows, world_size
from .schedule import warmup_cosine_epochs


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0          # global-norm clip
    multiplier: float = 2.0         # warmup peak multiplier
    epochs: int = 10
    warm_epochs: Optional[int] = None  # default: epochs // 10
    steps_per_epoch: int = 1
    ema_decay: Optional[float] = 0.999  # None disables EMA


@dataclasses.dataclass
class Tx:
    """The counterpart of the optax chain: the clip's bound, AdamW and the
    schedule that sets its lr."""
    grad_clip: float
    optimizer: torch.optim.AdamW
    lr_schedule: torch.optim.lr_scheduler.LambdaLR


def make_optimizer(cfg: OptimizerConfig, params) -> Tx:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, as optax) over ``params``, its lr
    set each step by ``warmup_cosine_epochs``."""
    warm = cfg.warm_epochs if cfg.warm_epochs is not None else cfg.epochs // 10
    sched = warmup_cosine_epochs(cfg.lr, cfg.multiplier, cfg.epochs, warm,
                                 cfg.steps_per_epoch)
    # lr 1.0 times the schedule's value: the group's lr IS the schedule
    opt = torch.optim.AdamW(list(params), lr=1.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            foreach=True)
    return Tx(cfg.grad_clip, opt,
              torch.optim.lr_scheduler.LambdaLR(opt, sched))


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    tx: Optional[Tx]  # None: loaded for sampling, not for training
    ema: Optional["OrderedDict[str, torch.Tensor]"]  # None: EMA disabled

    def ema_state_dict(self) -> "OrderedDict[str, torch.Tensor]":
        """The weights to sample from: the EMA where there is one, else
        the model's."""
        return self.ema if self.ema is not None else self.model.state_dict()


def create_train_state(model: torch.nn.Module, tx: Tx,
                       ema: bool = True) -> TrainState:
    return TrainState(
        step=0, model=model, tx=tx,
        ema=(OrderedDict((k, p.detach().clone())
                         for k, p in model.named_parameters())
             if ema else None))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as optax.clip_by_global_norm does; returns
    the norm before the clip."""
    norm = global_norm(grads)
    below = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, max_norm * one))
    return norm


def make_train_step(sched: DiffusionSchedule, *, conditional: bool = False,
                    loss_reduction: str = "mean",
                    loss_weighting: str = "none", snr_gamma: float = 5.0,
                    label_dropout: float = 0.1,
                    ema_decay: Optional[float] = 0.999, shard=None):
    """``step_fn(state, batch, generator, t=None, noise=None, drop=None)
    -> metrics``.

    ``batch`` is ``{"image": [B, H, W, C]}`` on the model's device, plus
    ``"label": [B]`` (the dataset's 0..num_labels-1) when ``conditional``:
    the model then sees ``label + 1``, or the null class 0 where ``drop``
    is true, each label with probability ``label_dropout``. t, the noise,
    the label-dropout uniforms and the dropout masks are drawn from
    ``generator`` in that order, unless t, the noise and the drop mask
    ``drop`` [B] bool are passed in (the tests pass JAX's). ``metrics``
    holds the loss and the pre-clip gradient norm as device tensors. The
    step updates, clips and decays the optimizer's parameters only; the
    norm is theirs (JAX's metric is over every gradient, which is the same
    set unless the time-embedding fine-tune froze the rest).

    With ``shard`` (a process group; see the module docstring) ``batch`` is
    this rank's rows of the global batch, the draws and any ``t``,
    ``noise`` and ``drop`` passed in are the global batch's, and the loss
    and the gradient norm are the global batch's."""
    if loss_weighting not in ("none", "min_snr"):
        raise ValueError(f"unknown loss weighting: {loss_weighting!r}")
    # the global loss over W ranks of equal batches: the mean of the
    # ranks' means, or for sum / b^2 their sum over W^2
    ranks = world_size(shard) if shard is not None else 1
    rank_weight = 1.0 / (ranks if loss_reduction == "mean"
                         else ranks * ranks)

    def rows(a):
        return a if a is None or shard is None else local_rows(a, shard)

    def loss_fn(model, batch, generator, t, noise, drop):
        if shard is not None:
            generator = RowDraws(generator, shard)
        t, noise, drop = rows(t), rows(noise), rows(drop)
        t, noise, x_t = diffusion_train_terms(sched, generator,
                                              batch["image"], t, noise)
        labels = None
        if conditional:
            labels = batch["label"].long() + 1
            if drop is None:
                drop = draw(torch.rand, labels.shape, generator,
                            device=labels.device) < label_dropout
            labels = torch.where(drop, torch.zeros_like(labels), labels)
        eps = model(x_t, t, labels, deterministic=False, generator=generator)
        per_elem = mse_elementwise(eps, noise)
        if loss_weighting == "min_snr":
            w = min_snr_weight(sched, t, snr_gamma)
            per_elem = per_elem * w.reshape((-1,) + (1,) * (per_elem.dim()
                                                            - 1))
        return loss_reduce(per_elem, loss_reduction)

    def step_fn(state: TrainState, batch, generator=None, t=None,
                noise=None, drop=None) -> dict:
        model, tx = state.model, state.tx
        model.train()
        # the optimizer's parameters: all of them, or the time embedding's
        # alone in the fine-tune (the others are frozen)
        params = [p for g in tx.optimizer.param_groups for p in g["params"]]
        for p in params:
            p.grad = None
        loss = loss_fn(model, batch, generator, t, noise, drop)
        loss.backward()
        for p in params:  # optax sees a zero gradient for an unused leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if shard is not None:
            # the global batch's gradient and loss, alike on every rank
            grads = [p.grad for p in params]
            all_reduce_sum_(grads + [loss.reshape(1)], shard)
            torch._foreach_mul_(grads, rank_weight)
            loss = loss * rank_weight
        grad_norm = clip_by_global_norm_([p.grad for p in params],
                                         tx.grad_clip)
        tx.optimizer.step()
        tx.lr_schedule.step()
        if state.ema is not None and ema_decay is not None:
            ema = list(state.ema.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [p.detach() for p in
                                      model.parameters()],
                                alpha=1.0 - ema_decay)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return step_fn
