"""Inception Score: IS = exp(E_x[KL(p(y|x) || p(y))]).

Counterpart of ``itsd_tpu/metrics/is_score.py``: ``is_score`` (JAX's
``is_score_jax``), one split on the device and differentiable, for
verifiers; ``inception_score_from_probs`` and ``inception_score``, the
split protocol (mean and std over ``splits`` chunks), float64 on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def is_score(probs: torch.Tensor) -> torch.Tensor:
    """Single-split IS of class probabilities [N, K]; differentiable."""
    py = probs.mean(dim=0, keepdim=True)
    kl = probs * (torch.log(probs + 1e-16) - torch.log(py + 1e-16))
    return torch.exp(kl.sum(dim=1).mean())


def inception_score_from_probs(probs, splits: int = 10
                               ) -> Tuple[float, float]:
    """IS mean and std over ``splits`` chunks of p(y|x) [N, K], float64 on
    the host; an empty chunk is skipped."""
    probs = np.asarray(probs, dtype=np.float64)
    n = len(probs)
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def softmax_probs(logit_fn, images: torch.Tensor,
                  batch_size: int = 64) -> torch.Tensor:
    """p(y|x) [N, K] of ``images``, on their device: ``logit_fn`` on
    batches of ``batch_size``, softmax in float32."""
    return torch.cat([
        torch.softmax(logit_fn(images[i:i + batch_size]).float(), dim=-1)
        for i in range(0, images.shape[0], batch_size)])


def inception_score(logit_fn, images: torch.Tensor, splits: int = 10,
                    batch_size: int = 64) -> Tuple[float, float]:
    """IS (mean, std) of ``images`` in [0, 1] under ``logit_fn(images) ->
    [B, K]``: logits and softmax on the device in batches, one read back,
    the split protocol on the host."""
    return inception_score_from_probs(
        softmax_probs(logit_fn, images, batch_size).cpu().numpy(), splits)
