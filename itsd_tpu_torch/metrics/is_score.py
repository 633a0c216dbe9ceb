"""Inception Score of one split, on the device.

Counterpart of ``itsd_tpu/metrics/is_score.py:47-51`` (``is_score_jax``):
IS = exp(E_x[KL(p(y|x) || p(y))]) over the rows of ``probs``. The split
protocol and the Inception network are not yet ported.
"""

from __future__ import annotations

import torch


def is_score(probs: torch.Tensor) -> torch.Tensor:
    """Single-split IS of class probabilities [N, K]; differentiable."""
    py = probs.mean(dim=0, keepdim=True)
    kl = probs * (torch.log(probs + 1e-16) - torch.log(py + 1e-16))
    return torch.exp(kl.sum(dim=1).mean())
