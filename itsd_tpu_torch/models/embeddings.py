"""Time and label embeddings and the layers shared by the UNet.

Counterpart of ``itsd_tpu/models/embeddings.py:34-116``: the functional
sinusoidal time embedding (any integer t), the trainable ``[T, ch]``
sinusoid table of the conditional UNet (t < T only), the label embedding
with its null class 0, and their two-layer MLP.

Parameters are float32; each layer computes in its input's dtype (bfloat16
on the card), as the Flax modules do with ``dtype=bfloat16``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Gain of the near-zero Xavier init on the residual, attention and tail
# output layers: variance 1e-10 / fan_avg, as the JAX package's tiny_xavier.
TINY_GAIN = 1e-5


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def sinusoidal_features(t: torch.Tensor, d_model: int) -> torch.Tensor:
    """Interleaved [sin0, cos0, sin1, cos1, ...] sinusoids, ``[B, d_model]``
    float32, with freq_k = exp(-(2k / d_model) * ln(10000))."""
    if d_model % 2:
        raise ValueError(f"d_model must be even, got {d_model}")
    freqs = torch.exp(
        -torch.arange(0, d_model, 2, dtype=torch.float32, device=t.device)
        / d_model * math.log(10000.0))
    emb = t.float()[:, None] * freqs[None, :]             # [B, half]
    emb = torch.stack([torch.sin(emb), torch.cos(emb)], dim=-1)
    return emb.reshape(t.shape[0], d_model)


class _EmbedMLP(nn.Module):
    """Linear -> swish -> Linear."""

    def __init__(self, d_in: int, dim: int):
        super().__init__()
        self.fc1 = Dense(d_in, dim)
        self.fc2 = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class FunctionalTimeEmbedding(nn.Module):
    """t -> ``[B, dim]`` in ``dtype``; works for any integer t."""

    def __init__(self, d_model: int, dim: int):
        super().__init__()
        self.d_model = d_model
        self.mlp = _EmbedMLP(d_model, dim)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        emb = sinusoidal_features(t.reshape(-1), self.d_model)
        return self.mlp(emb.to(dtype))


class TableTimeEmbedding(nn.Module):
    """A trainable ``[T, d_model]`` table (sinusoid features at init, set by
    ``reset_table``), looked up at t, then the MLP. T is baked into the
    weights."""

    def __init__(self, T: int, d_model: int, dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(T, d_model))
        self.mlp = _EmbedMLP(d_model, dim)

    @torch.no_grad()
    def reset_table(self) -> None:
        T, d_model = self.table.shape
        self.table.copy_(sinusoidal_features(
            torch.arange(T, device=self.table.device), d_model))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.mlp(self.table[t.reshape(-1)].to(dtype))


class ConditionalEmbedding(nn.Module):
    """Labels (0 = the null class) -> ``[B, dim]``: a ``[num_labels + 1,
    d_model]`` table, the looked-up row multiplied by ``labels != 0`` (so
    the null class embeds to zero and gives its row no gradient, whatever
    the row holds), then the MLP."""

    def __init__(self, num_labels: int, d_model: int, dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(num_labels + 1, d_model))
        self.mlp = _EmbedMLP(d_model, dim)

    def forward(self, labels: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        labels = labels.reshape(-1)
        emb = self.table[labels] * (labels != 0).to(self.table.dtype)[:, None]
        return self.mlp(emb.to(dtype))
