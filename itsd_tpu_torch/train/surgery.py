"""Cross-T checkpoint surgery and selective freezing.

Counterpart of ``itsd_tpu/train/surgery.py`` on the port's state dicts,
where a table time embedding is the entry ``time_embedding.table``
``[T, d_model]``:

* ``detect_checkpoint_T``: the T a table checkpoint was trained at (its
  table's rows), or None for the functional embedding, which any T samples
  without surgery;
* ``extend_time_embedding``: resample the table to another T, by linear
  interpolation over the timestep axis ("interpolate") or as fresh sinusoid
  features ("reinit"), keeping the embedding's MLP;
* ``time_embedding_mask`` and ``freeze_except_time_embedding``: only the
  time embedding trains. JAX zeroes the other updates with
  ``optax.set_to_zero``; here the other parameters stop requiring a
  gradient and the optimizer is built over the time embedding alone, so
  the frozen ones get neither an update nor weight decay.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from ..models.embeddings import sinusoidal_features

TABLE = "time_embedding.table"
PREFIX = "time_embedding."


def detect_checkpoint_T(params: Mapping) -> Optional[int]:
    """The trained T of a table-embedding state dict, else None."""
    table = params.get(TABLE)
    return None if table is None else int(table.shape[0])


def extend_time_embedding(params: Mapping, new_T: int,
                          strategy: str = "interpolate") -> Mapping:
    """``params`` with the time table resized to ``new_T`` rows (a new
    dict; the other entries are shared). "interpolate" maps new row i to
    the old coordinate i * (old_T - 1) / (new_T - 1) and mixes its two
    neighbours, in float64 numpy as JAX does; "reinit" takes the sinusoid
    features of 0..new_T-1. A functional embedding, or a table that has
    ``new_T`` rows already, comes back as it is."""
    table = params.get(TABLE)
    if table is None:
        return params
    old_T, d_model = table.shape
    if old_T == new_T:
        return params
    if strategy == "interpolate":
        old = table.detach().cpu().numpy()
        coords = np.linspace(0.0, old_T - 1, new_T)
        lo = np.floor(coords).astype(np.int64)
        hi = np.minimum(lo + 1, old_T - 1)
        frac = (coords - lo)[:, None]
        new_table = torch.from_numpy(
            (old[lo] * (1 - frac) + old[hi] * frac).astype(old.dtype))
    elif strategy == "reinit":
        new_table = sinusoidal_features(torch.arange(new_T), d_model)
    else:
        raise ValueError(f"unknown strategy: {strategy!r}")
    out = OrderedDict(params)
    out[TABLE] = new_table.to(dtype=table.dtype, device=table.device)
    return out


def time_embedding_mask(model: torch.nn.Module) -> "OrderedDict":
    """Parameter name -> True for the time embedding's parameters."""
    return OrderedDict((name, name.startswith(PREFIX))
                       for name, _ in model.named_parameters())


def freeze_except_time_embedding(model: torch.nn.Module) -> list:
    """Stop every parameter outside the time embedding from requiring a
    gradient; returns the time embedding's parameters, the ones to build
    the optimizer over."""
    mask = time_embedding_mask(model)
    trained = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trained.append(p)
    if not trained:
        raise ValueError("the model has no time_embedding parameters")
    return trained
