"""Flax parameters -> state dicts for the port's UNet and SmallCNN.

The inverse of the layout maps in ``itsd_tpu/models/torch_convert.py``,
written for the port's module names (which follow the Flax names):

* conv kernels HWIO -> OIHW;
* the transpose-conv kernel ``up_*_us/t/kernel`` ``(kh, kw, in, out)`` ->
  torch's ``(in, out, kh, kw)``, with no flip: the Flax module flips the
  kernel itself to compute ``ConvTranspose2d`` (``itsd_tpu/models/
  unet.py:TorchConvTranspose2d``);
* Dense kernels ``(in, out)`` -> ``(out, in)``;
* GroupNorm ``scale``/``bias`` -> ``weight``/``bias``;
* the embedding tables ``time_embedding/table`` and ``cond_embedding/table``
  as they are.

Takes the Flax tree as nested dicts of numpy arrays (optionally under a
top-level ``"params"``), so it needs no JAX. Raises on a missing key, an
extra key or a shape that does not fit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from .classifier import ClassifierConfig, SmallCNN
from .unet import UNet, UNetConfig


def _leaves(tree: Mapping, prefix=()):
    for name, sub in tree.items():
        path = prefix + (str(name),)
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path)
        else:
            yield path, np.asarray(sub)


def _torch_entry(path, arr):
    *mod, leaf = path
    base = ".".join(mod)
    if leaf == "kernel":
        if arr.ndim == 4 and mod[-1] == "t":    # transpose conv -> IOHW
            return f"{base}.weight", arr.transpose(2, 3, 0, 1)
        if arr.ndim == 4:                       # conv HWIO -> OIHW
            return f"{base}.weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:                       # Dense (in, out) -> (out, in)
            return f"{base}.weight", arr.T
        raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
    if leaf == "scale":                         # GroupNorm scale
        return f"{base}.weight", arr
    if leaf in ("bias", "table"):
        return f"{base}.{leaf}", arr
    raise ValueError(f"{'/'.join(path)}: unknown parameter {leaf!r}")


def expected_shapes(cfg: UNetConfig, module=UNet) -> "OrderedDict":
    """The port's state-dict keys and shapes of ``module(cfg)``, without
    allocating weights."""
    with torch.device("meta"):
        model = module(cfg)
    return OrderedDict((k, tuple(v.shape))
                       for k, v in model.state_dict().items())


def _convert(params: Mapping, want: "OrderedDict", who: str) -> "OrderedDict":
    if set(params) == {"params"}:
        params = params["params"]
    got = dict(_torch_entry(p, a) for p, a in _leaves(params))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{who}: missing {missing}, extra {extra}")
    out = OrderedDict()
    for key, shape in want.items():
        arr = got[key]
        if tuple(arr.shape) != shape:
            raise ValueError(f"{who}: {key} has shape {tuple(arr.shape)}, "
                             f"the model wants {shape}")
        out[key] = torch.from_numpy(
            np.ascontiguousarray(arr.astype(np.float32)))
    return out


def params_from_jax(params: Mapping, cfg: UNetConfig) -> "OrderedDict":
    """Convert a Flax UNet parameter tree into the port's state dict
    (float32 CPU tensors)."""
    return _convert(params, expected_shapes(cfg), "params_from_jax")


def classifier_params_from_jax(params: Mapping,
                               cfg: ClassifierConfig) -> "OrderedDict":
    """Convert a Flax SmallCNN parameter tree (``conv{i}a``, ``conv{i}b``,
    ``head``) into the port's SmallCNN state dict (float32 CPU
    tensors)."""
    return _convert(params, expected_shapes(cfg, SmallCNN),
                    "classifier_params_from_jax")
