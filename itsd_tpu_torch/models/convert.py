"""JAX parameters -> state dicts for the port's UNet, SmallCNN,
Inception-V3 and CLIP.

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

``inception_params_from_jax`` and ``clip_params_from_jax`` convert the
pytrees of the JAX package's functional Inception-V3 and CLIP
(``itsd_tpu/metrics/inception.py``, ``clip.py``) into torchvision's and
HuggingFace's key layouts, which the port's modules carry.
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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def inception_params_from_jax(params: Mapping) -> "OrderedDict":
    """The JAX package's Inception-V3 pytree (each BasicConv2d ``{"kernel":
    HWIO, "bn": {scale, bias, mean, var}}``, blocks nested by name, ``fc``)
    -> the torchvision-layout state dict of ``metrics.inception.
    InceptionV3``."""
    from ..metrics.inception import _conv_specs

    sd = OrderedDict()
    for path in _conv_specs():
        node = params
        for part in path.split("."):
            node = node[part]
        bn = node["bn"]
        sd[f"{path}.conv.weight"] = _f32(
            np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{path}.bn.weight"] = _f32(bn["scale"])
        sd[f"{path}.bn.bias"] = _f32(bn["bias"])
        sd[f"{path}.bn.running_mean"] = _f32(bn["mean"])
        sd[f"{path}.bn.running_var"] = _f32(bn["var"])
        sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
    if "fc" in params:
        sd["fc.weight"] = _f32(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _f32(params["fc"]["bias"])
    return sd


def clip_params_from_jax(params: Mapping) -> "OrderedDict":
    """The JAX package's CLIP pytree (``vision``, ``text``, the
    projections, ``logit_scale``) -> the HuggingFace-layout state dict of
    ``metrics.clip.CLIPModel``. The head counts stay in the pytree
    (``params[tower]["layers"][i]["attn"]["num_heads"]``): pass them to
    ``clip_from_state_dict``."""
    sd = OrderedDict()

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = _f32(p["scale"])
        sd[f"{prefix}.bias"] = _f32(p["bias"])

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _f32(p["bias"])

    def layers(prefix, ps):
        for i, p in enumerate(ps):
            lp = f"{prefix}.encoder.layers.{i}"
            ln(f"{lp}.layer_norm1", p["ln1"])
            ln(f"{lp}.layer_norm2", p["ln2"])
            for name in ("q", "k", "v", "out"):
                dense(f"{lp}.self_attn.{name}_proj", p["attn"][name])
            dense(f"{lp}.mlp.fc1", p["fc1"])
            dense(f"{lp}.mlp.fc2", p["fc2"])

    v, t = params["vision"], params["text"]
    sd["vision_model.embeddings.patch_embedding.weight"] = _f32(
        np.asarray(v["patch_embedding"]).transpose(3, 2, 0, 1))
    sd["vision_model.embeddings.class_embedding"] = _f32(v["class_embedding"])
    sd["vision_model.embeddings.position_embedding.weight"] = _f32(
        v["position_embedding"])
    ln("vision_model.pre_layrnorm", v["pre_ln"])
    layers("vision_model", v["layers"])
    ln("vision_model.post_layernorm", v["post_ln"])
    sd["text_model.embeddings.token_embedding.weight"] = _f32(
        t["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _f32(
        t["position_embedding"])
    layers("text_model", t["layers"])
    ln("text_model.final_layer_norm", t["final_ln"])
    for name in ("visual_projection", "text_projection"):
        if name in params:
            sd[f"{name}.weight"] = _f32(np.asarray(params[name]).T)
    if "logit_scale" in params:
        sd["logit_scale"] = _f32(params["logit_scale"])
    return sd
