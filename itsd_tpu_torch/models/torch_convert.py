"""Load the reference's PyTorch UNet checkpoints into the port's UNet.

Counterpart of ``itsd_tpu/models/torch_convert.py``: state dicts of the
reference's ``Diffusion/Model.py`` UNet and ``DiffusionFreeGuidence/
ModelCondition.py`` UNet, with DataParallel's ``module.`` prefix stripped,
become the port's state dict. Both are PyTorch, so only the names change,
and the 1x1 convolutions of the shortcut and the attention projections
(``[out, in, 1, 1]``) become the port's Dense weights (``[out, in]``). The
flat ``downblocks.{i}`` / ``upblocks.{i}`` indices are mapped onto the
port's named blocks by walking the reference constructors' order, as JAX's
``convert_reference_unet`` does. Keys of the reference's state dict that
the UNet does not use are ignored, as there.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from .convert import expected_shapes
from .unet import UNetConfig


def strip_module_prefix(sd: Dict[str, torch.Tensor]) -> Dict:
    """Remove DataParallel's ``module.`` prefix from every key that has
    it."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def _resblock(ref: str, port: str, conditional: bool, shortcut: bool,
              attn: bool) -> List[Tuple[str, str, bool]]:
    """(reference module, port module, is a 1x1 conv) of one ResBlock."""
    mods = [(f"{ref}.block1.0", f"{port}.norm1", False),
            (f"{ref}.block1.2", f"{port}.conv1", False),
            (f"{ref}.temb_proj.1", f"{port}.temb_proj", False),
            (f"{ref}.block2.0", f"{port}.norm2", False),
            (f"{ref}.block2.3", f"{port}.conv2", False)]
    if conditional:
        mods.append((f"{ref}.cond_proj.1", f"{port}.cond_proj", False))
    if shortcut:
        mods.append((f"{ref}.shortcut", f"{port}.shortcut", True))
    if attn:
        mods += [(f"{ref}.attn.group_norm", f"{port}.attn.norm", False)] + [
            (f"{ref}.attn.{r}", f"{port}.attn.{p}", True)
            for r, p in (("proj_q", "q"), ("proj_k", "k"), ("proj_v", "v"),
                         ("proj", "proj"))]
    return mods


def reference_modules(cfg: UNetConfig) -> List[Tuple[str, str, bool]]:
    """Every (reference module, port module, is a 1x1 conv) of the UNet
    ``cfg`` describes, in the reference constructors' order
    (``Model.py:212-257``, ``ModelCondition.py:164-203``)."""
    mods = []
    if cfg.time_embed == "functional":
        mods += [("time_embedding.timembedding.0", "time_embedding.mlp.fc1",
                  False),
                 ("time_embedding.timembedding.2", "time_embedding.mlp.fc2",
                  False)]
    else:
        mods += [("time_embedding.timembedding.1", "time_embedding.mlp.fc1",
                  False),
                 ("time_embedding.timembedding.3", "time_embedding.mlp.fc2",
                  False)]
    if cfg.conditional:
        mods += [("cond_embedding.condEmbedding.1", "cond_embedding.mlp.fc1",
                  False),
                 ("cond_embedding.condEmbedding.3", "cond_embedding.mlp.fc2",
                  False)]
    mods.append(("head", "head", False))
    chs, idx, now = [cfg.ch], 0, cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            mods += _resblock(f"downblocks.{idx}", f"down_{i}_{j}",
                              cfg.conditional, now != out,
                              cfg.down_attn_all or i in cfg.attn)
            now = out
            chs.append(now)
            idx += 1
        if i != len(cfg.ch_mult) - 1:
            ds = f"downblocks.{idx}"
            mods += ([(f"{ds}.main", f"down_{i}_ds.c1", False)]
                     if cfg.down_type == "conv" else
                     [(f"{ds}.c1", f"down_{i}_ds.c1", False),
                      (f"{ds}.c2", f"down_{i}_ds.c2", False)])
            chs.append(now)
            idx += 1
    mods += _resblock("middleblocks.0", "mid_0", cfg.conditional, False, True)
    mods += _resblock("middleblocks.1", "mid_1", cfg.conditional, False,
                      False)
    idx = 0
    for i, mult in reversed(list(enumerate(cfg.ch_mult))):
        out = cfg.ch * mult
        for j in range(cfg.num_res_blocks + 1):
            cin = chs.pop() + now
            mods += _resblock(f"upblocks.{idx}", f"up_{i}_{j}",
                              cfg.conditional, cin != out,
                              cfg.up_attn and i in cfg.attn)
            now = out
            idx += 1
        if i != 0:
            us = f"upblocks.{idx}"
            mods += ([(f"{us}.main", f"up_{i}_us.c", False)]
                     if cfg.up_type == "nearest_conv" else
                     [(f"{us}.t", f"up_{i}_us.t", False),
                      (f"{us}.c", f"up_{i}_us.c", False)])
            idx += 1
    mods += [("tail.0", "tail_norm", False), ("tail.2", "tail_conv", False)]
    return mods


def convert_reference_unet(sd: Dict[str, torch.Tensor],
                           cfg: UNetConfig) -> "OrderedDict":
    """A reference UNet state dict -> the port's UNet state dict (float32
    CPU tensors, in the model's order). Raises KeyError naming the
    reference keys it lacks, ValueError on a shape the model does not
    take."""
    sd = strip_module_prefix(sd)
    want = []
    if cfg.time_embed == "table":
        want.append(("time_embedding.timembedding.0.weight",
                     "time_embedding.table", False))
    if cfg.conditional:
        want.append(("cond_embedding.condEmbedding.0.weight",
                     "cond_embedding.table", False))
    for ref, port, one_by_one in reference_modules(cfg):
        want += [(f"{ref}.weight", f"{port}.weight", one_by_one),
                 (f"{ref}.bias", f"{port}.bias", False)]
    missing = [ref for ref, _, _ in want if ref not in sd]
    if missing:
        raise KeyError(f"convert_reference_unet: missing {missing}")
    got = {}
    for ref, port, one_by_one in want:
        t = sd[ref].detach().to("cpu", torch.float32)
        got[port] = (t[:, :, 0, 0] if one_by_one else t).contiguous()
    out = OrderedDict()
    for key, shape in expected_shapes(cfg).items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"convert_reference_unet: {key} has shape "
                             f"{tuple(got[key].shape)}, the model wants "
                             f"{shape}")
        out[key] = got[key]
    return out


def load_reference_checkpoint(path: str, cfg: UNetConfig) -> "OrderedDict":
    """A ``.pt`` file the reference's loops saved (a bare state dict or
    ``{"state_dict": ...}``) -> the port's UNet state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_reference_unet(sd, cfg)
