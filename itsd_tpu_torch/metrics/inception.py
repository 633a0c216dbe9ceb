"""Inception-V3 for FID features and IS logits.

Counterpart of ``itsd_tpu/metrics/inception.py``: torchvision's
Inception-V3 topology for inference (BatchNorm on its running statistics,
eps 1e-3; no auxiliary head), with torchvision's module and parameter
names, so that a torchvision ``inception_v3`` state dict loads with
``load_state_dict`` and no ``torchvision``. The JAX package pads each
stride-1 convolution "SAME" (a 1x7 kernel (0, 3)) and the strided ones and
those JAX marks so "VALID", as torchvision does; its 3x3 average pool
counts the padding.

The call surface is the JAX package's: images NHWC in [0, 1] go through
``preprocess`` (bilinear to 299 as ``jax.image.resize`` computes it, then
ImageNet normalisation) and the network; ``(features [B, 2048],
logits [B, 1000] or None)`` come out. The layout turns NCHW once, at the
module's edge.

``init_random_params`` draws the same shapes and scales as JAX's (kernels
N(0, 2/fan_in), fc N(0, 0.01^2)) from a torch generator: JAX draws them
from threefry, which torch cannot reproduce, so the random-weight proxy's
FID values differ from JAX's by design.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.resize import host_constant, resize

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
SIZE = 299


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3, running stats) -> ReLU,
    torchvision's ``BasicConv2d``. ``same`` pads a stride-1 conv to keep
    its size; otherwise no padding."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, same: bool = True):
        super().__init__()
        kh, kw = kernel
        pad = (kh // 2, kw // 2) if same else (0, 0)
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _conv_specs() -> Dict[str, Tuple[int, int, int, int]]:
    """(kh, kw, cin, cout) of every BasicConv2d, keyed by its dotted path,
    in the JAX package's order (``inception.py:_inception_conv_specs``)."""
    s: Dict[str, Tuple[int, int, int, int]] = {
        "Conv2d_1a_3x3": (3, 3, 3, 32),
        "Conv2d_2a_3x3": (3, 3, 32, 32),
        "Conv2d_2b_3x3": (3, 3, 32, 64),
        "Conv2d_3b_1x1": (1, 1, 64, 80),
        "Conv2d_4a_3x3": (3, 3, 80, 192),
    }

    def add_a(name, cin, pool):
        s[f"{name}.branch1x1"] = (1, 1, cin, 64)
        s[f"{name}.branch5x5_1"] = (1, 1, cin, 48)
        s[f"{name}.branch5x5_2"] = (5, 5, 48, 64)
        s[f"{name}.branch3x3dbl_1"] = (1, 1, cin, 64)
        s[f"{name}.branch3x3dbl_2"] = (3, 3, 64, 96)
        s[f"{name}.branch3x3dbl_3"] = (3, 3, 96, 96)
        s[f"{name}.branch_pool"] = (1, 1, cin, pool)
        return 64 + 64 + 96 + pool

    def add_b(name, cin):
        s[f"{name}.branch3x3"] = (3, 3, cin, 384)
        s[f"{name}.branch3x3dbl_1"] = (1, 1, cin, 64)
        s[f"{name}.branch3x3dbl_2"] = (3, 3, 64, 96)
        s[f"{name}.branch3x3dbl_3"] = (3, 3, 96, 96)
        return 384 + 96 + cin

    def add_c(name, cin, c7):
        s[f"{name}.branch1x1"] = (1, 1, cin, 192)
        s[f"{name}.branch7x7_1"] = (1, 1, cin, c7)
        s[f"{name}.branch7x7_2"] = (1, 7, c7, c7)
        s[f"{name}.branch7x7_3"] = (7, 1, c7, 192)
        s[f"{name}.branch7x7dbl_1"] = (1, 1, cin, c7)
        s[f"{name}.branch7x7dbl_2"] = (7, 1, c7, c7)
        s[f"{name}.branch7x7dbl_3"] = (1, 7, c7, c7)
        s[f"{name}.branch7x7dbl_4"] = (7, 1, c7, c7)
        s[f"{name}.branch7x7dbl_5"] = (1, 7, c7, 192)
        s[f"{name}.branch_pool"] = (1, 1, cin, 192)
        return 192 * 4

    def add_d(name, cin):
        s[f"{name}.branch3x3_1"] = (1, 1, cin, 192)
        s[f"{name}.branch3x3_2"] = (3, 3, 192, 320)
        s[f"{name}.branch7x7x3_1"] = (1, 1, cin, 192)
        s[f"{name}.branch7x7x3_2"] = (1, 7, 192, 192)
        s[f"{name}.branch7x7x3_3"] = (7, 1, 192, 192)
        s[f"{name}.branch7x7x3_4"] = (3, 3, 192, 192)
        return 320 + 192 + cin

    def add_e(name, cin):
        s[f"{name}.branch1x1"] = (1, 1, cin, 320)
        s[f"{name}.branch3x3_1"] = (1, 1, cin, 384)
        s[f"{name}.branch3x3_2a"] = (1, 3, 384, 384)
        s[f"{name}.branch3x3_2b"] = (3, 1, 384, 384)
        s[f"{name}.branch3x3dbl_1"] = (1, 1, cin, 448)
        s[f"{name}.branch3x3dbl_2"] = (3, 3, 448, 384)
        s[f"{name}.branch3x3dbl_3a"] = (1, 3, 384, 384)
        s[f"{name}.branch3x3dbl_3b"] = (3, 1, 384, 384)
        s[f"{name}.branch_pool"] = (1, 1, cin, 192)
        return 320 + 768 + 768 + 192

    c = add_a("Mixed_5b", 192, 32)
    c = add_a("Mixed_5c", c, 64)
    c = add_a("Mixed_5d", c, 64)
    c = add_b("Mixed_6a", c)
    c = add_c("Mixed_6b", c, 128)
    c = add_c("Mixed_6c", c, 160)
    c = add_c("Mixed_6d", c, 160)
    c = add_c("Mixed_6e", c, 192)
    c = add_d("Mixed_7a", c)
    c = add_e("Mixed_7b", c)
    c = add_e("Mixed_7c", c)
    if c != 2048:
        raise AssertionError(f"Inception-V3 ends with {c} channels")
    return s


# the convolutions JAX pads "VALID" (all of them strided but Conv2d_2a/4a)
_VALID = {"Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_4a_3x3",
          "Mixed_6a.branch3x3", "Mixed_6a.branch3x3dbl_3",
          "Mixed_7a.branch3x3_2", "Mixed_7a.branch7x7x3_4"}
_STRIDE2 = _VALID - {"Conv2d_2a_3x3", "Conv2d_4a_3x3"}


class _Block(nn.Module):
    """One Mixed block: its BasicConv2d branches, named as torchvision
    names them; ``forward`` wires them as the block's kind does."""

    def __init__(self, name: str, kind: str, specs: dict):
        super().__init__()
        self.kind = kind
        for path, (kh, kw, cin, cout) in specs.items():
            block, _, branch = path.partition(".")
            if block == name:
                self.add_module(branch, BasicConv2d(
                    cin, cout, (kh, kw), stride=2 if path in _STRIDE2 else 1,
                    same=path not in _VALID))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self._modules
        if self.kind == "a":
            return torch.cat([
                b["branch1x1"](x),
                b["branch5x5_2"](b["branch5x5_1"](x)),
                b["branch3x3dbl_3"](b["branch3x3dbl_2"](
                    b["branch3x3dbl_1"](x))),
                b["branch_pool"](_avg_pool_3x3_same(x))], 1)
        if self.kind == "b":
            return torch.cat([
                b["branch3x3"](x),
                b["branch3x3dbl_3"](b["branch3x3dbl_2"](
                    b["branch3x3dbl_1"](x))),
                _max_pool(x)], 1)
        if self.kind == "c":
            b7 = x
            for n in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
                b7 = b[n](b7)
            bd = x
            for i in range(1, 6):
                bd = b[f"branch7x7dbl_{i}"](bd)
            return torch.cat([b["branch1x1"](x), b7, bd,
                              b["branch_pool"](_avg_pool_3x3_same(x))], 1)
        if self.kind == "d":
            b3 = b["branch3x3_2"](b["branch3x3_1"](x))
            b7 = x
            for i in range(1, 5):
                b7 = b[f"branch7x7x3_{i}"](b7)
            return torch.cat([b3, b7, _max_pool(x)], 1)
        b3 = b["branch3x3_1"](x)
        b3 = torch.cat([b["branch3x3_2a"](b3), b["branch3x3_2b"](b3)], 1)
        bd = b["branch3x3dbl_2"](b["branch3x3dbl_1"](x))
        bd = torch.cat([b["branch3x3dbl_3a"](bd), b["branch3x3dbl_3b"](bd)], 1)
        return torch.cat([b["branch1x1"](x), b3, bd,
                          b["branch_pool"](_avg_pool_3x3_same(x))], 1)


_BLOCK_KIND = {
    "Mixed_5b": "a", "Mixed_5c": "a", "Mixed_5d": "a",
    "Mixed_6a": "b",
    "Mixed_6b": "c", "Mixed_6c": "c", "Mixed_6d": "c", "Mixed_6e": "c",
    "Mixed_7a": "d",
    "Mixed_7b": "e", "Mixed_7c": "e",
}
_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
         "Conv2d_3b_1x1", "Conv2d_4a_3x3")


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] in [0,1] -> bilinear 299x299 (``jax.image.resize``'s
    weights, antialiased when shrinking) + ImageNet normalisation, NHWC."""
    B, H, W, C = images.shape
    if (H, W) != (SIZE, SIZE):
        images = resize(images, SIZE, SIZE, "linear")
    return ((images - host_constant(IMAGENET_MEAN, images))
            / host_constant(IMAGENET_STD, images))


class InceptionV3(nn.Module):
    """torchvision's Inception-V3 for inference, without the auxiliary
    head; ``include_fc=False`` drops the classifier as well."""

    def __init__(self, include_fc: bool = True):
        super().__init__()
        specs = _conv_specs()
        for name in _STEM:
            kh, kw, cin, cout = specs[name]
            stride = 2 if name in _STRIDE2 else 1
            self.add_module(name, BasicConv2d(cin, cout, (kh, kw), stride,
                                              same=name not in _VALID))
        for name, kind in _BLOCK_KIND.items():
            self.add_module(name, _Block(name, kind, specs))
        self.fc = nn.Linear(2048, 1000) if include_fc else None
        self.eval()

    def forward(self, images: torch.Tensor, return_logits: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Images [B,H,W,3] in [0,1] -> (features [B, 2048], logits
        [B, 1000] or None)."""
        x = preprocess(images).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in _BLOCK_KIND:
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        logits = None
        if return_logits and self.fc is not None:
            logits = self.fc(feats)
        return feats, logits


def init_random_params(generator: torch.Generator,
                       include_fc: bool = True) -> "OrderedDict":
    """A state dict with the production shapes: each conv kernel
    N(0, 2/fan_in), BatchNorm the identity (scale 1, bias 0, mean 0,
    var 1), fc N(0, 0.01^2) with bias 0, drawn from ``generator`` in the
    JAX package's order (every conv, then fc)."""
    sd = OrderedDict()
    for path, (kh, kw, cin, cout) in _conv_specs().items():
        sd[f"{path}.conv.weight"] = (
            torch.randn((kh, kw, cin, cout), generator=generator)
            * (2.0 / (kh * kw * cin)) ** 0.5).permute(3, 2, 0, 1).contiguous()
        sd[f"{path}.bn.weight"] = torch.ones(cout)
        sd[f"{path}.bn.bias"] = torch.zeros(cout)
        sd[f"{path}.bn.running_mean"] = torch.zeros(cout)
        sd[f"{path}.bn.running_var"] = torch.ones(cout)
        sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
    if include_fc:
        sd["fc.weight"] = (torch.randn((2048, 1000), generator=generator)
                           * 0.01).T.contiguous()
        sd["fc.bias"] = torch.zeros(1000)
    return sd


def inception_from_state_dict(sd: dict, include_fc: bool = True
                              ) -> InceptionV3:
    """An ``InceptionV3`` holding a torchvision-layout state dict; the
    auxiliary head's keys (``AuxLogits.*``) are dropped, and fc too when
    ``include_fc`` is false or the dict has none."""
    sd = {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}
    include_fc = include_fc and "fc.weight" in sd
    if not include_fc:
        sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    model = InceptionV3(include_fc=include_fc)
    model.load_state_dict(sd)
    return model.requires_grad_(False)


def load_torchvision_inception(path: str, include_fc: bool = True
                               ) -> InceptionV3:
    """An ``InceptionV3`` from a torchvision ``inception_v3`` ``.pth`` file
    (a state dict, or a module that has one)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return inception_from_state_dict(sd, include_fc)
