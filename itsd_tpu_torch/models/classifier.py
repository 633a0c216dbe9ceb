"""Compact convolutional classifier: the trainable companion of
``search.verifiers.classifier_verifier`` (BASELINE.md workload 3: best-of-N
noise search scored by per-class log-probability).

Counterpart of ``itsd_tpu/models/classifier.py``. The layers follow the
Flax module's names (``conv{i}a``, ``conv{i}b``, ``head``), so a Flax tree
converts with ``models.convert.classifier_params_from_jax``. Flax's
``Conv`` pads "SAME": for a stride-2 3x3 conv on an even size that is 0
rows before and 1 after, not ``padding=1``'s one on each side, so every
conv pads explicitly (``_same_pad``) and runs with ``padding=0``.

Checkpoints are torch state dicts (``save_classifier``); the architecture
is read back from the weights' shapes, as JAX reads it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 10
    ch: int = 32
    depth: int = 3          # number of conv stages (stride-2 each)
    dtype: str = "float32"


def _same_pad(size: int, k: int, s: int):
    """(before, after) padding of XLA's "SAME" along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _SameConv(nn.Conv2d):
    """3x3 conv with Flax's "SAME" padding, computing in its input's
    dtype."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(cin, cout, 3, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        ph = _same_pad(x.shape[2], 3, s)
        pw = _same_pad(x.shape[3], 3, s)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride)


class SmallCNN(nn.Module):
    """conv-swish x2 per stage with stride-2 downsampling, a global-average
    -pool head. Input: NHWC images in [0, 1]; returns float32 logits (and
    the pooled features with ``return_features``)."""

    def __init__(self, cfg: ClassifierConfig = ClassifierConfig()):
        super().__init__()
        self.cfg = cfg
        ch, cin = cfg.ch, 3
        for i in range(cfg.depth):
            self.add_module(f"conv{i}a", _SameConv(cin, ch, 1))
            self.add_module(f"conv{i}b", _SameConv(ch, ch, 2))
            cin, ch = ch, ch * 2
        self.head = nn.Linear(cin, cfg.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform kernels and zero biases, as the Flax module's
        initialisers, drawn from ``generator`` in module order."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                nn.init.xavier_uniform_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        dtype = getattr(torch, self.cfg.dtype)
        h = (x.to(dtype) * 2.0 - 1.0).permute(0, 3, 1, 2)
        for i in range(self.cfg.depth):
            h = F.silu(getattr(self, f"conv{i}a")(h))
            h = F.silu(getattr(self, f"conv{i}b")(h))
        feats = h.mean(dim=(2, 3)).float()
        f = feats.to(dtype)
        logits = F.linear(f, self.head.weight.to(dtype),
                          self.head.bias.to(dtype)).float()
        if return_features:
            return logits, feats
        return logits


def _config_from_params(params: dict) -> ClassifierConfig:
    """The architecture of a SmallCNN state dict: num_classes from the
    head, ch from conv0a, depth from the number of conv stages."""
    depth = sum(1 for k in params if re.fullmatch(r"conv\d+a\.weight", k))
    return ClassifierConfig(num_classes=int(params["head.weight"].shape[0]),
                            ch=int(params["conv0a.weight"].shape[0]),
                            depth=depth)


def train_classifier(images, labels, cfg: Optional[ClassifierConfig] = None,
                     epochs: int = 5, batch_size: int = 128,
                     lr: float = 1e-3, seed: int = 0, device="cuda"):
    """Train SmallCNN on (images [N,H,W,C] in [-1,1] or [0,1], labels [N])
    with AdamW (weight decay 1e-4, optax's default), the batches drawn as
    JAX draws them (a numpy permutation an epoch, ``seed``). Returns
    (logit_fn: the model in eval mode, its weights frozen; params; accuracy
    on the first 512 images)."""
    cfg = cfg or ClassifierConfig()
    images = np.asarray(images, dtype=np.float32)
    if images.min() < -0.01:
        images = (images + 1.0) / 2.0
    labels = np.asarray(labels, dtype=np.int64)
    model = SmallCNN(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model.to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4)

    rng = np.random.default_rng(seed)
    n = len(images)
    batch_size = min(batch_size, n)
    nb = max(1, n // batch_size)
    idx = np.stack([rng.permutation(n)[:nb * batch_size].reshape(
        nb, batch_size) for _ in range(epochs)]).reshape(-1, batch_size)

    xs = torch.from_numpy(images).to(device)
    ys = torch.from_numpy(labels).to(device)
    steps = torch.from_numpy(idx).to(device)
    for batch_idx in steps:
        x, y = xs[batch_idx], ys[batch_idx]
        loss = F.cross_entropy(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    model.eval()
    with torch.no_grad():
        preds = model(xs[:512]).argmax(-1)
    acc = float((preds == ys[:512]).float().mean())
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return model.requires_grad_(False), params, acc


def save_classifier(path: str, params) -> None:
    """Weights-only checkpoint that a CLI search loads
    (``search.verifier=classifier search.classifier_ckpt=...``)."""
    from ..train.checkpoint import save_params
    save_params(path, params)


def load_classifier(path: str, device="cuda"):
    """Restore a SmallCNN checkpoint, its architecture inferred from the
    weights. Returns (logit_fn, params, cfg); the logit_fn is the model in
    eval mode, its weights frozen."""
    from ..train.checkpoint import restore_params

    params = restore_params(path)
    cfg = _config_from_params(params)
    model = SmallCNN(cfg)
    model.load_state_dict(params)
    return model.to(device).eval().requires_grad_(False), params, cfg


def load_classifier_extractors(path: str, device="cuda"):
    """(feature_fn, logit_fn, provenance) of a SmallCNN checkpoint: the
    pooled penultimate features (a dataset-specific FID-proxy space) and
    the logits (Inception-Score-style tracking). Not comparable to
    Inception-based IS or FID."""
    model, _, cfg = load_classifier(path, device)

    def feature_fn(images):
        return model(images, return_features=True)[1]

    provenance = (f"classifier:{path} ({cfg.num_classes}-class SmallCNN, "
                  "dataset-specific — not comparable to Inception IS/FID)")
    return feature_fn, model, provenance
