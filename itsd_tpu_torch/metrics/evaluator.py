"""Class-style evaluators: FID, IS and CLIPScore.

Counterpart of ``itsd_tpu/metrics/evaluator.py``. Images are NHWC in
[0, 1] (numpy or tensors); features are extracted on the extractor's
device in batches and read back once a batch; the float64 statistics run
on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .features import (clip_image_feature_fn, default_extractors,
                       make_inception_extractors)
from .frechet import compute_fid
from .is_score import inception_score


def _batched(fn, images, batch_size: int, device) -> np.ndarray:
    images = torch.as_tensor(np.asarray(images, dtype=np.float32)
                             if not torch.is_tensor(images) else images)
    outs = []
    with torch.inference_mode():
        for i in range(0, images.shape[0], batch_size):
            x = images[i:i + batch_size].to(device)
            outs.append(fn(x).float().cpu().numpy())
    return np.concatenate(outs)


def load_images(paths, size: Optional[int] = None) -> np.ndarray:
    """Image files -> [N,H,W,3] float32 in [0,1]. All must share a size
    unless ``size`` resizes them (bilinear). Needs Pillow, imported here
    so that the module imports where Pillow is not installed."""
    from PIL import Image

    arrs = []
    for p in paths:
        im = Image.open(p).convert("RGB")
        if size is not None:
            im = im.resize((size, size), Image.BILINEAR)
        arrs.append(np.asarray(im, np.float32) / 255.0)
    if not arrs:
        raise ValueError("no image paths given")
    shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        raise ValueError(f"mixed image sizes {shapes}; pass size= to resize")
    return np.stack(arrs)


class FID:
    """Fréchet Inception Distance. ``feature_fn`` replaces the Inception
    extractor (tests, other feature spaces)."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 64, device="cuda", feature_fn=None):
        if feature_fn is not None:
            self.feature_fn, self.provenance = feature_fn, "custom"
        elif weights_path:
            self.feature_fn, _, self.provenance = make_inception_extractors(
                weights_path, device)
        else:
            self.feature_fn, _, self.provenance = default_extractors(
                device=device)
        self.batch_size = batch_size
        self.device = device

    def get_features(self, images) -> np.ndarray:
        """images [N,H,W,C] in [0,1] -> [N, D] features."""
        return _batched(self.feature_fn, images, self.batch_size,
                        self.device)

    def extract_features(self, image_paths, size: Optional[int] = None):
        return self.get_features(load_images(image_paths, size))

    def compute_fid(self, real_features, fake_features,
                    eps: float = 1e-6) -> float:
        return compute_fid(real_features, fake_features, eps)

    def __call__(self, real_images, fake_images) -> float:
        return self.compute_fid(self.get_features(real_images),
                                self.get_features(fake_images))


class IS:
    """Inception Score with the split protocol (10 splits by default).
    ``logit_fn`` replaces the Inception classifier."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 64, splits: int = 10, device="cuda",
                 logit_fn=None):
        if logit_fn is not None:
            self.logit_fn, self.provenance = logit_fn, "custom"
        elif weights_path:
            _, self.logit_fn, self.provenance = make_inception_extractors(
                weights_path, device)
        else:
            _, self.logit_fn, self.provenance = default_extractors(
                device=device)
        if self.logit_fn is None:
            raise RuntimeError("IS needs a classifier (inception logits)")
        self.batch_size = batch_size
        self.splits = splits
        self.device = device

    def __call__(self, images) -> Tuple[float, float]:
        images = torch.as_tensor(np.asarray(images, dtype=np.float32)
                                 if not torch.is_tensor(images) else images)
        with torch.inference_mode():
            return inception_score(self.logit_fn, images.to(self.device),
                                   splits=self.splits,
                                   batch_size=self.batch_size)


class CLIPScore:
    """CLIP feature similarity and diversity of image sets, from a
    ``CLIPModel`` (``metrics.clip``) or any ``feature_fn``."""

    def __init__(self, clip_model=None, batch_size: int = 64,
                 normalize_images: bool = True, device="cuda",
                 feature_fn=None):
        if feature_fn is None:
            feature_fn = clip_image_feature_fn(clip_model.to(device),
                                               normalize_images)

        def normalised(x):
            f = feature_fn(x)
            return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True)
                        + 1e-8)

        self.feature_fn = normalised
        self.batch_size = batch_size
        self.device = device

    def get_features(self, images) -> np.ndarray:
        return _batched(self.feature_fn, images, self.batch_size,
                        self.device)

    def similarity(self, fake_images, real_features) -> float:
        """Mean fake-real cosine, over every pair."""
        fake = self.get_features(fake_images)
        return float((fake @ np.asarray(real_features).T).mean())

    def diversity(self, fake_images) -> float:
        """1 - the mean pairwise cosine of distinct images."""
        f = self.get_features(fake_images)
        sims = f @ f.T
        n = len(f)
        off = (sims.sum() - np.trace(sims)) / (n * (n - 1))
        return float(1.0 - off)
