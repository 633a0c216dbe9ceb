"""Feature extractors for FID, IS, CLIP tracking and the verifiers.

Counterpart of ``itsd_tpu/metrics/features.py``. In order of preference:

1. Pretrained Inception-V3: a torchvision ``.pth`` at
   ``$ITSD_INCEPTION_WEIGHTS`` or an explicit path; FID values comparable
   to published ones.
2. Inception-V3 with seeded random weights (``inception.
   init_random_params``, seed 42): a proxy whose values are stable and
   discriminative, but comparable only with themselves.
3. Pooled-pixel features (``$ITSD_PIXEL_FEATURES=1``): no network.

Extractors take images NHWC in [0, 1] on their device and return tensors
there. One Inception forward serves both the FID features and the IS
logits: ``make_inception_extractors``' two functions share it through
``run_both``.

Unlike the JAX package, ``default_extractors`` does not fall back to
pixels when Inception fails to build or load: the error propagates.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Callable, Optional, Tuple

import torch

from .clip import CLIPModel, load_clip, model_image_size
from .clip import preprocess as clip_preprocess
from .inception import (InceptionV3, inception_from_state_dict,
                        init_random_params, load_torchvision_inception)

FeatureFn = Callable[[torch.Tensor], torch.Tensor]

INCEPTION_ENV = "ITSD_INCEPTION_WEIGHTS"
CLIP_ENV = "ITSD_CLIP_WEIGHTS"
PIXEL_ENV = "ITSD_PIXEL_FEATURES"
RANDOM_SEED = 42


@functools.lru_cache(maxsize=2)
def _inception(weights_path: Optional[str], device: str
               ) -> Tuple[InceptionV3, str]:
    if weights_path:
        model, provenance = load_torchvision_inception(weights_path), \
            "pretrained"
    else:
        model = inception_from_state_dict(init_random_params(
            torch.Generator().manual_seed(RANDOM_SEED)))
        provenance = "random"
    return model.to(device), provenance


def make_inception_extractors(weights_path: Optional[str] = None,
                              device="cuda"
                              ) -> Tuple[FeatureFn, FeatureFn, str]:
    """(feature_fn [B, 2048], logit_fn [B, 1000], provenance) of Inception
    at ``weights_path`` or ``$ITSD_INCEPTION_WEIGHTS``, else the seeded
    random-weight proxy (with a warning). Both functions carry
    ``run_both(images) -> (features, logits)``, one forward for both."""
    weights_path = weights_path or os.environ.get(INCEPTION_ENV) or None
    model, provenance = _inception(weights_path, str(torch.device(device)))
    if provenance == "random":
        print("WARNING: FID/IS use a RANDOM-weight Inception-V3 (no "
              f"pretrained weights; set ${INCEPTION_ENV} to a torchvision "
              ".pth). Values are stable and ordering-discriminative but NOT "
              "comparable to published FID/IS numbers.", file=sys.stderr)

    def run_both(images: torch.Tensor):
        return model(images.float())

    def feature_fn(images):
        return run_both(images)[0]

    def logit_fn(images):
        return run_both(images)[1]

    feature_fn.run_both = logit_fn.run_both = run_both
    return feature_fn, logit_fn, provenance


def pixel_feature_fn(pool_hw: int = 8) -> FeatureFn:
    """Pooled-pixel features: no weights needed."""
    from ..search.verifiers import adaptive_avg_pool

    def feature_fn(images):
        return adaptive_avg_pool(images, pool_hw).reshape(
            images.shape[0], -1)

    return feature_fn


def clip_image_feature_fn(model: CLIPModel,
                          normalize: bool = True) -> FeatureFn:
    """Projected CLIP image features of images in [0, 1] (bicubic to the
    tower's size, CLIP-normalised unless ``normalize`` is false), float32,
    on ``model``'s device."""
    size = model_image_size(model)

    def feature_fn(images):
        return model.image_features(
            clip_preprocess(images.float(), size, normalize=normalize))

    return feature_fn


def make_clip_feature_fn(weights_path: Optional[str] = None,
                         device="cuda") -> Optional[FeatureFn]:
    """CLIP image-feature extractor from a HuggingFace ``CLIPModel`` state
    dict at ``weights_path`` or ``$ITSD_CLIP_WEIGHTS``; None when neither
    names one (CLIP tracking then stays off)."""
    weights_path = weights_path or os.environ.get(CLIP_ENV) or None
    if not weights_path:
        return None
    return clip_image_feature_fn(load_clip(weights_path).to(device))


def default_extractors(prefer_inception: bool = True, device="cuda"):
    """(feature_fn, logit_fn, provenance): Inception (pretrained, else the
    random-weight proxy), or with ``$ITSD_PIXEL_FEATURES=1`` or
    ``prefer_inception=False`` pooled pixels and no logits."""
    if os.environ.get(PIXEL_ENV) == "1":
        prefer_inception = False
    if prefer_inception:
        return make_inception_extractors(device=device)
    return pixel_feature_fn(), None, "pixel"
