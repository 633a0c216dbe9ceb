"""Verifiers: score generated images on the device.

Counterpart of ``itsd_tpu/search/verifiers.py``. A verifier is any callable
``(images [B,H,W,C] in [-1,1]) -> scalar tensor`` (higher is better),
differentiable in the images, so that gradient search can climb it; the
factories close over their conditioning and feature extractors. No
verifier reads a value back to the host, except ``make_fid_proxy``'s
proxy, which is a host metric by design.

  oracle_verifier          -FID of the batch's features against dataset
                           stats, or the inverse-variance heuristic
  supervised_verifier      cosine of image features with condition features
  clip_score_verifier      the same with text features
  self_supervised_verifier pooled-pixel cosine
  aesthetic_score          diversity + contrast heuristic
  integrated_verifier      a weighted ensemble
  ensemble_fid_is_verifier -FID + w * IS from one Inception-style forward
  classifier_verifier      mean log-probability of target classes
  make_fid_proxy           an independent pooled-pixel Fréchet proxy
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..metrics.frechet import (frechet_distance, frechet_distance_torch,
                               gaussian_stats)
from ..metrics.is_score import is_score
from ..utils.resize import resize_weights

# feature_fn(images [B,H,W,C] in [0,1]) -> [B, D] features
FeatureFn = Callable[[torch.Tensor], torch.Tensor]


def to_unit_range(images: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> [0,1], clamped."""
    return ((images + 1.0) / 2.0).clamp(0.0, 1.0)


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-8)


def adaptive_avg_pool(images: torch.Tensor, out_hw: int = 8) -> torch.Tensor:
    """Adaptive average pool of NHWC ``images`` to (out_hw, out_hw): block
    means when out_hw divides H and W, else JAX's antialiased linear resize
    (``jax.image.resize(..., "linear")``), as separable weight matrices."""
    B, H, W, C = images.shape
    if H % out_hw == 0 and W % out_hw == 0:
        x = images.reshape(B, out_hw, H // out_hw, out_hw, W // out_hw, C)
        return x.mean(dim=(2, 4))
    wh, ww = (torch.from_numpy(resize_weights(n, out_hw)).to(
        device=images.device, dtype=images.dtype) for n in (H, W))
    return torch.einsum("bhwc,hi,wj->bijc", images, wh, ww)


# ---------------------------------------------------------------------------
# Oracle


def batch_pixel_variance_score(images: torch.Tensor) -> torch.Tensor:
    """1 / (1 + mean per-image pixel variance, ddof 1)."""
    flat = images.reshape(images.shape[0], -1)
    variance = torch.var(flat, dim=1, correction=1).mean()
    return 1.0 / (1.0 + variance)


def oracle_verifier(dataset_stats: Optional[dict] = None,
                    feature_fn: Optional[FeatureFn] = None):
    """With (mu, sigma) stats and a feature extractor: -FID of the batch's
    features (biased covariance) against the stats. Without either: the
    inverse-variance heuristic."""
    if dataset_stats is None or feature_fn is None:
        return batch_pixel_variance_score

    mu_r = torch.as_tensor(dataset_stats["mu"], dtype=torch.float32)
    sigma_r = torch.as_tensor(dataset_stats["sigma"], dtype=torch.float32)

    def score(images: torch.Tensor) -> torch.Tensor:
        feats = feature_fn(to_unit_range(images))
        mu_f = feats.mean(dim=0)
        d = feats - mu_f
        sigma_f = (d.T @ d) / feats.shape[0]
        return -frechet_distance_torch(mu_r.to(feats.device),
                                       sigma_r.to(feats.device), mu_f,
                                       sigma_f)

    return score


# ---------------------------------------------------------------------------
# Supervised / CLIP-style


def supervised_verifier(feature_fn: FeatureFn,
                        condition_features: Optional[torch.Tensor] = None):
    """Mean cosine of image features with condition features ([B,D] or
    [D]); with no condition, the mean feature norm."""
    def score(images: torch.Tensor) -> torch.Tensor:
        feats = feature_fn(to_unit_range(images))
        if condition_features is None:
            return torch.linalg.vector_norm(feats, dim=-1).mean()
        f = _l2_normalize(feats)
        c = _l2_normalize(torch.as_tensor(condition_features).to(feats))
        if c.dim() == 1:
            c = c[None, :]
        return (f * c).sum(dim=-1).mean()

    return score


def clip_score_verifier(image_feature_fn: FeatureFn,
                        text_features: torch.Tensor):
    """Mean cosine of image features with precomputed text features."""
    return supervised_verifier(image_feature_fn, text_features)


def self_supervised_verifier(
        reference_features: Optional[torch.Tensor] = None,
        pool_hw: int = 8):
    """Cosine of pooled-pixel features with ``reference_features``, or,
    without them, the batch's mean pairwise off-diagonal self-similarity."""
    def extract(images: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(images, pool_hw).reshape(
            images.shape[0], -1)

    def score(images: torch.Tensor) -> torch.Tensor:
        feats = _l2_normalize(extract(images))
        if reference_features is not None:
            ref = _l2_normalize(
                torch.as_tensor(reference_features).to(feats))
            return (feats * ref).sum(dim=-1).mean()
        sim = feats @ feats.T
        n = sim.shape[0]
        off = sim - torch.eye(n, dtype=sim.dtype, device=sim.device) * sim
        return off.sum() / (n * (n - 1))

    return score


# ---------------------------------------------------------------------------
# Aesthetic / ensemble


def aesthetic_score(images: torch.Tensor) -> torch.Tensor:
    """Color diversity + contrast, both the per-image std (ddof 1) over the
    flattened pixels in [0,1]: 2 * the mean std."""
    x = to_unit_range(images)
    flat = x.reshape(x.shape[0], -1)
    std = torch.std(flat, dim=1, correction=1).mean()
    return std + std


def integrated_verifier(verifiers: Dict[str, Callable],
                        weights: Optional[Dict[str, float]] = None):
    """Weighted sum of ``verifiers``; ``weights=None`` weighs them
    uniformly."""
    if weights is None:
        weights = {k: 1.0 / len(verifiers) for k in verifiers}
    missing = set(weights) - set(verifiers)
    if missing:
        raise ValueError(f"weights for unknown verifiers: {missing}")

    def score(images: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for name, w in weights.items():
            total = total + w * verifiers[name](images)
        return total

    return score


def reference_integrated_weights() -> Dict[str, float]:
    return {"aesthetic": 0.4, "clip": 0.4, "image_reward": 0.2}


def ensemble_fid_is_verifier(inception_run_fn, real_features,
                             is_weight: float = 10.0, proj_dim: int = 256,
                             seed: int = 7,
                             proj: Optional[torch.Tensor] = None):
    """-FID + is_weight * IS from one forward of ``inception_run_fn(images
    in [0,1]) -> (feats [B,D], logits [B,K])``. The Fréchet term runs on a
    ``proj_dim``-d random projection of the features (ordering is what a
    verifier needs). ``proj`` [D, proj_dim] is the projection; by default
    it is drawn from a torch generator seeded with ``seed`` (JAX draws it
    from threefry, which torch cannot reproduce, so a test passes JAX's
    matrix in)."""
    real = torch.as_tensor(real_features, dtype=torch.float32)
    d_in = real.shape[-1]
    if proj is None:
        g = torch.Generator().manual_seed(seed)
        proj = torch.randn((d_in, proj_dim), generator=g) / d_in ** 0.5
    proj = torch.as_tensor(proj, dtype=torch.float32).to(real.device)
    eye = torch.eye(proj.shape[1], device=real.device)
    rf = real @ proj
    mu_r = rf.mean(dim=0)
    cov_r = torch.cov(rf.T) + 1e-4 * eye

    def score(images: torch.Tensor) -> torch.Tensor:
        feats, logits = inception_run_fn(to_unit_range(images))
        p = proj.to(feats.device)
        f = feats @ p
        mu_f = f.mean(dim=0)
        cov_f = torch.cov(f.T) + 1e-4 * eye.to(f.device)
        fid = frechet_distance_torch(mu_r.to(f.device), cov_r.to(f.device),
                                     mu_f, cov_f)
        is_v = is_score(torch.softmax(logits, dim=-1))
        return -fid + is_weight * is_v

    return score


# ---------------------------------------------------------------------------
# Classifier-based (BASELINE.md workload 3)


def classifier_verifier(logit_fn: Callable[[torch.Tensor], torch.Tensor],
                        target_labels: torch.Tensor):
    """Mean log-probability of ``target_labels`` [B] under a classifier
    ``logit_fn(images in [0,1]) -> [B, K]``."""
    targets = torch.as_tensor(target_labels, dtype=torch.int64)

    def score(images: torch.Tensor) -> torch.Tensor:
        logits = logit_fn(to_unit_range(images))
        logp = torch.log_softmax(logits, dim=-1)
        tgt = targets.to(logp.device)
        return logp.gather(-1, tgt[:, None]).mean()

    return score


# ---------------------------------------------------------------------------
# Independent cheap quality proxy (verifier-hacking checks)


def make_fid_proxy(real_images, pool_hw: int = 8):
    """Pooled-pixel Fréchet proxy: ``real_images`` in [-1, 1] anchor the
    stats; the returned callable maps an image batch in [-1, 1] to a float
    distance, computed on the host. Independent of every search verifier
    (pixels, not learned features), so that it shows verifier
    over-optimisation ("verifier hacking"; ``search.guard_proxy``)."""
    def feats(images) -> np.ndarray:
        unit = to_unit_range(torch.as_tensor(images, dtype=torch.float32))
        return (adaptive_avg_pool(unit, pool_hw).reshape(unit.shape[0], -1)
                .detach().cpu().numpy())

    mu_r, sig_r = gaussian_stats(feats(real_images))

    def proxy(images) -> float:
        mu, sig = gaussian_stats(feats(images))
        return float(frechet_distance(mu_r, sig_r, mu, sig))

    return proxy
