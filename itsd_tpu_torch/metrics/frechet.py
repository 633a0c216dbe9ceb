"""Fréchet distance between two Gaussians (the core of FID).

Counterpart of ``itsd_tpu/metrics/frechet.py``: ``frechet_distance``
in float64 numpy on the host (``frechet_from`` keeps the first Gaussian's
square root for many calls), ``frechet_distance_torch`` (JAX's
``frechet_distance_jax``) in float32 torch for use inside a verifier,
``gaussian_stats`` and ``compute_fid``. Both distances take the symmetric route

    tr sqrt(S1 S2) = tr sqrt( sqrt(S1) S2 sqrt(S1) ),

exact for PSD matrices, through symmetric eigendecompositions.
"""

from __future__ import annotations

import numpy as np
import torch


def _sqrtm_psd_numpy(mat: np.ndarray, eps: float) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_from(mu1, sigma1, eps: float = 1e-6):
    """The Fréchet distance to the Gaussian (mu1, sigma1), as a function
    of another's (mu2, sigma2): float64 on the host, each covariance
    regularised by ``eps * I``. The square root of ``sigma1`` is taken
    once, for every call (a tracked run measures many snapshots against
    one set of real statistics)."""
    mu1 = np.asarray(mu1, dtype=np.float64)
    sigma1 = np.asarray(sigma1, dtype=np.float64)
    s1_half = _sqrtm_psd_numpy(sigma1 + eps * np.eye(len(sigma1)), 0.0)
    tr1 = np.trace(sigma1)

    def distance(mu2, sigma2) -> float:
        mu2 = np.asarray(mu2, dtype=np.float64)
        sigma2 = np.asarray(sigma2, dtype=np.float64)
        diff = mu1 - mu2
        inner = s1_half @ (sigma2 + eps * np.eye(len(sigma2))) @ s1_half
        inner = (inner + inner.T) / 2.0
        vals = np.clip(np.linalg.eigvalsh(inner), 0.0, None)
        tr_sqrt = float(np.sqrt(vals).sum())
        fid = float(diff @ diff + tr1 + np.trace(sigma2) - 2.0 * tr_sqrt)
        return max(fid, 0.0)

    return distance


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians, float64 on the host, each covariance
    regularised by ``eps * I``."""
    return frechet_from(mu1, sigma1, eps)(mu2, sigma2)


def frechet_distance_torch(mu1: torch.Tensor, sigma1: torch.Tensor,
                           mu2: torch.Tensor, sigma2: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """Float32 Fréchet distance on the tensors' device, differentiable: a
    verifier's score, where the ordering of candidates matters more than
    the last digits."""
    d = mu1.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=mu1.device)
    s1 = sigma1 + eps * eye
    s2 = sigma2 + eps * eye
    v1, q1 = torch.linalg.eigh(s1)
    s1_half = (q1 * torch.sqrt(v1.clamp(min=0.0))) @ q1.T
    inner = s1_half @ s2 @ s1_half
    inner = (inner + inner.T) / 2.0
    vals = torch.linalg.eigvalsh(inner).clamp(min=0.0)
    diff = mu1 - mu2
    fid = (diff @ diff + torch.trace(s1) + torch.trace(s2)
           - 2.0 * torch.sqrt(vals).sum())
    return fid.clamp(min=0.0)


def gaussian_stats(features, biased: bool = True):
    """(mu, sigma) of a feature matrix [N, D], float64 numpy; ``biased``
    divides the covariance by N, else by N - 1."""
    feats = np.asarray(features, dtype=np.float64)
    mu = feats.mean(axis=0)
    d = feats - mu
    denom = len(feats) if biased else len(feats) - 1
    sigma = (d.T @ d) / denom
    return mu, sigma


def compute_fid(real_features, fake_features, eps: float = 1e-6) -> float:
    """FID between two feature matrices [N, D]: the Fréchet distance of
    their Gaussians (biased covariances), float64 on the host."""
    mu_r, s_r = gaussian_stats(real_features)
    mu_f, s_f = gaussian_stats(fake_features)
    return frechet_distance(mu_r, s_r, mu_f, s_f, eps)
