"""Image resizing as JAX's ``jax.image.resize`` computes it.

``jax.image.resize`` (``jax/_src/image/scale.py:compute_weight_mat``) builds
one float32 weight matrix per spatial axis and contracts the image with
them: the sample positions ``(j + 0.5) / scale - 0.5``, a kernel of the
distance to each input pixel (triangle for "linear", Keys cubic with
a = -0.5 for "cubic"), widened by the inverse scale when shrinking
(antialiasing), each output's weights divided by their sum, and an output
whose position falls outside the input given no weight. The positions
take one rounding to float32, as XLA's fused multiply-add gives them: two
roundings put a position near the far edge an ulp (3e-5 at 320) off and
the resized image up to 6e-5. ``F.interpolate``
differs: its bicubic kernel has a = -0.75 and clamps at the edges instead
of renormalising, up to 0.1 apart from JAX's when growing 32 -> 224, and it
does not antialias the same way.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0.0), _F32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, of |distance| x."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0,
                   ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0)) * x
                   + _F32(2.0), out)
    return np.where(x >= 2.0, _F32(0.0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str = "linear"
                   ) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize(..., method)``
    along one axis ("linear" or "cubic"; antialiased, no
    translation)."""
    kernel = _KERNELS[method]
    # JAX takes 1 / scale in double precision (a Python float), and XLA
    # fuses the position's product and subtraction: one rounding to f32
    inv_scale = _F32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, _F32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + _F32(0.5))
                .astype(np.float64) * np.float64(inv_scale) - 0.5
                ).astype(np.float32)
    x = (np.abs(sample_f[None, :]
                - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale)
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def host_constant(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array on ``like``'s device, in its dtype. A CUDA copy goes
    through pinned memory without waiting, so that a verifier or an
    extractor inside a sampler makes no synchronizing call."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if like.device.type == "cuda":
        t = t.pin_memory().to(like.device, non_blocking=True)
    return t.to(device=like.device, dtype=like.dtype)


def resize(images: torch.Tensor, height: int, width: int,
           method: str = "linear") -> torch.Tensor:
    """NHWC ``images`` resized to (height, width) as ``jax.image.resize``
    resizes them: separable weight matrices on the images' device, in
    their dtype. An axis already at its size is left as it is."""
    B, H, W, C = images.shape
    out = images
    if H != height:
        wh = host_constant(resize_weights(H, height, method), images)
        out = torch.einsum("bhwc,hi->biwc", out, wh)
    if W != width:
        ww = host_constant(resize_weights(W, width, method), images)
        out = torch.einsum("bhwc,wj->bhjc", out, ww)
    return out
