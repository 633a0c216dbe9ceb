"""Image grids, saved as PNG with the standard library alone.

Counterpart of ``itsd_tpu/utils/images.py``; the PNG is written with
``zlib`` and ``struct`` instead of Pillow.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """[N,H,W,C] in [-1,1] or [0,1] -> single [GH,GW,C] uint8 grid."""
    images = np.asarray(images)
    if images.min() < -0.01:  # [-1,1] -> [0,1]
        images = (images + 1.0) / 2.0
    images = np.clip(images, 0.0, 1.0)
    n, h, w, c = images.shape
    ncol = int(np.ceil(n / nrow))
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + pad) + pad
        x = col * (w + pad) + pad
        grid[y:y + h, x:x + w] = images[i]
    return (grid * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """8-bit grayscale [H,W] / [H,W,1] or RGB [H,W,3] -> PNG bytes."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png: want [H,W], [H,W,1] or [H,W,3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image_grid(images, path: str, nrow: int = 8) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    grid = make_grid(np.asarray(images), nrow=nrow)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
