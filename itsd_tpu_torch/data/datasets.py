"""Host-side input pipelines.

Counterpart of ``itsd_tpu/data/datasets.py``: datasets are in-memory numpy
arrays ``images [N, H, W, C] float32 in [-1, 1]`` (and labels), batched by
``BatchIterator`` with the random horizontal flip, and moved to the device
by ``prefetch_to_device`` or ``threaded_prefetch``. ``synthetic_dataset``
and ``shapes_dataset`` are numpy-only copies of the JAX package's, so the
same seed gives the same images. ``load_cifar10`` reads the standard
``cifar-10-batches-py`` pickles (or their ``.tar.gz``) with the standard
library alone. ``load_image_folder`` reads a class-per-directory image
tree through Pillow, imported when it is called (the card's machine has
none, and there it raises ImportError).
"""

from __future__ import annotations

import collections
import os
import pickle
import queue as queue_mod
import tarfile
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..parallel import local_rows


class BatchIterator:
    """Shuffling batch iterator over in-memory arrays. With ``shard`` (a
    process group) it shuffles and flips the global batch of
    ``batch_size`` rows as one process does and yields this rank's
    ``local_rows`` of it."""

    def __init__(self, images: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, seed: int = 0, flip: bool = True,
                 drop_remainder: bool = True, shard=None):
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.flip = flip
        self.drop_remainder = drop_remainder
        self.shard = shard
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.images) // self.batch_size
        if not self.drop_remainder and len(self.images) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        order = self._rng.permutation(len(self.images))
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            imgs = self.images[idx]
            if self.flip:
                flip_mask = self._rng.random(len(idx)) < 0.5
                imgs = imgs.copy()
                imgs[flip_mask] = imgs[flip_mask, :, ::-1]
            batch = {"image": imgs.astype(np.float32)}
            if self.labels is not None:
                batch["label"] = self.labels[idx].astype(np.int32)
            if self.shard is not None:
                batch = {k: local_rows(v, self.shard)
                         for k, v in batch.items()}
            yield batch


def load_cifar10(root: str, train: bool = True,
                 subset_ratio: Optional[float] = None,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 from ``root/cifar-10-batches-py`` (extracted first from
    ``root/cifar-10-python.tar.gz`` when only that exists): the five
    training batches or the test batch. Returns (images [N,32,32,3]
    float32 in [-1,1], labels [N] int32); ``subset_ratio`` keeps a seeded
    random share."""
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        tgz = os.path.join(root, "cifar-10-python.tar.gz")
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(root, filter="data")
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"CIFAR-10 not found under {root!r}; expected "
            "cifar-10-batches-py/ or cifar-10-python.tar.gz (nothing is "
            "downloaded)")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"]))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.concatenate(ys)
    x = (x.astype(np.float32) / 255.0) * 2.0 - 1.0
    if subset_ratio is not None and subset_ratio < 1.0:
        n = max(1, int(len(x) * subset_ratio))
        idx = np.random.default_rng(seed).permutation(len(x))[:n]
        x, y = x[idx], y[idx]
    return x, y.astype(np.int32)


def load_image_folder(root: str, img_size: int = 256,
                      subset_ratio: Optional[float] = None, seed: int = 0,
                      max_images: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """A class-per-subdirectory image tree -> (images [N, S, S, 3] in
    [-1, 1], labels [N] int32), as ``itsd_tpu/data/datasets.py:
    load_image_folder``: classes in sorted order, the files of each
    (.png, .jpg, .jpeg, .bmp, .webp) in sorted order, a seeded subset of
    ``subset_ratio``, then the first ``max_images``; each image resized so
    that its shorter side is ``img_size``, then cropped at the centre.
    Needs Pillow, imported here: without it this raises ImportError."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("load_image_folder needs Pillow (PIL), which is "
                          "not installed") from e

    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp")):
                paths.append(os.path.join(cdir, f))
                labels.append(ci)
    paths = np.asarray(paths)
    labels = np.asarray(labels, dtype=np.int32)
    if subset_ratio is not None and subset_ratio < 1.0:
        n = max(1, int(len(paths) * subset_ratio))
        idx = np.random.default_rng(seed).permutation(len(paths))[:n]
        paths, labels = paths[idx], labels[idx]
    if max_images is not None:
        paths, labels = paths[:max_images], labels[:max_images]

    imgs = np.empty((len(paths), img_size, img_size, 3), dtype=np.float32)
    for i, p in enumerate(paths):
        with Image.open(p) as src:
            im = src.convert("RGB")
        w, h = im.size
        scale = img_size / min(w, h)
        im = im.resize((max(img_size, int(round(w * scale))),
                        max(img_size, int(round(h * scale)))))
        w, h = im.size
        left, top = (w - img_size) // 2, (h - img_size) // 2
        im = im.crop((left, top, left + img_size, top + img_size))
        u8 = np.asarray(im, dtype=np.uint8)
        imgs[i] = (u8.astype(np.float32) / 255.0) * 2.0 - 1.0
    return imgs, labels


def _put_batch(batch: dict, device) -> dict:
    """Each array of ``batch`` as a tensor on ``device``: through pinned
    host memory and a non-blocking copy when the device is a GPU."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Keep the next ``size`` batches on their way to the device while the
    current one is used."""
    pending = collections.deque()
    it = iter(iterator)
    for batch in it:
        pending.append(_put_batch(batch, device))
        if len(pending) > size:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def threaded_prefetch(iterator, size: int = 2, device="cuda"):
    """Like ``prefetch_to_device``, but batch assembly, augmentation and the
    copy to the device run on a producer thread, so they overlap with the
    step's Python dispatch.

    An exception in the producer is raised in the consumer. When the
    consumer stops early (break, exception, garbage collection of the
    generator), the producer is told to stop, the queue is drained and the
    thread is joined, so no thread is left holding device batches."""
    q = queue_mod.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()

    def put_guarded(item) -> bool:
        """Blocking put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return not stop.is_set()
            except queue_mod.Full:
                continue
        return False

    def produce():
        try:
            for batch in iterator:
                if not put_guarded(_put_batch(batch, device)):
                    return
            put_guarded(end)
        except BaseException as e:  # noqa: BLE001 (raised in the consumer)
            put_guarded(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        t.join(timeout=2.0)


def synthetic_dataset(n: int = 256, img_size: int = 32, num_labels: int = 10,
                      seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic random data (smooth blobs, not white noise) for tests
    and benchmarks."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, img_size // 4, img_size // 4, 3))
    imgs = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    imgs = np.tanh(imgs).astype(np.float32)
    labels = rng.integers(0, num_labels, size=n).astype(np.int32)
    return imgs, labels


def shapes_dataset(n: int = 10000, img_size: int = 32, num_labels: int = 10,
                   seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Procedurally generated class-structured images: 10 classes =
    {circle, square, triangle, ring, cross} x 2 hue families, with jittered
    position, scale and hue and a textured background: the repository's
    stand-in for CIFAR-10. Returns (images [N,S,S,3] float32 in [-1,1],
    labels [N] int32)."""
    rng = np.random.default_rng(seed)
    S = img_size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    # base hue per class family (RGB in [0,1]); 2 families x 5 shapes
    family_rgb = np.array([[0.9, 0.25, 0.2], [0.2, 0.45, 0.95]], np.float32)

    imgs = np.empty((n, S, S, 3), dtype=np.float32)
    labels = rng.integers(0, num_labels, size=n).astype(np.int32)
    for i in range(n):
        lab = labels[i]
        shape_kind = lab % 5
        fam = lab // 5
        cx = S / 2 + rng.uniform(-S / 8, S / 8)
        cy = S / 2 + rng.uniform(-S / 8, S / 8)
        r = S * rng.uniform(0.22, 0.34)
        dx, dy = xx - cx, yy - cy
        if shape_kind == 0:      # circle
            mask = (dx ** 2 + dy ** 2) <= r ** 2
        elif shape_kind == 1:    # square
            mask = (np.abs(dx) <= r * 0.85) & (np.abs(dy) <= r * 0.85)
        elif shape_kind == 2:    # triangle (upward)
            mask = (dy >= -r) & (dy <= r) & \
                   (np.abs(dx) <= (dy + r) * 0.6)
        elif shape_kind == 3:    # ring
            rho = dx ** 2 + dy ** 2
            mask = (rho <= r ** 2) & (rho >= (0.55 * r) ** 2)
        else:                    # cross
            mask = (np.abs(dx) <= r * 0.3) | (np.abs(dy) <= r * 0.3)
            mask &= (np.abs(dx) <= r) & (np.abs(dy) <= r)
        color = np.clip(
            family_rgb[fam] + rng.uniform(-0.12, 0.12, 3), 0.0, 1.0)
        bg = 0.45 + 0.1 * rng.standard_normal((S, S, 1)).astype(np.float32)
        bg = np.clip(bg + rng.uniform(-0.15, 0.15), 0.0, 1.0)
        img = np.broadcast_to(bg, (S, S, 3)).copy()
        img[mask] = color
        imgs[i] = img * 2.0 - 1.0
    return imgs, labels
