"""MNIST for the educational models (counterpart of the JAX package's
``data/mnist.py``).

- :func:`load_mnist` reads the standard IDX files
  (``train-images-idx3-ubyte[.gz]`` ...) from a local directory; MNIST is
  not in the repository and is never fetched;
- :func:`synthetic_mnist` makes a deterministic digit-like set (one glyph
  per class with per-sample jitter) from a numpy seed, the same arrays as
  the JAX package's for the same seed;
- :func:`to_model_input` turns uint8 (N, 28, 28) into float32 NHWC in
  [-1, 1], resized through the port's ``ops/resize.resize_matrix`` (the
  ``pil`` variant) when asked; the trainer moves such NHWC batches to the
  device as NCHW.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from dgm_img_super_resolution_tpu_torch.ops.resize import resize_matrix


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist(data_dir: str, split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """Read IDX MNIST files -> (images uint8 (N, 28, 28), labels (N,))."""
    prefix = "train" if split == "train" else "t10k"
    for ext in ("", ".gz"):
        img_path = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
        lbl_path = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            return _read_idx(img_path), _read_idx(lbl_path)
    raise FileNotFoundError(f"MNIST IDX files not found under {data_dir}")


def synthetic_mnist(n: int = 4096, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like 28x28 grayscale images (uint8) with labels:
    a ring, a bar at a class-dependent angle or a filled blob per class."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    images = np.zeros((n, 28, 28), np.float32)
    labels = rng.integers(0, 10, n).astype(np.int64)
    for i in range(n):
        c = int(labels[i])
        cx = 14 + rng.normal(0, 1.5)
        cy = 14 + rng.normal(0, 1.5)
        r = 6 + c * 0.5 + rng.normal(0, 0.5)
        if c % 3 == 0:  # ring
            d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            img = np.exp(-((d - r) ** 2) / 2.0)
        elif c % 3 == 1:  # bar at a class-dependent angle
            theta = c * np.pi / 10 + rng.normal(0, 0.1)
            d = np.abs((xx - cx) * np.sin(theta) - (yy - cy) * np.cos(theta))
            mask = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) < r + 3
            img = np.exp(-(d**2) / 3.0) * mask
        else:  # filled blob
            d = np.sqrt((xx - cx) ** 2 + ((yy - cy) * (1 + c / 10)) ** 2)
            img = 1.0 / (1.0 + np.exp(2.0 * (d - r * 0.7)))
        img = img + rng.normal(0, 0.02, img.shape)
        images[i] = np.clip(img, 0, 1)
    return (images * 255).astype(np.uint8), labels


def to_model_input(images: np.ndarray, size: int = 28) -> np.ndarray:
    """uint8 (N, 28, 28) -> float32 NHWC in [-1, 1], resized to ``size``
    (e.g. 32 for the AE, VAE and DDPM) by the antialiased bicubic matrices."""
    x = images.astype(np.float32) / 127.5 - 1.0
    x = x[..., None]
    if size != images.shape[1]:
        m = resize_matrix(images.shape[1], size, "pil", dtype="float32")
        x = np.einsum("oh,nhwc->nowc", m, x)
        x = np.einsum("pw,nowc->nopc", m, x)
    return x


class ArrayDataset:
    """(images, labels) arrays as an indexable dataset for ``data/loader.py``."""

    def __init__(self, images: np.ndarray, labels: np.ndarray | None = None):
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        if self.labels is None:
            return self.images[int(idx)]
        return self.images[int(idx)], self.labels[int(idx)]
