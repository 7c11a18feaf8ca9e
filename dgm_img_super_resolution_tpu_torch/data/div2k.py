"""DIV2K paired LR/HR dataset (counterpart of the JAX package's
``data/div2k.py``; the reference's notebook dataset,
``srdiff_notebook.ipynb`` cell 12).

Samples are numpy HWC in [-1, 1], as in the JAX package: ``hr`` (an HR
crop, or the whole image resized, ``pil`` variant), ``lr`` (its ``pil``
x1/s resize) and ``lr_up`` (bicubic x s of ``lr``, the ``torch``
align_corners variant), all computed on the host through the port's
``ops/resize.py:resize_matrix``. With ``data_augmentation`` an image larger
than the HR size gives a random crop, flipped left-right half the time,
drawn from a numpy generator seeded by ``seed``, or under data parallelism
by (``seed``, ``rank``) so that the ranks crop apart (rank 0 draws the
one-process stream). The trainer moves batches to NCHW (channels_last on
the card).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
from PIL import Image

from dgm_img_super_resolution_tpu_torch.ops.resize import resize_matrix


def _resize_np(img: np.ndarray, out_hw: tuple[int, int], variant: str) -> np.ndarray:
    mh = resize_matrix(img.shape[0], out_hw[0], variant, dtype="float32")
    mw = resize_matrix(img.shape[1], out_hw[1], variant, dtype="float32")
    y = np.einsum("oh,hwc->owc", mh, img.astype(np.float32))
    return np.einsum("pw,owc->opc", mw, y)


def _to_pm1(x: np.ndarray) -> np.ndarray:
    return np.clip(x, 0, 255).astype(np.float32) / 127.5 - 1.0


class DIV2KDataset:
    """Returns ``{"hr": (H,W,3), "lr": (H/s,W/s,3), "lr_up": (H,W,3)}`` float32
    in [-1, 1]; ``only_img=True`` returns the raw uint8 HWC image."""

    def __init__(self, img_dir_path: str, scale_factor: int = 4, hr_height: int = 256, hr_width: int = 256,
                 only_img: bool = False, data_augmentation: bool = False, seed: int = 0,
                 file_list: list[str] | None = None, rank: int = 0):
        self.img_dir_path = img_dir_path
        self.scale = scale_factor
        self.hr_height = hr_height
        self.hr_width = hr_width
        self.only_img = only_img
        self.data_augmentation = data_augmentation
        self._rng = np.random.default_rng([seed, rank] if rank else seed)
        if file_list is not None:
            self.files = file_list
        else:
            self.files = sorted(f for f in os.listdir(img_dir_path) if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not self.files:
            raise FileNotFoundError(f"no images in {img_dir_path}")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Any:
        with Image.open(os.path.join(self.img_dir_path, self.files[int(idx)])) as im:
            img = np.asarray(im.convert("RGB"))
        if self.only_img:
            return img
        h, w = self.hr_height, self.hr_width
        if self.data_augmentation and img.shape[0] > h and img.shape[1] > w:
            y0 = int(self._rng.integers(0, img.shape[0] - h + 1))
            x0 = int(self._rng.integers(0, img.shape[1] - w + 1))
            hr = img[y0: y0 + h, x0: x0 + w].astype(np.float32)
            if self._rng.random() < 0.5:
                hr = hr[:, ::-1]
        else:
            hr = _resize_np(img, (h, w), "pil")
        lr = _resize_np(hr, (h // self.scale, w // self.scale), "pil")
        lr_up = _resize_np(lr, (h, w), "torch")
        return {"hr": _to_pm1(hr), "lr": _to_pm1(lr), "lr_up": _to_pm1(lr_up)}
