"""Shared helpers for the example training scripts of the port.

The scripts realise the reference's educational notebooks
(``notebooks/simple_gan.ipynb``, ``dcgan.ipynb``, ``wgan-gp.ipynb``,
``simple_autoencoder.ipynb``, ``vae.ipynb`` (stub), ``basic_diffusion.ipynb``
(missing blob)) as runnable PyTorch programs on the card: the same models
and losses, real MNIST when IDX files are supplied, hermetic synthetic
digits otherwise. Arguments, data and grids are those of the JAX package's
``examples/common.py``; ``--device`` picks the card (the default) or the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.data.mnist import load_mnist, synthetic_mnist, to_model_input


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--data_dir", type=str, default="", help="dir with MNIST IDX files (synthetic if empty)")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--out_dir", type=str, default="runs/example")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="torch device; 'cpu' runs the plain versions")
    return p


def device(args) -> torch.device:
    """``--device``: ``cuda`` is the current card and raises where there is
    none; any other name is taken as it is."""
    return resolve_device(None if args.device == "cuda" else args.device)


def get_mnist(args, size: int = 28, n_synth: int = 8192) -> np.ndarray:
    """NHWC float32 [-1,1] images."""
    if args.data_dir:
        images, _ = load_mnist(args.data_dir, "train")
    else:
        print("| no --data_dir: using synthetic digit-like data")
        images, _ = synthetic_mnist(n_synth, seed=args.seed)
    return to_model_input(images, size)


def nhwc(images: torch.Tensor) -> np.ndarray:
    """The port's NCHW images as the NHWC numpy ``save_grid`` takes."""
    return images.detach().permute(0, 2, 3, 1).float().cpu().numpy()


def save_grid(images: np.ndarray, path: str, cols: int = 8) -> None:
    """Tile NHWC [-1,1] or [0,1] images into one PNG."""
    from PIL import Image

    arr = np.asarray(images)
    if arr.min() < -0.01:
        arr = (arr + 1.0) / 2.0
    arr = np.clip(arr, 0, 1)
    n, h, w, c = arr.shape
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = arr[i]
    out = np.round(grid * 255).astype(np.uint8)
    if c == 1:
        out = out[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(out).save(path)
    print(f"| wrote {path}")


def batches(x: np.ndarray, batch_size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(len(x))
        for i in range(len(x) // batch_size):
            yield x[idx[i * batch_size : (i + 1) * batch_size]]
