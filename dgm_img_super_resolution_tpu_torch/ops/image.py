"""Image value-range conversion and patch tiling (counterpart of the JAX
package's ``ops/image.py``).

The tiling functions work on NCHW tensors on the caller's device (the JAX
package's are NHWC); the order of patches and tiles along the batch axis
is the JAX package's, so that a tile of one package is the same tile of the
other. ``extract_patches`` / ``merge_patches`` cut a hard grid,
``extract_tiles`` / ``merge_tiles`` overlapping tiles whose seams the merge
blends with linear ramps (``overlap`` 0 gives the hard grid again), and
``ImgMerger`` stitches CHW patches by grid location, as the reference's
evaluator does.
"""

from __future__ import annotations

import numpy as np
import torch


def uint8_to_pm1(x) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return torch.as_tensor(x).to(torch.float32) / 127.5 - 1.0


def pm1_to_uint8(x) -> np.ndarray:
    """[-1, 1] float -> uint8 [0, 255] with round-half-to-even (the
    reference's ``np.round`` convention)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    y = (np.asarray(x, dtype=np.float64) + 1.0) * 127.5
    return np.round(np.clip(y, 0, 255)).astype(np.uint8)


def extract_patches(x: torch.Tensor, patch: int, stride: int | None = None):
    """Split NCHW into a grid of ``patch``-square patches; returns
    ``(patches, (gy, gx))``. With ``stride == patch`` (the default) H and W
    must divide by ``patch`` and patches run image by image, row by row;
    with another stride they run grid location by location, each holding
    every image."""
    stride = stride or patch
    n, c, h, w = x.shape
    if stride == patch:
        gy, gx = h // patch, w // patch
        y = x.reshape(n, c, gy, patch, gx, patch).permute(0, 2, 4, 1, 3, 5)
        return y.reshape(n * gy * gx, c, patch, patch), (gy, gx)
    gy = (h - patch) // stride + 1
    gx = (w - patch) // stride + 1
    rows = [x[:, :, iy * stride: iy * stride + patch, ix * stride: ix * stride + patch]
            for iy in range(gy) for ix in range(gx)]
    return torch.cat(rows, dim=0), (gy, gx)


def merge_patches(patches: torch.Tensor, grid: tuple[int, int], n: int = 1) -> torch.Tensor:
    """Inverse of :func:`extract_patches` with ``stride == patch``."""
    gy, gx = grid
    _, c, p, _ = patches.shape
    y = patches.reshape(n, gy, gx, c, p, p).permute(0, 3, 1, 4, 2, 5)
    return y.reshape(n, c, gy * p, gx * p)


def tile_positions(length: int, patch: int, stride: int) -> list[int]:
    """Start offsets covering [0, length) with ``patch``-sized tiles at
    ``stride``; the last tile is right-aligned so that the edge is covered."""
    if length <= patch:
        return [0]
    pos = list(range(0, length - patch + 1, stride))
    if pos[-1] != length - patch:
        pos.append(length - patch)
    return pos


def extract_tiles(x: torch.Tensor, patch: int, overlap: int = 0):
    """Split NCHW into tiles overlapping by ``overlap``; returns ``(tiles,
    coords)``: tiles (N*T, C, patch, patch), location by location, and the
    (y, x) start offsets."""
    _, _, h, w = x.shape
    stride = patch - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be < patch {patch}")
    coords = [(y, xx) for y in tile_positions(h, patch, stride) for xx in tile_positions(w, patch, stride)]
    tiles = torch.cat([x[:, :, y: y + patch, xx: xx + patch] for y, xx in coords], dim=0)
    return tiles, coords


def _feather(length: int, ramp: int) -> np.ndarray:
    """1-D blend window: linear ramps of ``ramp`` samples at both ends (at
    least 1/(ramp+1), so that sum-normalisation holds at the image border),
    flat 1 inside."""
    w = np.ones(length, np.float32)
    if ramp > 0:
        r = np.arange(1, min(ramp, length) + 1, dtype=np.float32) / (ramp + 1)
        w[: len(r)] = np.minimum(w[: len(r)], r)
        w[-len(r):] = np.minimum(w[-len(r):], r[::-1])
    return w


def merge_tiles(tiles: torch.Tensor, coords: list[tuple[int, int]], out_hw: tuple[int, int],
                scale: int = 1, overlap: int = 0, n: int = 1) -> torch.Tensor:
    """Inverse of :func:`extract_tiles` after a x``scale`` SR of every tile:
    the tiles are summed under the outer product of two feather windows
    (ramps of ``overlap * scale``) and divided by the summed weights.
    ``coords`` are LR offsets; the output (n, C, *out_hw) is HR."""
    t, c, p, _ = tiles.shape
    if t != len(coords) * n:
        raise ValueError(f"{t} tiles for {len(coords)} locations x {n} images")
    win = torch.from_numpy(_feather(p, overlap * scale)).to(tiles.device, tiles.dtype)
    w2 = torch.outer(win, win)
    oh, ow = out_hw
    acc = torch.zeros((n, c, oh, ow), dtype=tiles.dtype, device=tiles.device)
    wacc = torch.zeros((n, 1, oh, ow), dtype=tiles.dtype, device=tiles.device)
    for i, (y, xx) in enumerate(coords):
        ys, xs = slice(y * scale, y * scale + p), slice(xx * scale, xx * scale + p)
        acc[:, :, ys, xs] += tiles[i * n: (i + 1) * n] * w2
        wacc[:, :, ys, xs] += w2
    return acc / wacc


class ImgMerger:
    """Collect CHW patches by grid location and run ``eval_fn`` on the
    stitched images once every location has arrived (the reference's
    ``ImgMerger``): ``push(imgs, loc, loc_bdr)`` gives one patch per image
    slot at ``loc = (x, y)`` of a ``loc_bdr = (max_x, max_y)`` grid, x down
    the rows and y along them."""

    def __init__(self, eval_fn):
        self.eval_fn = eval_fn
        self.clear()

    def clear(self) -> None:
        self.loc2imgs: dict[str, list] = {}
        self.max_x = 0
        self.max_y = 0

    def push(self, imgs, loc, loc_bdr):
        self.max_x, self.max_y = loc_bdr
        x, y = loc
        self.loc2imgs[f"{x},{y}"] = imgs
        if len(self.loc2imgs) == self.max_x * self.max_y:
            return self.compute()
        return None

    def compute(self):
        stitched = []
        for i in range(len(self.loc2imgs["0,0"])):
            rows = [torch.cat([torch.as_tensor(self.loc2imgs[f"{x},{y}"][i]) for y in range(self.max_y)], dim=-1)
                    for x in range(self.max_x)]
            stitched.append(torch.cat(rows, dim=-2))
        self.clear()
        return self.eval_fn(*stitched)
