"""End-to-end SRDiff serving pipeline (counterpart of the JAX package's
``inference.py:49-468``).

``SRDiffPipeline.upscale_batch_device`` does, in order: uint8 -> [-1, 1];
reflect-pad the LR batch to the UNet's 2^stages divisibility (edge padding
when the pad reaches the image's size); bicubic x4 (``torch`` variant); the
sampler (ancestral, or DDIM with eta and, with ``enc_interval`` > 1,
encoder propagation); clip; crop back; optional uint8 rounding. It runs on
``cuda`` unless the caller passes another device, and raises when no CUDA
device is there and none was asked for.

The HR-pixel budget (``max_native_hr_pixels``, 0 turns it off) bounds one
sampler call: a batch over it is served in equal sub-batches of
``max(1, budget // pixels of one image)`` (the last one padded by repeating
its final image, then sliced), and an image that alone exceeds it (and is
larger than ``infer_patch_size``) is served in feathered tiles
(``upscale_large``). ``upscale`` routes such an image to the tiles by
itself. ``progress_cb(done, total)`` fires every ``callback_steps`` sampler
steps, counted across the chunks and images of a request; that path runs
the exact sampler (``enc_interval`` 1), as JAX's does.

Noise. A request served in one call takes a noise hook (see
``diffusion/gaussian.py``) or draws from a generator. A request served in
several calls takes a ``ChunkNoise``, which gives each call its own hook
by the chunk indices that lead to it, as the JAX package folds them into
its key; without one, each chunk draws from a generator seeded by a draw
from its parent's generator.

Data parallelism (``parallel/mesh.py``). Under a process group of W ranks
(``torchrun``) the pipeline's ``mesh`` (from ``hp['mesh_shape']``) puts
every rank on ``dp``: the weights are broadcast from rank 0, each sampler
call serves this rank's rows of its batch and gathers the whole batch on
every rank, so every rank returns the images of a one-process serve. The
budget is then one card's: a batch that W divides may hold W times the
budget, and sub-batches are sized in multiples of W; a batch that W does
not divide is served whole on every rank (with a warning). Noise is drawn
or asked of the hook for the whole batch and sliced to the rows.

Weights: a state dict under the reference checkpoint's names, the upstream
checkpoint file itself (``ckpt_path``, through
``ckpt/torch_import.py:import_srdiff_checkpoint``), or a seeded random
init. ``interpolate`` mixes two HR images in the diffusion's latent space
(the reference's ``style_interp``).
"""

from __future__ import annotations

import logging
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import as_noise_hook
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.ops.image import (
    extract_patches,
    extract_tiles,
    merge_patches,
    merge_tiles,
    uint8_to_pm1,
)
from dgm_img_super_resolution_tpu_torch.ops.resize import resize
from dgm_img_super_resolution_tpu_torch.parallel.mesh import (
    Mesh,
    batch_rows,
    gather_rows,
    make_mesh,
    replicate,
    shard_batch,
)

logger = logging.getLogger("dgm_img_super_resolution_tpu_torch.inference")

ProgressCb = Callable[[int, int], None]


class ChunkNoise:
    """The noise of a request that may be served in several sampler calls.
    ``fn(path, shape)`` returns the noise hook of the call at ``path`` for
    its padded NCHW HR ``shape``. ``path`` is the tuple of chunk indices on
    the way to the call, the indices the JAX package folds into its key:
    () for a request served in one call, (ci,) for sub-batch ci, (i,) for
    image i served in tiles and (i, ci) for sub-batch ci of its tiles."""

    def __init__(self, fn: Callable, path: tuple[int, ...] = ()):
        self.fn, self.path = fn, path

    def fold_in(self, i: int) -> "ChunkNoise":
        return ChunkNoise(self.fn, self.path + (int(i),))

    def hook(self, shape):
        return self.fn(self.path, tuple(shape))


def _child(noise, generator: torch.Generator, i: int):
    """(noise, generator) of chunk ``i`` of a split request."""
    if isinstance(noise, ChunkNoise):
        return noise.fold_in(i), None
    if noise is not None:
        raise ValueError("a request served in several calls takes its noise as a ChunkNoise")
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device).item())
    return None, torch.Generator(device=generator.device).manual_seed(seed)


def _scaled(progress_cb: ProgressCb | None, i: int, n: int) -> ProgressCb | None:
    """Progress of part ``i`` of ``n`` equal parts, as progress of the whole."""
    if progress_cb is None:
        return None
    return lambda done, total: progress_cb(i * total + done, n * total)


class SRDiffPipeline:
    def __init__(self, hp: Hparams | None = None, params: Mapping[str, torch.Tensor] | None = None,
                 device: str | torch.device | None = None, generator: torch.Generator | None = None,
                 ckpt_path: str | None = None, mesh: Mesh | None = None):
        """``params``: a ``state_dict`` of the SRDiff stack under the
        reference checkpoint's names (``denoise_fn.*``, ``rrdb.*``), loaded
        strictly; else the upstream checkpoint at ``ckpt_path``; else a
        random init seeded by ``hp['seed']``. ``generator`` draws the
        sampler noise; by default one on ``device`` seeded by
        ``hp['seed']``. ``mesh``: ``make_mesh(hp['mesh_shape'])`` by
        default."""
        self.hp = hp or Hparams()
        self.mesh = mesh if mesh is not None else make_mesh(self.hp.get("mesh_shape", ""))
        self.device = resolve_device(device)
        model = build_srdiff(self.hp)
        if params is None and ckpt_path:
            from dgm_img_super_resolution_tpu_torch.ckpt.torch_import import import_srdiff_checkpoint

            params, _ = import_srdiff_checkpoint(ckpt_path)
        if params is None:
            init_srdiff_params(model, seed=int(self.hp["seed"]), weight_init=bool(self.hp.get("weight_init", False)))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            # conv weights channels_last too, so that cuDNN sees NHWC on both sides
            self.model.to(memory_format=torch.channels_last)
        replicate(self.model, self.mesh)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(int(self.hp["seed"]))

    def _pad(self, h: int, w: int) -> tuple[int, int]:
        """LR pad that makes the HR grid divide by 2^(stages - 1)."""
        scale = self.hp["sr_scale"]
        div = 2 ** (len(self.hp.unet_dim_mults_tuple) - 1)
        ph = next(p for p in range(div + 1) if (h + p) * scale % div == 0)
        pw = next(p for p in range(div + 1) if (w + p) * scale % div == 0)
        return ph, pw

    def _padded_hr_pixels(self, h: int, w: int) -> int:
        """HR pixels of one image as the sampler runs it, at the padded size."""
        ph, pw = self._pad(h, w)
        return (h + ph) * (w + pw) * self.hp["sr_scale"] ** 2

    def _budget(self) -> int:
        return int(self.hp.get("max_native_hr_pixels", 0) or 0)

    def _tiled(self, h: int, w: int) -> bool:
        """One image alone over the budget, and larger than a tile."""
        budget = self._budget()
        return bool(budget) and self._padded_hr_pixels(h, w) > budget and max(h, w) > self._patch()

    def _patch(self) -> int:
        return int(self.hp.get("infer_patch_size", 128))

    def _overlap(self) -> int:
        return int(self.hp.get("infer_patch_overlap", 16))

    @torch.inference_mode()
    def upscale_batch_device(self, imgs, generator: torch.Generator | None = None, as_uint8: bool = False,
                             noise=None, progress_cb: ProgressCb | None = None,
                             callback_steps: int = 1) -> torch.Tensor:
        """imgs: NHWC uint8 [0, 255] or float [-1, 1] LR batch (numpy or
        torch) -> NHWC float [0, 1] (or uint8 with ``as_uint8``) SR batch at
        x scale, left on the device. ``noise``: the samplers' noise hook in
        the padded NCHW shape, or a ``ChunkNoise``, which a request over the
        budget needs."""
        x = imgs if isinstance(imgs, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(imgs))
        n, h, w = (int(v) for v in x.shape[:3])
        gen = generator or self.generator
        if self._tiled(h, w):
            outs = []
            for i in range(n):
                noise_i, gen_i = _child(noise, gen, i)
                sr = self.upscale_large_device(x[i], patch=self._patch(), overlap=self._overlap(), generator=gen_i,
                                               noise=noise_i, progress_cb=_scaled(progress_cb, i, n),
                                               callback_steps=callback_steps)
                outs.append(torch.round(sr * 255.0).to(torch.uint8) if as_uint8 else sr)
            return torch.stack(outs)
        per_img, budget = self._padded_hr_pixels(h, w), self._budget()
        ndev = self.mesh.dp
        # a batch that shards holds ndev cards' budgets; one that replicates, one card's
        if budget and n > 1 and n * per_img > budget * (ndev if n % ndev == 0 else 1):
            # the largest sub-batch within budget that still shards
            sub = max((budget * ndev // per_img) // ndev * ndev, ndev) if ndev > 1 else max(1, budget // per_img)
            n_chunks = -(-n // sub)
            outs = []
            for ci in range(n_chunks):
                chunk = x[ci * sub: (ci + 1) * sub]
                k = int(chunk.shape[0])
                if k < sub:  # the chunks' one shape; the padding is sliced off
                    chunk = torch.cat([chunk, chunk[-1:].expand(sub - k, *chunk.shape[1:])])
                noise_c, gen_c = _child(noise, gen, ci)
                outs.append(self.upscale_batch_device(chunk, gen_c, as_uint8, noise_c,
                                                      _scaled(progress_cb, ci, n_chunks), callback_steps)[:k])
            return torch.cat(outs)
        return self._serve(x, gen, as_uint8, noise, progress_cb, callback_steps)

    def _serve(self, x, gen, as_uint8, noise, progress_cb, callback_steps) -> torch.Tensor:
        """One sampler call over the whole batch: this rank's rows of it,
        then the whole batch gathered."""
        n, h, w = (int(v) for v in x.shape[:3])
        ph, pw = self._pad(h, w)
        scale = self.hp["sr_scale"]
        rows = batch_rows(n, self.mesh)
        x = shard_batch(x, self.mesh).to(self.device)
        x = uint8_to_pm1(x) if x.dtype == torch.uint8 else x.to(torch.float32)
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            mode = "reflect" if ph < h and pw < w else "replicate"
            x = F.pad(x, (0, pw, 0, ph), mode=mode)
        hr = ((h + ph) * scale, (w + pw) * scale)
        if isinstance(noise, ChunkNoise):
            noise = noise.hook((n, 3) + hr)
        img_lr_up = resize(x, hr, variant="torch")
        if rows.split:
            # the whole batch's noise, drawn or asked of the hook, and this rank's rows of it
            whole = as_noise_hook(noise, (n,) + tuple(img_lr_up.shape[1:]), self.device, gen)
            noise = lambda t: rows.take(whole(t))  # noqa: E731
        d = self.model
        ddim = self.hp.get("sampler", "ddpm") == "ddim"
        eta = float(self.hp.get("ddim_eta", 0.0))
        num_steps = self.hp.get("sample_timesteps", 0) or None
        if progress_cb is None:
            if ddim:
                img, _ = d.ddim_sample(x, img_lr_up, num_steps=num_steps, eta=eta, noise=noise, generator=gen,
                                       enc_interval=int(self.hp.get("enc_interval", 1) or 1))
            else:
                img, _ = d.sample(x, img_lr_up, noise=noise, generator=gen)
        else:
            # the exact sampler in segments of callback_steps steps
            if ddim:
                ts, ts_prev = d.ddim_timesteps(num_steps)
            else:
                ts = list(range(d.num_timesteps - 1, -1, -1))
                ts_prev = [t - 1 for t in ts]
            xt, cond, _, hook = d.sample_prepare(x, img_lr_up, noise, gen)
            step, done = max(1, int(callback_steps)), 0
            while done < len(ts):
                seg = slice(done, min(done + step, len(ts)))
                if ddim:
                    xt = d.ddim_segment(xt, cond, img_lr_up, ts[seg], ts_prev[seg], hook, eta)
                else:
                    xt = d.sample_segment(xt, cond, img_lr_up, ts[seg], hook)
                done = seg.stop
                progress_cb(done, len(ts))
            img = d.res2img(xt, img_lr_up)
        out = (img * 0.5 + 0.5).clamp(0.0, 1.0)[:, :, : h * scale, : w * scale]
        out = gather_rows(out.permute(0, 2, 3, 1), rows, self.mesh)
        if as_uint8:
            out = torch.round(out * 255.0).to(torch.uint8)
        return out

    def upscale_batch(self, imgs, generator: torch.Generator | None = None, noise=None,
                      progress_cb: ProgressCb | None = None, callback_steps: int = 1) -> np.ndarray:
        """NHWC LR batch -> NHWC float [0, 1] SR batch on the host."""
        return self.upscale_batch_device(imgs, generator, noise=noise, progress_cb=progress_cb,
                                         callback_steps=callback_steps).cpu().numpy()

    def upscale(self, image, generator: torch.Generator | None = None, noise=None,
                progress_cb: ProgressCb | None = None, callback_steps: int = 1) -> np.ndarray:
        """One HWC image -> HWC float [0, 1] SR image. An image whose SR
        would exceed the budget goes to ``upscale_large`` with
        ``infer_patch_size`` and ``infer_patch_overlap``."""
        img = image if isinstance(image, torch.Tensor) else np.asarray(image)
        h, w = int(img.shape[0]), int(img.shape[1])
        if self._tiled(h, w):
            logger.info("upscale: %dx%d native SR exceeds the HR-pixel budget; tiled SR (patch %d, overlap %d)",
                        h, w, self._patch(), self._overlap())
            return self.upscale_large(img, patch=self._patch(), overlap=self._overlap(), generator=generator,
                                      noise=noise, progress_cb=progress_cb, callback_steps=callback_steps)
        return self.upscale_batch(img[None], generator, noise=noise, progress_cb=progress_cb,
                                  callback_steps=callback_steps)[0]

    @torch.inference_mode()
    def interpolate(self, img1, img2, lam: float = 0.5, t: int | None = None,
                    generator: torch.Generator | None = None, noise=None) -> np.ndarray:
        """Latent mixing between two same-shape HR images, conditioned on the
        LR of the first (MATLAB bicubic down by ``sr_scale``, torch bicubic
        back up). HWC uint8 or [-1, 1] float in; HWC float [0, 1] out.
        ``t`` defaults to T-1; ``noise`` as ``GaussianDiffusion.interpolate``
        takes it (NCHW at the HR shape)."""
        def pm1(img):
            x = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
            x = x.to(self.device)
            x = uint8_to_pm1(x) if x.dtype == torch.uint8 else x.to(torch.float32)
            return x.permute(2, 0, 1)[None]

        x1, x2 = pm1(img1), pm1(img2)
        h, w = x1.shape[-2:]
        scale = self.hp["sr_scale"]
        lr = resize(x1, (h // scale, w // scale), variant="matlab")
        lr_up = resize(lr, (h, w), variant="torch")
        t = self.hp["timesteps"] - 1 if t is None else int(t)
        out = self.model.interpolate(x1, x2, lr, lr_up, t=t, lam=lam, noise=noise,
                                     generator=generator or self.generator)
        return (out * 0.5 + 0.5).clamp(0.0, 1.0)[0].permute(1, 2, 0).cpu().numpy()

    @torch.inference_mode()
    def upscale_large_device(self, image, patch: int = 64, overlap: int = 0,
                             generator: torch.Generator | None = None, noise=None,
                             progress_cb: ProgressCb | None = None, callback_steps: int = 1) -> torch.Tensor:
        """One HWC LR image in tiles of ``patch`` LR pixels, served as a
        batch and stitched -> HWC float [0, 1] on the device. ``overlap`` > 0
        overlaps the tiles and blends the seams (``merge_tiles``); 0 cuts a
        hard grid over the image padded to whole tiles (reflect, or edge
        when the pad reaches the image's size), as the reference's
        crop-wise evaluation."""
        img = image if isinstance(image, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(image))
        img = img.to(self.device)
        x = (uint8_to_pm1(img) if img.dtype == torch.uint8 else img.to(torch.float32)).permute(2, 0, 1)[None]
        _, _, h, w = x.shape
        scale = self.hp["sr_scale"]
        if overlap > 0 and h >= patch and w >= patch:
            tiles, coords = extract_tiles(x, patch, overlap)
            sr = self.upscale_batch_device(tiles.permute(0, 2, 3, 1), generator, noise=noise,
                                           progress_cb=progress_cb, callback_steps=callback_steps)
            out = merge_tiles(sr.permute(0, 3, 1, 2), coords, (h * scale, w * scale), scale=scale,
                              overlap=overlap, n=1)
            return out[0].permute(1, 2, 0)
        ph, pw = -(-h // patch) * patch, -(-w // patch) * patch
        mode = "reflect" if ph - h < h and pw - w < w else "replicate"
        x = F.pad(x, (0, pw - w, 0, ph - h), mode=mode)
        patches, grid = extract_patches(x, patch)
        sr = self.upscale_batch_device(patches.permute(0, 2, 3, 1), generator, noise=noise,
                                       progress_cb=progress_cb, callback_steps=callback_steps)
        out = merge_patches(sr.permute(0, 3, 1, 2), grid, n=1)
        return out[0, :, : h * scale, : w * scale].permute(1, 2, 0)

    def upscale_large(self, image, patch: int = 64, overlap: int = 0, generator: torch.Generator | None = None,
                      noise=None, progress_cb: ProgressCb | None = None, callback_steps: int = 1) -> np.ndarray:
        """As :meth:`upscale_large_device`, returned on the host."""
        return self.upscale_large_device(image, patch, overlap, generator, noise, progress_cb,
                                         callback_steps).cpu().numpy()
