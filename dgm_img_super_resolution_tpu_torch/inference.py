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
itself. On the card a sampler call's graph keeps that call's working set
in its cache's memory pool, which the cache's graphs share: the budget
bounds the largest of them, as it bounds an eager call's peak.
``progress_cb(done, total)`` fires every ``callback_steps`` sampler
steps, counted across the chunks and images of a request; that path runs
the exact sampler (``enc_interval`` 1), as JAX's does.

One program (JAX ``inference.py:93 _sample_fn``). At world 1, without a
progress callback, a sampler call is one program from the LR batch on the
card to the SR batch (``_program``): pad, bicubic, the RRDB and the cond
projection, every sampler step, ``res2img``, the uint8 rounding. On the
card it is captured as one CUDA graph per call shape and static arguments
(``core/graphs.py``; the key: batch, LR size, input dtype, ``as_uint8``,
sampler, steps, eta, ``enc_interval``, the noise's shapes, the kernel
routing), replayed from the second call on; sub-batches and tiles replay
their chunk's graph. With a progress callback the same serve is a
segmented program (``_segmented``, JAX's ``_segment_fns``): a graph for
the prologue, one a segment of ``callback_steps`` steps and one for the
epilogue, the callback on the host between them, keyed as the program
plus ``callback_steps``. ``interpolate`` is one graph per HR shape and
``t`` (JAX's ``_interp_fn``), captured at a shape's second call. These
stay eager by design: a world above 1
(gloo's collectives run through the host), a noise hook that is a
callable, and everything under ``graphs.eager()`` or on the CPU.

Noise. A request served in one call takes a noise hook (see
``diffusion/gaussian.py``) or draws from a generator. A request served in
several calls takes a ``ChunkNoise``, which gives each call its own hook
by the chunk indices that lead to it, as the JAX package folds them into
its key; without one, each chunk draws from a generator seeded by a draw
from its parent's generator.

Data parallelism (``parallel/mesh.py``). Under a process group of W ranks
(``torchrun``) the pipeline's ``mesh`` (from ``hp['mesh_shape']``, every
rank on ``dp`` by default) holds the weights broadcast from rank 0, and
every rank returns the images of a one-process serve. A sampler call whose
batch W divides serves this rank's rows of it (over ``dp``, replicated over
``sp``) and gathers the whole batch. The budget is then one card's: a batch
that W divides may hold W times the budget, and sub-batches are sized in
multiples of W.

Spatial sharding (JAX ``inference.py:85 _spatial_serving``). A call whose
batch W does not divide (batch 1, the usual case) splits the image rows
over all W ranks instead, as JAX's ``shard_spatial`` splits them over every
mesh axis: JAX's rule (the padded LR rows divide by W, at least 2 a rank;
on the fast path, without a progress callback, the unpadded rows too),
and the port's own, that each rank's HR rows divide by 2^(stages - 1), so
that the UNet's Downsamples split evenly (GSPMD pads an uneven split; the
port does not). Every rank pads the whole LR batch and takes its rows of
the x4 bicubic (``resize(rows=)``), of the LR image and of the noise,
drawn or asked of the hook for the whole image; the sampler runs under
``parallel.mesh.row_split`` (the convs exchange halo rows) and
``kernels_disabled()``, as JAX's ``_with_pallas_disabled``: a kernel would
pad a shard's edges as the image's. The image rows are gathered at the
end. A request that passes JAX's rule but not the port's is served as a
batch that W does not divide, whole on every rank of a dp row, with a
warning that names the reason: placed otherwise than JAX places it, the
same images. Noise is drawn or asked of the hook for the whole batch and
sliced to the rows.

Weights: a state dict under the reference checkpoint's names, the upstream
checkpoint file itself (``ckpt_path``, through
``ckpt/torch_import.py:import_srdiff_checkpoint``), or a seeded random
init. ``interpolate`` mixes two HR images in the diffusion's latent space
(the reference's ``style_interp``).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.core.device import resolve_device
from dgm_img_super_resolution_tpu_torch.diffusion.gaussian import as_noise_hook
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.models.layers import kernels_disabled, routing_key
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
    gather_image_rows,
    gather_rows,
    make_mesh,
    replicate,
    row_split,
    shard_batch,
    shard_spatial,
    spatial_shardable,
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
        self._graphs = graphs.GraphCache()  # the captured serves, by call shape

    def _pad(self, h: int, w: int) -> tuple[int, int]:
        """LR pad that makes the HR grid divide by 2^(stages - 1)."""
        scale = self.hp["sr_scale"]
        div = 2 ** (len(self.hp.unet_dim_mults_tuple) - 1)
        ph = next(p for p in range(div + 1) if (h + p) * scale % div == 0)
        pw = next(p for p in range(div + 1) if (w + p) * scale % div == 0)
        return ph, pw

    def _rows_split_evenly(self, h: int) -> bool:
        """The port's own rule: each rank's HR rows of ``h`` padded LR rows
        divide by 2^(stages - 1)."""
        div = 2 ** (len(self.hp.unet_dim_mults_tuple) - 1)
        return h * self.hp["sr_scale"] % (self.mesh.world * div) == 0

    def _spatial_serving(self, n: int, h: int) -> bool:
        """A call of ``n`` images of ``h`` padded LR rows splits its image
        rows over every rank: the world does not divide the batch, JAX's
        ``spatial_shardable`` holds and the rows split evenly down the UNet."""
        return n % self.mesh.world != 0 and spatial_shardable(h, self.mesh) and self._rows_split_evenly(h)

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
        ndev = self.mesh.world
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
        """One sampler call over the whole batch: at world 1 without a
        progress callback one program (:meth:`_program`); else this rank's
        rows of it, or of its images' rows, then the whole batch gathered."""
        n, h, w = (int(v) for v in x.shape[:3])
        ph, pw = self._pad(h, w)
        scale = self.hp["sr_scale"]
        hr = ((h + ph) * scale, (w + pw) * scale)
        if isinstance(noise, ChunkNoise):
            noise = noise.hook((n, 3) + hr)
        if self.mesh.world == 1:
            if progress_cb is None:
                return self._program(x.to(self.device), gen, noise, as_uint8)
            return self._segmented(x.to(self.device), gen, noise, as_uint8, progress_cb, callback_steps)
        # JAX's fast path also wants the unpadded rows to split (inference.py:350)
        fast_ok = progress_cb is not None or ph == 0 or spatial_shardable(h, self.mesh)
        spatial = fast_ok and self._spatial_serving(n, h + ph)
        if fast_ok and not spatial and n % self.mesh.world and spatial_shardable(h + ph, self.mesh):
            logger.warning("serve: %d LR rows on %d ranks are not split: each rank's %d HR rows do not divide "
                           "by 2^(stages - 1) = %d, as the UNet's Downsamples need", h + ph, self.mesh.world,
                           (h + ph) * scale // self.mesh.world, 2 ** (len(self.hp.unet_dim_mults_tuple) - 1))
        rows = batch_rows(n, self.mesh)
        x = self._lr_in((x if spatial else shard_batch(x, self.mesh)).to(self.device))
        if spatial:
            # every rank holds the whole LR batch: its rows of the bicubic, of the LR and of the noise
            hr_rows = shard_spatial(hr[0], self.mesh)
            img_lr_up = resize(x, hr, variant="torch", rows=slice(hr_rows.start, hr_rows.stop))
            x = shard_spatial(h + ph, self.mesh).take(x, dim=2)
            whole = as_noise_hook(noise, (n, 3) + hr, self.device, gen)
            noise = lambda t: hr_rows.take(whole(t), dim=2)  # noqa: E731
        else:
            img_lr_up = resize(x, hr, variant="torch")
            if rows.split:
                # the whole batch's noise, drawn or asked of the hook, and this rank's rows of it
                whole = as_noise_hook(noise, (n,) + tuple(img_lr_up.shape[1:]), self.device, gen)
                noise = lambda t: rows.take(whole(t))  # noqa: E731
        with contextlib.ExitStack() as stack:
            if spatial:
                stack.enter_context(row_split(self.mesh))
                stack.enter_context(kernels_disabled())
            if progress_cb is None:
                img = self._sample(x, img_lr_up, gen, noise)
            else:
                fns, after = self._sampler_pieces(lambda inputs, _, g: self._prepare(x, img_lr_up, noise, g),
                                                  lambda inputs, st, g: self.model.res2img(st[0], st[2]),
                                                  lambda inputs: noise, progress_cb, callback_steps)
                img = graphs.run_pieces(fns, {}, gen, after)
        out = (img * 0.5 + 0.5).clamp(0.0, 1.0)
        out = gather_image_rows(out, hr_rows, self.mesh) if spatial else gather_rows(out, rows, self.mesh)
        return self._sr_out(out, h, w, as_uint8)

    def _program(self, x, gen, noise, as_uint8: bool) -> torch.Tensor:
        """The serve of one batch on this card as one program, JAX's
        ``_sample_fn`` (``inference.py:93``): on the card one captured CUDA
        graph per call shape (``core/graphs.py``), replayed from the second
        call on; eager on the CPU, under ``graphs.eager()``, and for a noise
        hook that is not tensors (a callable)."""
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)
        if not graphs.enabled(self.device) or noise_in is None:
            return self._serve_fn(x, gen, noise, as_uint8)
        hp = self.hp
        key = ("serve", tuple(x.shape), x.dtype, as_uint8, graphs.signature(noise), hp.get("sampler", "ddpm"),
               hp.get("sample_timesteps", 0), float(hp.get("ddim_eta", 0.0)), int(hp.get("enc_interval", 1) or 1),
               routing_key())

        def fn(inputs, g):
            return self._serve_fn(inputs["x"], g, None if noise is None else graphs.rebuild("noise", noise, inputs),
                                  as_uint8)

        return self._graphs.run(key, fn, {"x": x, **noise_in}, gen)

    def _serve_fn(self, x, gen, noise, as_uint8: bool) -> torch.Tensor:
        """What :meth:`_program` runs: the NHWC LR batch on the device ->
        [-1, 1], padded, its bicubic, the sampler, the image in [0, 1]
        cropped back (and rounded to uint8)."""
        h, w = (int(v) for v in x.shape[1:3])
        x = self._lr_in(x)
        img_lr_up = resize(x, tuple(v * self.hp["sr_scale"] for v in x.shape[2:]), variant="torch")
        img = self._sample(x, img_lr_up, gen, noise)
        return self._sr_out((img * 0.5 + 0.5).clamp(0.0, 1.0), h, w, as_uint8)

    def _segmented(self, x, gen, noise, as_uint8: bool, progress_cb: ProgressCb, callback_steps: int):
        """The progress path on this card, JAX's ``_segment_fns`` and
        ``_run_segmented`` (``inference.py:141-211``): the serve of
        :meth:`_serve_fn` with the exact sampler (``enc_interval`` 1) cut
        every ``callback_steps`` steps, ``progress_cb(done, total)`` on the
        host after each segment. On the card one segmented program per call
        shape (``core/graphs.py``: the prologue (pad, bicubic, RRDB, cond
        projection, x_T), a graph a segment, the epilogue), replayed from
        the second call on; eager where :meth:`_program` is."""
        h, w = (int(v) for v in x.shape[1:3])
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)

        def noise_of(inputs):
            return noise if noise is None or noise_in is None else graphs.rebuild("noise", noise, inputs)

        def prep(inputs, _, g):
            lr = self._lr_in(inputs["x"])
            up = resize(lr, tuple(v * self.hp["sr_scale"] for v in lr.shape[2:]), variant="torch")
            return self._prepare(lr, up, noise_of(inputs), g)

        def finish(inputs, st, g):
            return self._sr_out((self.model.res2img(st[0], st[2]) * 0.5 + 0.5).clamp(0.0, 1.0), h, w, as_uint8)

        fns, after = self._sampler_pieces(prep, finish, noise_of, progress_cb, callback_steps)
        inputs = {"x": x, **(noise_in or {})}
        if not graphs.enabled(self.device) or noise_in is None:
            return graphs.run_pieces(fns, inputs, gen, after)
        hp = self.hp
        key = ("progress", tuple(x.shape), x.dtype, as_uint8, graphs.signature(noise), hp.get("sampler", "ddpm"),
               hp.get("sample_timesteps", 0), float(hp.get("ddim_eta", 0.0)), max(1, int(callback_steps)),
               routing_key())
        return self._graphs.run_program(key, fns, inputs, gen, after)

    def _lr_in(self, x) -> torch.Tensor:
        """The NHWC uint8 [0, 255] or float [-1, 1] LR batch -> NCHW float32
        in [-1, 1], padded (reflect, or edge when the pad reaches the image's
        size)."""
        h, w = (int(v) for v in x.shape[1:3])
        ph, pw = self._pad(h, w)
        x = uint8_to_pm1(x) if x.dtype == torch.uint8 else x.to(torch.float32)
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            mode = "reflect" if ph < h and pw < w else "replicate"
            x = F.pad(x, (0, pw, 0, ph), mode=mode)
        return x

    def _sr_out(self, out, h: int, w: int, as_uint8: bool) -> torch.Tensor:
        """The NCHW SR batch in [0, 1] cropped to ``h`` x ``w`` LR pixels,
        NHWC (uint8 with ``as_uint8``)."""
        scale = self.hp["sr_scale"]
        out = out[:, :, : h * scale, : w * scale].permute(0, 2, 3, 1)
        return torch.round(out * 255.0).to(torch.uint8) if as_uint8 else out

    def _sample(self, x, img_lr_up, gen, noise) -> torch.Tensor:
        """The sampler in one go from the LR and its bicubic (NCHW) to the
        image in [-1, 1]."""
        d = self.model
        if self.hp.get("sampler", "ddpm") == "ddim":
            return d.ddim_sample(x, img_lr_up, num_steps=self.hp.get("sample_timesteps", 0) or None,
                                 eta=float(self.hp.get("ddim_eta", 0.0)), noise=noise, generator=gen,
                                 enc_interval=int(self.hp.get("enc_interval", 1) or 1))[0]
        return d.sample(x, img_lr_up, noise=noise, generator=gen)[0]

    def _prepare(self, x, img_lr_up, noise, gen) -> tuple:
        """The sampler's state before its first step: (x_T, the projected
        cond, the bicubic)."""
        xt, cond, _, _ = self.model.sample_prepare(x, img_lr_up, noise, gen)
        return xt, cond, img_lr_up

    def _sampler_pieces(self, prep: Callable, finish: Callable, noise_of: Callable, progress_cb: ProgressCb,
                        callback_steps: int) -> tuple[list, list]:
        """The exact sampler in segments of ``callback_steps`` steps as the
        pieces of ``graphs.run_pieces`` / ``GraphCache.run_program``:
        ``prep`` -> (x_T, cond, bicubic), a piece a segment, ``finish``;
        ``progress_cb(done, total)`` after each segment. A segment asks
        ``noise_of(inputs)`` for its noise, each step's by its timestep."""
        d = self.model
        ddim = self.hp.get("sampler", "ddpm") == "ddim"
        eta = float(self.hp.get("ddim_eta", 0.0))
        if ddim:
            ts, ts_prev = d.ddim_timesteps(self.hp.get("sample_timesteps", 0) or None)
        else:
            ts = list(range(d.num_timesteps - 1, -1, -1))
            ts_prev = [t - 1 for t in ts]
        bounds = list(range(0, len(ts), max(1, int(callback_steps)))) + [len(ts)]

        def segment(a: int, b: int) -> Callable:
            def fn(inputs, st, g):
                xt, cond, up = st
                hook = as_noise_hook(noise_of(inputs), tuple(up.shape), up.device, g)
                if ddim:
                    return d.ddim_segment(xt, cond, up, ts[a:b], ts_prev[a:b], hook, eta), cond, up
                return d.sample_segment(xt, cond, up, ts[a:b], hook), cond, up
            return fn

        segs = list(zip(bounds, bounds[1:]))
        fns = [prep] + [segment(a, b) for a, b in segs] + [finish]
        after = [None] + [lambda _, done=b: progress_cb(done, len(ts)) for _, b in segs] + [None]
        return fns, after

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
        takes it (NCHW at the HR shape). On the card one graph per HR shape,
        dtype and ``t`` (JAX's ``_interp_fn(t)``, ``inference.py:418``),
        ``lam`` a 0-d float32 input of it, as JAX traces it, so that a
        caller's second call at another mixing weight replays. Captured at
        a key's second call (``on_repeat``): the CLI's one ``interp`` call
        runs eagerly."""
        x1, x2 = (img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))
                  for img in (img1, img2))
        t = self.hp["timesteps"] - 1 if t is None else int(t)
        gen = generator or self.generator
        noise_in = {} if noise is None else graphs.tensor_inputs("noise", noise)
        inputs = {"x1": x1.to(self.device), "x2": x2.to(self.device),
                  "lam": torch.as_tensor(lam, dtype=torch.float32, device=self.device), **(noise_in or {})}

        def fn(inputs, g):
            def pm1(x):
                x = uint8_to_pm1(x) if x.dtype == torch.uint8 else x.to(torch.float32)
                return x.permute(2, 0, 1)[None]

            a, b = pm1(inputs["x1"]), pm1(inputs["x2"])
            h, w = a.shape[-2:]
            scale = self.hp["sr_scale"]
            lr = resize(a, (h // scale, w // scale), variant="matlab")
            lr_up = resize(lr, (h, w), variant="torch")
            nz = noise if not noise_in else graphs.rebuild("noise", noise, inputs)
            out = self.model.interpolate(a, b, lr, lr_up, t=t, lam=inputs["lam"], noise=nz, generator=g)
            return (out * 0.5 + 0.5).clamp(0.0, 1.0)[0].permute(1, 2, 0)

        if not graphs.enabled(self.device) or noise_in is None:
            out = fn(inputs, gen)
        else:
            key = ("interp", tuple(x1.shape), x1.dtype, x2.dtype, t, graphs.signature(noise), routing_key())
            out = self._graphs.run(key, fn, inputs, gen, on_repeat=True)
        return out.cpu().numpy()

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
