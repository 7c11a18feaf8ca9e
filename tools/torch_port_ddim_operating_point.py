"""DDIM operating-point quality study on the PyTorch port (counterpart of
``tools/ddim_operating_point.py``, which runs the JAX package).

The port serves SRDiff x4 at a fast sampler mode (``DDIM_OPERATING_POINT.json``:
ddim20, eta 1). This tool measures, on the port and on one CUDA card, what
that choice rests on: it trains the full-width SRDiff (hidden 64, RRDB 8 x 32,
mults 1|2|3|4, T = 100 cosine, bf16) on random 160^2 crops of two images,
then upscales a fixed centre region of each with every sampler mode of
:data:`MODES` and reports, per mode and image:

- PSNR / SSIM against the ground-truth HR region (the quality number), and
- PSNR / SSIM against the T = 100 ancestral golden (the sampler's fidelity).

The operating point is the mode with the fewest steps within 0.1 dB of the
ancestral chain's mean PSNR-vs-HR (:func:`choose_operating_point`); the seed
floor (the chain against itself at another seed) is reported beside it. The
encoder-propagation modes (``enc_interval`` 2, 3) are measured and never
chosen. Beyond the JAX record, the port's record holds ``device`` (the
card's name and power limit), ``images``, ``kernels_vs_plain`` (the chosen
mode and ``ddpm100`` served again with every kernel region on its plain
PyTorch version, ``models/layers.py:kernels_disabled``, at the same seeds)
and ``launches`` (the kernels that the training, each mode and each
``kernels_vs_plain`` serve launched, from the wrappers' counters).

The intended images are the reference's photos (``cat_img.png`` and
``car_img.png``): pass their directory as ``--image-dir`` and their names as
``--files``. Without ``--image-dir`` the tool writes two seeded 768^2
synthetic images (:func:`synthetic_image`: smooth shading, hard edges at
many angles, textures at several scales, mild noise) into
``<work-dir>/images`` and studies those.

Both phases resume: the trainer checkpoints every 250 updates into
``--work-dir`` and a second run continues from the newest checkpoint; each
finished mode is kept in ``eval_partial.json`` and ``goldens.npz`` (and its
launches in ``study_state.json``), so a killed run redoes only the mode it
was in.

Usage, from the root of a checkout (the CUDA device by default; with none
and no ``--device`` it raises):

    python tools/torch_port_ddim_operating_point.py [--train-steps 3000]
        [--batch 16] [--hr-size 512] [--seed 7] [--modes K1,K2,...]
        [--out DDIM_OPERATING_POINT_TORCH.json] [--work-dir DIR]
        [--image-dir DIR --files A.png,B.png] [--kernels-vs-plain K1,...]
        [--device D] [-hp "key=value,..."]

``-hp`` overrides the study's hparams (a tiny CPU run: ``--device cpu -hp
"hidden_size=16,unet_dim_mults=1|2,rrdb_num_block=2,rrdb_num_feat=8,timesteps=8,patch_size=32"``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgm_img_super_resolution_tpu_torch.core import graphs  # noqa: E402
from dgm_img_super_resolution_tpu_torch.core.config import Hparams, _apply_dotted  # noqa: E402
from dgm_img_super_resolution_tpu_torch.core.device import card_description, resolve_device  # noqa: E402

# (sampler, steps, eta, key, seed offset from --seed, enc_interval): the JAX
# tool's sweep in its order. Ancestral T = 100 at two seeds (the second
# bounds the seed-noise floor), DDIM at eta 0 and 1, then encoder
# propagation (the UNet's down path recomputed every K-th step only), which
# is measured and never chosen.
MODES = (
    ("ddpm", 100, 0.0, "ddpm100", 0, 1),
    ("ddpm", 100, 0.0, "ddpm100_seed2", 1, 1),
    ("ddim", 10, 0.0, "ddim10_eta0", 0, 1),
    ("ddim", 20, 0.0, "ddim20_eta0", 0, 1),
    ("ddim", 8, 1.0, "ddim8_eta1", 0, 1),
    ("ddim", 10, 1.0, "ddim10_eta1", 0, 1),
    ("ddim", 20, 1.0, "ddim20_eta1", 0, 1),
    ("ddim", 50, 1.0, "ddim50_eta1", 0, 1),
    ("ddim", 20, 1.0, "ddim20_eta1_ep2", 0, 2),
    ("ddim", 30, 1.0, "ddim30_eta1_ep2", 0, 2),
    ("ddim", 30, 1.0, "ddim30_eta1_ep3", 0, 3),
)
TOL_DB = 0.1  # "within 0.1 dB of the ancestral chain"
SYNTHETIC_SIZE = 768
SYNTHETIC_FILES = ("synth0_img.png", "synth1_img.png")


def mode_list(seed: int, keys: str | None = None) -> list[tuple]:
    """:data:`MODES` with their seeds, as the JAX tool's ``modes`` at
    ``--seed``; ``keys`` (comma-separated) keeps those modes only."""
    modes = [(s, n, eta, key, seed + off, k) for s, n, eta, key, off, k in MODES]
    if keys:
        keep = set(keys.split(","))
        modes = [m for m in modes if m[3] in keep]
        missing = keep - {m[3] for m in modes}
        if missing:
            raise ValueError(f"unknown mode keys: {sorted(missing)}")
    return modes


# ------------------------------------------------------------------ images
def _value_noise(g: np.random.Generator, size: int, cell: int) -> np.ndarray:
    """Smooth noise in [-1, 1] with features about ``cell`` pixels wide: a
    random grid, resized bicubically to ``size``."""
    from PIL import Image

    n = max(2, size // cell + 2)
    grid = Image.fromarray(g.uniform(-1.0, 1.0, (n, n)).astype(np.float32), mode="F")
    up = np.asarray(grid.resize((size + 2 * cell, size + 2 * cell), Image.BICUBIC), np.float32)
    return np.clip(up[cell: cell + size, cell: cell + size], -1.0, 1.0)


def _stripes(g: np.random.Generator, size: int, period: float) -> np.ndarray:
    """A square wave of ``period`` pixels at a random angle, in [-1, 1]."""
    theta = g.uniform(0.0, np.pi)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    phase = (xx * np.cos(theta) + yy * np.sin(theta)) / period
    return np.where(np.floor(phase + g.uniform()) % 2 == 0, 1.0, -1.0).astype(np.float32)


def _shape_mask(g: np.random.Generator, size: int) -> np.ndarray:
    """An anti-aliased mask in [0, 1] of one random shape (a triangle, a
    rotated rectangle, a polygon or a rotated ellipse, so edges at every
    angle), drawn at twice the size and reduced."""
    from PIL import Image, ImageDraw

    s2 = 2 * size
    cx, cy = g.uniform(0.05, 0.95, 2) * s2
    r = g.uniform(0.04, 0.22) * s2
    rot = g.uniform(0.0, 2 * np.pi)
    kind = int(g.integers(0, 4))
    if kind == 0:  # a triangle
        ang = rot + np.sort(g.uniform(0, 2 * np.pi, 3))
        pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
    elif kind == 1:  # a rotated rectangle
        a, b = r, r * g.uniform(0.2, 1.0)
        corners = np.array([[-a, -b], [a, -b], [a, b], [-a, b]])
        rm = np.array([[np.cos(rot), -np.sin(rot)], [np.sin(rot), np.cos(rot)]])
        pts = corners @ rm.T + [cx, cy]
    elif kind == 2:  # a star-shaped polygon of 5-9 vertices
        k = int(g.integers(5, 10))
        ang = rot + np.linspace(0, 2 * np.pi, k, endpoint=False)
        rad = r * g.uniform(0.45, 1.0, k)
        pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
    else:  # a rotated ellipse
        ang = np.linspace(0, 2 * np.pi, 96, endpoint=False)
        a, b = r, r * g.uniform(0.3, 1.0)
        x, y = a * np.cos(ang), b * np.sin(ang)
        pts = np.stack([cx + x * np.cos(rot) - y * np.sin(rot), cy + x * np.sin(rot) + y * np.cos(rot)], 1)
    im = Image.new("L", (s2, s2), 0)
    ImageDraw.Draw(im).polygon([tuple(p) for p in pts.tolist()], fill=255)
    return np.asarray(im.resize((size, size), Image.BOX), np.float32) / 255.0


def synthetic_image(seed: int, size: int = SYNTHETIC_SIZE) -> np.ndarray:
    """An HWC uint8 RGB image from ``seed`` (numpy and PIL only) that holds
    what a photo gives a x4 model to recover: smooth shading (a colour
    gradient and low-frequency light), hard anti-aliased edges at many
    angles (40 random shapes), textures at several scales (stripes of 3-24
    pixel periods and smooth noise of 2-48 pixel features inside shapes,
    and over the background) and mild sensor noise (sigma 2 levels)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    c0, c1 = g.uniform(40, 215, (2, 3)).astype(np.float32)
    t = (xx * np.cos(g.uniform(0, 2 * np.pi)) + yy * np.sin(g.uniform(0, 2 * np.pi)) + 1.0) / 3.0
    img = c0 + (c1 - c0) * t[..., None]
    img += 30.0 * _value_noise(g, size, 192)[..., None]  # low-frequency light
    img += 10.0 * _value_noise(g, size, 6)[..., None] * g.uniform(0.5, 1.0, 3).astype(np.float32)  # fine grain
    light = 1.0 + 0.25 * _value_noise(g, size, 256)  # shading that also falls on the shapes
    for _ in range(40):
        mask = _shape_mask(g, size)[..., None]
        colour = g.uniform(0, 255, 3).astype(np.float32)
        texture = int(g.integers(0, 4))
        if texture == 0:  # flat, shaded by a gradient of its own
            fill = colour * (0.8 + 0.4 * t[..., None])
        elif texture == 1:  # stripes
            fill = colour + g.uniform(20, 60) * _stripes(g, size, float(g.choice([3, 5, 8, 13, 24])))[..., None]
        elif texture == 2:  # smooth noise at a random scale
            cell = int(g.choice([2, 4, 8, 16, 48]))
            fill = colour + g.uniform(25, 70) * _value_noise(g, size, cell)[..., None]
        else:  # a second colour in stripes of smooth noise: texture at two scales
            other = g.uniform(0, 255, 3).astype(np.float32)
            w = (_stripes(g, size, float(g.choice([6, 10, 16]))) * 0.5 + 0.5)[..., None]
            fill = colour * w + other * (1 - w) + 20.0 * _value_noise(g, size, 3)[..., None]
        img = img * (1.0 - mask) + fill * mask
    img = img * light[..., None] + g.normal(0.0, 2.0, img.shape).astype(np.float32)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def write_synthetic_images(image_dir: str, seed: int, size: int = SYNTHETIC_SIZE) -> list[str]:
    """:data:`SYNTHETIC_FILES` from ``seed`` (image i from ``[seed, i]``)
    as PNGs in ``image_dir``, each unless it is there already, stored
    without compression (the training iterator decodes an image a sample,
    twice as fast so); returns the file names."""
    from PIL import Image

    os.makedirs(image_dir, exist_ok=True)
    for i, name in enumerate(SYNTHETIC_FILES):
        path = os.path.join(image_dir, name)
        if not os.path.exists(path):
            img = synthetic_image(int(np.random.SeedSequence([seed, i]).generate_state(1)[0]), size)
            Image.fromarray(img).save(path, compress_level=0)
    return list(SYNTHETIC_FILES)


# ------------------------------------------------------------------ data
def make_train_iter(batch: int, hr: int, scale: int, seed: int, image_dir: str, files: list[str]):
    """Endless batches of ``batch`` random ``hr``^2 crops (flipped half the
    time) of ``files``: numpy float32 ``hr``, ``lr``, ``lr_up`` in [-1, 1],
    drawn on the host in the caller's thread, as the JAX tool's."""
    from dgm_img_super_resolution_tpu_torch.data.div2k import DIV2KDataset

    ds = DIV2KDataset(image_dir, scale_factor=scale, hr_height=hr, hr_width=hr, data_augmentation=True,
                      seed=seed, file_list=list(files))
    rng = np.random.default_rng(seed)

    def it():
        while True:
            idx = rng.integers(0, len(ds), size=batch)
            samples = [ds[i] for i in idx]
            yield {k: np.stack([s[k] for s in samples]).astype(np.float32) for k in ("hr", "lr", "lr_up")}

    return it()


def eval_regions(hr_size: int, scale: int, image_dir: str, files: list[str]) -> dict:
    """The centre ``hr_size``^2 crop of each image (``hr_u8``) and its LR
    by the ``pil`` resize in [-1, 1] (``lr_pm1``), keyed by the file name up
    to its first underscore."""
    from PIL import Image

    from dgm_img_super_resolution_tpu_torch.data.div2k import _resize_np

    regions = {}
    for f in files:
        with Image.open(os.path.join(image_dir, f)) as im:
            img = np.asarray(im.convert("RGB"))
        y0 = (img.shape[0] - hr_size) // 2
        x0 = (img.shape[1] - hr_size) // 2
        hr = img[y0: y0 + hr_size, x0: x0 + hr_size].astype(np.float32)
        lr = _resize_np(hr, (hr_size // scale, hr_size // scale), "pil")
        regions[f.split("_")[0]] = {
            "hr_u8": np.clip(hr, 0, 255).astype(np.uint8),
            "lr_pm1": np.clip(lr, 0, 255).astype(np.float32) / 127.5 - 1.0,
        }
    return regions


# ------------------------------------------------------------------ launches
def launch_names(deltas: dict) -> dict:
    """``graphs.count_deltas`` by name: ``<wrapper><attribute's suffix>``
    (``block_chain3_wgmma`` for ``block_chain3.launches_wgmma``) and a
    counter kept by shape summed by width, ``<wrapper>_c<C>``."""
    out: dict[str, int] = {}
    for (fn, attr), d in deltas.items():
        name = fn.__name__
        if isinstance(d, dict):
            for shape, n in d.items():
                out[f"{name}_c{shape[0]}"] = out.get(f"{name}_c{shape[0]}", 0) + int(n)
        else:
            out[name + attr[len("launches"):]] = int(d)
    return dict(sorted((k, v) for k, v in out.items() if v))


@contextlib.contextmanager
def counting(into: dict):
    """Fill ``into`` with the kernels launched inside the block
    (:func:`launch_names`); the counters themselves are left running."""
    # every wrapper imported, so registered with its counters, before the first reading
    from dgm_img_super_resolution_tpu_torch.ops.kernels import (  # noqa: F401
        block_chain, conv3x3, flash_attention, group_norm, tail_fuse)

    before = graphs.counts()
    try:
        yield into
    finally:
        into.update(launch_names(graphs.count_deltas(before, graphs.counts())))


# ------------------------------------------------------------------ the study
def train(hp, steps: int, batch: int, seed: int, image_dir: str, files: list[str], work_dir: str,
          device) -> tuple[dict, dict]:
    """Train ``SRDiffTask(hp)`` for ``steps`` updates from ``work_dir``'s
    newest checkpoint; returns (the trained params as a state dict, what
    this call did: ``updates``, ``wall_s``, ``loader_wait_s``, ``launches``)."""
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    task = SRDiffTask(hp)
    trainer = task.make_trainer(device=device)
    trainer.work_dir = work_dir
    drawn = [0]

    def counted(it):
        for b in it:
            drawn[0] += 1
            yield b

    data = counted(make_train_iter(batch, hp.get("patch_size", 160), hp["sr_scale"], seed, image_dir, files))
    launches: dict = {}
    t0 = time.perf_counter()
    with counting(launches):
        state = trainer.fit(data, generator=seed, max_updates=steps, resume=True)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    info = {"updates": drawn[0], "wall_s": time.perf_counter() - t0, "loader_wait_s": trainer.loader_wait_s,
            "launches": launches}
    # the params, not the EMA, as the JAX tool serves state.params
    params = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    dev = trainer.device
    del trainer, state
    _free(dev)
    return params, info


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def mode_hparams(hp, sampler: str, steps: int, eta: float, enc_k: int):
    return hp.replace(sampler=sampler, sample_timesteps=steps if sampler == "ddim" else 0, ddim_eta=eta,
                      enc_interval=enc_k)


def _serve(pipe, lr_pm1: np.ndarray, skey: int, name: str, noise) -> np.ndarray:
    """One image at batch 1 (the study's regions are under the HR-pixel
    budget, so untiled), as uint8; its noise from a generator seeded by
    the mode's seed, or the hook ``noise(skey, name)``."""
    if noise is None:
        out = pipe.upscale(lr_pm1, generator=torch.Generator(device=pipe.device).manual_seed(int(skey)))
    else:
        out = pipe.upscale(lr_pm1, noise=noise(skey, name))
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def evaluate(hp, params: dict, regions: dict, modes: list[tuple], results: dict, goldens: dict, noise=None, *,
             device=None, work_dir: str | None = None, launches: dict | None = None, measure=None) -> dict:
    """Serve every region with each mode not yet in ``results``, one
    ``SRDiffPipeline`` a mode (freed before the next), and add the mode's
    PSNR / SSIM against the HR (and against ``ddpm100``'s golden images)
    to ``results``, its kernels' launches to ``launches``. After each mode
    ``results`` goes to ``<work_dir>/eval_partial.json`` and the goldens to
    ``goldens.npz``, as the JAX tool keeps them."""
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure

    measure = measure or Measure(device=device)
    launches = {} if launches is None else launches
    for sampler, steps, eta, key, skey, enc_k in modes:
        if key in results:
            continue
        pipe = SRDiffPipeline(mode_hparams(hp, sampler, steps, eta, enc_k), params=params, device=device)
        entry = {"sampler": sampler, "steps": steps, "eta": eta, "enc_interval": enc_k}
        with counting(launches.setdefault(key, {})):
            for name, reg in regions.items():
                t0 = time.time()
                u8 = _serve(pipe, reg["lr_pm1"], skey, name, noise)
                dt = time.time() - t0
                if key == "ddpm100":
                    goldens[name] = u8
                entry[name] = {
                    "psnr_vs_hr": measure.psnr(u8, reg["hr_u8"]),
                    "ssim_vs_hr": measure.ssim(u8, reg["hr_u8"]),
                    "wall_s_incl_compile": round(dt, 2),
                }
                if key != "ddpm100" and name in goldens:
                    entry[name]["psnr_vs_golden"] = measure.psnr(u8, goldens[name])
                    entry[name]["ssim_vs_golden"] = measure.ssim(u8, goldens[name])
        results[key] = entry
        dev = pipe.device
        del pipe
        _free(dev)
        print(f"| {key:14s} mean PSNR-vs-HR {np.mean([entry[n]['psnr_vs_hr'] for n in regions]):.3f} dB",
              flush=True)
        if work_dir:
            if key == "ddpm100":
                np.savez(os.path.join(work_dir, "goldens.npz"), **goldens)
            with open(os.path.join(work_dir, "eval_partial.json"), "w") as f:
                json.dump(results, f)
    return results


def choose_operating_point(results: dict, modes: list[tuple], regions) -> tuple[dict | None, float, float]:
    """(the operating point, ``ddpm100``'s mean PSNR-vs-HR, the seed floor):
    the pure modes after the first two (``enc_interval`` 1), by steps in a
    stable sort (eta 0 before eta 1 at equal steps, as listed), the first
    whose mean PSNR-vs-HR is within :data:`TOL_DB` of ``ddpm100``'s, or
    None. The seed floor is ``ddpm100``'s mean less ``ddpm100_seed2``'s."""
    ddpm_mean = np.mean([results["ddpm100"][n]["psnr_vs_hr"] for n in regions])
    seed_floor = float(ddpm_mean - np.mean([results["ddpm100_seed2"][n]["psnr_vs_hr"] for n in regions]))
    pure = [m for m in modes[2:] if m[5] == 1]
    for sampler, steps, eta, key, _, _k in sorted(pure, key=lambda m: m[1]):
        if key not in results:
            continue
        mean = np.mean([results[key][n]["psnr_vs_hr"] for n in regions])
        if ddpm_mean - mean <= TOL_DB:
            return ({"sampler": sampler, "steps": steps, "eta": eta, "mode": key,
                     "delta_db_vs_ddpm100": round(float(ddpm_mean - mean), 4)}, float(ddpm_mean), seed_floor)
    return None, float(ddpm_mean), seed_floor


def kernels_vs_plain(hp, params: dict, regions: dict, modes: list[tuple], keys, noise=None, *, device=None,
                     launches: dict | None = None, measure=None) -> dict:
    """Each mode of ``keys`` served twice at its seed, through the kernels
    and with every region on its plain version (``kernels_disabled()``):
    per image the PSNR-vs-HR of each and the PSNR of the kernels' image
    against the plain one; per mode the mean gap (kernels less plain) in
    dB. The launches of each routing go to ``launches[key]``."""
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure
    from dgm_img_super_resolution_tpu_torch.models.layers import kernels_disabled

    measure = measure or Measure(device=device)
    launches = {} if launches is None else launches
    by_key = {m[3]: m for m in modes}
    out = {}
    for key in keys:
        sampler, steps, eta, _, skey, enc_k = by_key[key]
        pipe = SRDiffPipeline(mode_hparams(hp, sampler, steps, eta, enc_k), params=params, device=device)
        imgs: dict = {}
        for routing in ("kernels", "plain"):
            with counting(launches.setdefault(key, {}).setdefault(routing, {})):
                with kernels_disabled() if routing == "plain" else contextlib.nullcontext():
                    imgs[routing] = {name: _serve(pipe, reg["lr_pm1"], skey, name, noise)
                                     for name, reg in regions.items()}
        entry = {name: {"psnr_vs_hr_kernels": measure.psnr(imgs["kernels"][name], reg["hr_u8"]),
                        "psnr_vs_hr_plain": measure.psnr(imgs["plain"][name], reg["hr_u8"]),
                        "psnr_kernels_vs_plain": measure.psnr(imgs["kernels"][name], imgs["plain"][name])}
                 for name, reg in regions.items()}
        entry["mean_gap_db"] = float(np.mean([entry[n]["psnr_vs_hr_kernels"] - entry[n]["psnr_vs_hr_plain"]
                                              for n in regions]))
        out[key] = entry
        dev = pipe.device
        del pipe
        _free(dev)
        print(f"| {key:14s} kernels vs plain: PSNR-vs-HR gap {entry['mean_gap_db']:+.4f} dB", flush=True)
    return out


def config_line(hp) -> str:
    return (f"hidden={hp['hidden_size']} nb={hp['rrdb_num_block']} nf={hp['rrdb_num_feat']} "
            f"gc={hp['rrdb_num_feat'] // 2} mults={hp['unet_dim_mults']} T={hp['timesteps']} "
            f"{hp['beta_schedule']}")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hr-size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="DDIM_OPERATING_POINT_TORCH.json")
    ap.add_argument("--work-dir", default=os.path.join(ROOT, "build", "ddim_study_wd"),
                    help="persistent trainer work dir: a killed run resumes from the last periodic checkpoint "
                         "and the last finished mode")
    ap.add_argument("--modes", default=None, help="comma-separated mode keys to run (default: the full sweep)")
    ap.add_argument("--image-dir", default="", help="directory of the images (default: two synthetic images "
                                                      "written into <work-dir>/images)")
    ap.add_argument("--files", default="", help="comma-separated image names in --image-dir (default: all)")
    ap.add_argument("--kernels-vs-plain", default="",
                    help="comma-separated mode keys served again on the plain versions (default: the chosen "
                         "mode and ddpm100)")
    ap.add_argument("--device", default="", help="torch device; the CUDA device by default")
    ap.add_argument("-hp", "--hparams", default="", help="overrides of the study's hparams, key=value,...")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or None)

    # val_check_interval=250 (no val_fn): a periodic checkpoint, so that a killed run resumes
    hp = Hparams(compute_dtype="bfloat16", val_check_interval=250)
    _apply_dotted(hp, args.hparams)
    scale = hp["sr_scale"]
    os.makedirs(args.work_dir, exist_ok=True)
    if args.image_dir:
        image_dir = args.image_dir
        files = args.files.split(",") if args.files else sorted(
            f for f in os.listdir(image_dir) if f.lower().endswith((".png", ".jpg", ".jpeg")))
        images: list[str] | str = files
    else:
        image_dir = os.path.join(args.work_dir, "images")
        files = write_synthetic_images(image_dir, args.seed)
        images = f"synthetic, seed {args.seed}"
    state_path = os.path.join(args.work_dir, "study_state.json")
    study = {"train": {"updates": 0, "launches": {}}, "modes": {}, "kernels_vs_plain": {}, "kvp_launches": {}}
    if os.path.exists(state_path):
        with open(state_path) as f:
            study = json.load(f)

    def keep():
        with open(state_path, "w") as f:
            json.dump(study, f)

    card = card_description(device)
    print(f"| device={card}  training {args.train_steps} steps batch={args.batch} on {images}", flush=True)
    params, info = train(hp, args.train_steps, args.batch, args.seed, image_dir, files, args.work_dir, device)
    if info["updates"]:
        tr = study["train"]
        tr["updates"] += info["updates"]
        tr["launches"] = {k: tr["launches"].get(k, 0) + info["launches"].get(k, 0)
                          for k in sorted(set(tr["launches"]) | set(info["launches"]))}
        keep()
        print(f"| trained {info['updates']} updates in {info['wall_s']:.1f} s: "
              f"{1e3 * info['wall_s'] / info['updates']:.1f} ms an update fed by the host, "
              f"{1e3 * info['loader_wait_s'] / info['updates']:.1f} ms of it waiting on the data", flush=True)

    regions = eval_regions(args.hr_size, scale, image_dir, files)
    modes = mode_list(args.seed, args.modes)
    partial_path = os.path.join(args.work_dir, "eval_partial.json")
    golden_path = os.path.join(args.work_dir, "goldens.npz")
    results: dict = {}
    goldens: dict = {}
    if os.path.exists(partial_path):
        with open(partial_path) as f:
            results = json.load(f)
        if os.path.exists(golden_path):
            goldens = dict(np.load(golden_path))
        print(f"| resuming eval: {sorted(results)} done", flush=True)
    from dgm_img_super_resolution_tpu_torch.metrics.measure import Measure

    measure = Measure(device=device)
    for m in modes:
        if m[3] not in results:
            evaluate(hp, params, regions, [m], results, goldens, device=device, work_dir=args.work_dir,
                     launches=study["modes"], measure=measure)
            keep()

    chosen, ddpm_mean, seed_floor = choose_operating_point(results, modes, regions)
    check = args.kernels_vs_plain.split(",") if args.kernels_vs_plain else (
        [chosen["mode"]] if chosen else []) + ["ddpm100"]
    check = [k for k in dict.fromkeys(check) if k not in study["kernels_vs_plain"]]
    if check:
        study["kernels_vs_plain"].update(kernels_vs_plain(
            hp, params, regions, modes, check, device=device, launches=study["kvp_launches"],
            measure=measure))
        keep()
    rec = {
        "config": config_line(hp),
        "train_steps": args.train_steps,
        "batch": args.batch,
        "hr_size": args.hr_size,
        "device": card,
        "ddpm100_mean_psnr_vs_hr": round(ddpm_mean, 4),
        "seed_noise_floor_db": round(seed_floor, 4),
        "operating_point": chosen,
        "results": results,
        "images": images,
        "kernels_vs_plain": study["kernels_vs_plain"],
        "launches": {"train": study["train"], "modes": study["modes"],
                     "kernels_vs_plain": study["kvp_launches"]},
    }
    print(json.dumps(rec, indent=2))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"| wrote {args.out}")
    return rec


if __name__ == "__main__":
    main()
