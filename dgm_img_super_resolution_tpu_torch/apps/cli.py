"""Command line of the port: ``dgmsr-torch infer | train | eval | test |
interp`` (counterpart of the JAX package's ``apps/cli.py``, with its
arguments and printed lines).

Every subcommand runs on the CUDA device unless ``--device`` names another
(``--device cpu`` runs the plain PyTorch versions). ``--ckpt`` loads the
upstream SRDiff checkpoint; without it the weights are a seeded random init.
``train`` trains SRDiff on a directory of DIV2K-style images into
``work_dir`` (``--exp_name`` sets it to ``checkpoints/<name>``), resuming
from its newest checkpoint; under ``torchrun`` it joins the process group
first and trains data-parallel over its ranks (``parallel/mesh.py``:
``hp['mesh_shape']`` names the ``dp`` axis, every rank by default), each
rank on its own card (``--device cpu``: gloo on the CPU), rank 0 printing
and writing. The JAX CLI's ``bench`` is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from dgm_img_super_resolution_tpu_torch.ops.image import unit_to_uint8


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default="", help="YAML config path")
    p.add_argument("--exp_name", type=str, default="", help="experiment name")
    p.add_argument("-hp", "--hparams", type=str, default="", help="dotted overrides, e.g. lr=1e-4,res=false")
    p.add_argument("--ckpt", type=str, default="", help="upstream SRDiff checkpoint (model_ckpt_steps_*.ckpt)")
    p.add_argument("--device", type=str, default="", help="torch device; the CUDA device by default")


def _hparams(args):
    from dgm_img_super_resolution_tpu_torch.core.config import set_hparams

    return set_hparams(args.config, args.exp_name, args.hparams)


def _pipeline(args, hp):
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    return SRDiffPipeline(hp, ckpt_path=args.ckpt or None, device=args.device or None)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def _save(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _hr_lr(path: str, scale: int):
    """An HR image cropped to a multiple of ``scale`` and its MATLAB-bicubic LR."""
    from dgm_img_super_resolution_tpu_torch.ops.resize import imresize

    hr = _read_rgb(path)
    hr = hr[: hr.shape[0] // scale * scale, : hr.shape[1] // scale * scale]
    return hr, imresize(hr, scale=1.0 / scale)


def _progress_bar(done: int, total: int) -> None:
    n = int(30 * done / total)
    sys.stderr.write(f"\r| sampling [{'#' * n}{'.' * (30 - n)}] {done}/{total}")
    sys.stderr.flush()
    if done == total:
        sys.stderr.write("\n")


def cmd_infer(args) -> int:
    pipe = _pipeline(args, _hparams(args))
    img = _read_rgb(args.input)
    if args.patch:
        sr = pipe.upscale_large(img, patch=args.patch)
    elif args.progress:
        # sampler progress on stderr (the reference's sample_tqdm), every 10 steps
        sr = pipe.upscale(img, progress_cb=_progress_bar, callback_steps=10)
    else:
        sr = pipe.upscale(img)
    out = unit_to_uint8(sr)
    _save(out, args.output)
    print(f"| wrote {args.output} ({out.shape[1]}x{out.shape[0]})")
    return 0


def cmd_train(args) -> int:
    import torch.distributed as dist

    from dgm_img_super_resolution_tpu_torch.data import DataLoader, DIV2KDataset
    from dgm_img_super_resolution_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask

    # a no-op on one process; joins the group under torchrun (gloo for --device cpu)
    joined = not dist.is_initialized() and init_distributed(backend="gloo" if args.device.startswith("cpu") else None)
    try:
        hp = _hparams(args)
        mesh = make_mesh(hp.get("mesh_shape", ""))
        size = hp.get("patch_size", 160)
        ds = DIV2KDataset(args.data_dir, scale_factor=hp["sr_scale"], hr_height=size, hr_width=size,
                          data_augmentation=hp["data_augmentation"], rank=mesh.rank)
        loader = DataLoader(ds, hp["batch_size"], num_workers=hp["num_workers"], endless=True, seed=hp["seed"],
                            mesh=mesh)
        trainer = SRDiffTask(hp).make_trainer(device=args.device or None, mesh=mesh)
        batches = iter(loader)
        try:
            trainer.fit(batches, hp["seed"], max_updates=args.max_updates or None)
        finally:
            batches.close()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


def cmd_eval(args) -> int:
    from dgm_img_super_resolution_tpu_torch.metrics import Measure

    hp = _hparams(args)
    pipe = _pipeline(args, hp)
    measure = Measure(device=pipe.device)
    scale = hp["sr_scale"]
    hr, lr = _hr_lr(args.input, scale)
    sr_u8 = unit_to_uint8(pipe.upscale(lr))
    res = measure.measure(sr_u8, hr, lr, scale)
    print(json.dumps({k: round(float(v), 4) for k, v in res.items()}))
    return 0


def cmd_test(args) -> int:
    """Directory evaluation: SR every image of the input directory, save
    the PNGs into the gen dir, print each image's metrics and their means
    (the reference's ``test_input_dir`` / ``gen_dir_name`` /
    ``test_save_png`` workflow); ``--check-op-point`` then re-checks the
    recorded operating point under the loaded weights."""
    from dgm_img_super_resolution_tpu_torch.metrics import Measure

    hp = _hparams(args)
    input_dir = args.input_dir or hp.get("test_input_dir", "")
    if not input_dir:
        print("no input dir (pass INPUT_DIR or set test_input_dir)", file=sys.stderr)
        return 2
    gen_dir = args.gen_dir or os.path.join(hp["work_dir"], hp.get("gen_dir_name", "") or "generated")
    save_png = hp.get("test_save_png", True) and not args.no_png
    os.makedirs(gen_dir, exist_ok=True)
    pipe = _pipeline(args, hp)
    measure = Measure(device=pipe.device)
    scale = hp["sr_scale"]
    names = sorted(f for f in os.listdir(input_dir) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    agg: dict[str, list] = {}
    pairs = []
    for name in names:
        hr, lr = _hr_lr(os.path.join(input_dir, name), scale)
        sr = pipe.upscale(lr) if not args.patch else pipe.upscale_large(lr, patch=args.patch)
        sr_u8 = unit_to_uint8(sr)
        if save_png:
            _save(sr_u8, os.path.join(gen_dir, name))
        res = measure.measure(sr_u8, hr, lr, scale)
        for k, v in res.items():
            agg.setdefault(k, []).append(float(v))
        if len(pairs) < args.op_point_images:
            pairs.append((lr, hr))
        print(f"| {name}: " + json.dumps({k: round(float(v), 4) for k, v in res.items()}))
    if agg:
        print(json.dumps({k: round(float(np.mean(v)), 4) for k, v in agg.items()}))
    if args.check_op_point and pairs:
        from dgm_img_super_resolution_tpu_torch.validation import validate_operating_point

        res = validate_operating_point(hp, pipe.model.state_dict(), pairs, device=pipe.device)
        print("| op-point check: " + json.dumps(res))
        with open(os.path.join(gen_dir, "op_point_check.json"), "w") as f:
            json.dump(res, f, indent=2)
        if not res["within_tol"]:
            print("| WARNING: operating point drifted beyond tolerance under these weights: re-run the "
                  "DDIM operating-point study to re-record", file=sys.stderr)
    return 0


def cmd_interp(args) -> int:
    """Latent interpolation between two HR images (``style_interp``,
    reference ``model.py:1093-1116``)."""
    pipe = _pipeline(args, _hparams(args))
    out = unit_to_uint8(pipe.interpolate(_read_rgb(args.img1), _read_rgb(args.img2), lam=args.lam))
    _save(out, args.output)
    print(f"| wrote {args.output} (lam={args.lam})")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="dgmsr-torch", description="SRDiff x4 super-resolution on the GPU")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("infer", help="super-resolve an image")
    _add_common(p)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--patch", type=int, default=0, help="patch size for tiled large-image SR")
    p.add_argument("--progress", action="store_true", help="show sampler progress on stderr")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("train", help="train SRDiff on DIV2K-style data")
    _add_common(p)
    p.add_argument("data_dir")
    p.add_argument("--max_updates", type=int, default=0)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="PSNR/SSIM/lr_psnr on an HR image")
    _add_common(p)
    p.add_argument("input")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("test", help="evaluate a directory of HR images (SR + metrics + PNGs)")
    _add_common(p)
    p.add_argument("input_dir", nargs="?", default="")
    p.add_argument("--gen_dir", type=str, default="")
    p.add_argument("--no_png", action="store_true")
    p.add_argument("--patch", type=int, default=0)
    p.add_argument("--check-op-point", dest="check_op_point", action="store_true",
                   help="re-validate the recorded DDIM operating point (ancestral chain vs fast sampler PSNR) "
                        "under the loaded weights; run this whenever a real checkpoint is imported")
    p.add_argument("--op-point-images", dest="op_point_images", type=int, default=2,
                   help="images used for the op-point check (first N of the dir)")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("interp", help="latent interpolation between two images")
    _add_common(p)
    p.add_argument("img1")
    p.add_argument("img2")
    p.add_argument("output")
    p.add_argument("--lam", type=float, default=0.5)
    p.set_defaults(fn=cmd_interp)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
