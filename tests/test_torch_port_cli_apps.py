"""The port's command line and Streamlit apps on the CPU (``--device cpu``),
at the tiny configuration of the JAX package's ``tests/test_cli.py``.

Each subcommand writes the files and prints the lines that
``tests/test_cli.py`` expects of the JAX CLI; the apps' pure functions
(pipeline loading from their environment variables, the tiled-or-whole
choice, the uint8 conversion) are called directly, and both apps import
with ``streamlit`` absent.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dgm_img_super_resolution_tpu_torch.apps import st_app_sd, st_app_srdiff
from dgm_img_super_resolution_tpu_torch.apps.cli import main
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY

HP = "hidden_size=8,rrdb_num_block=2,rrdb_num_feat=8,timesteps=4,unet_dim_mults=1|2,compute_dtype=float32"
TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=4, unet_dim_mults="1|2",
            compute_dtype="float32")
CPU = ["-hp", HP, "--device", "cpu"]


@pytest.fixture
def img_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    g = np.random.default_rng(0)
    for name in ("a.png", "b.png"):
        Image.fromarray(g.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / name)
    return d


@pytest.fixture
def ckpt(tmp_path):
    """An upstream-format checkpoint of seeded random weights at ``TINY``."""
    sd = SRDiffPipeline(Hparams(TINY, seed=5), device="cpu").model.state_dict()
    path = tmp_path / "model_ckpt_steps_7.ckpt"
    torch.save({"state_dict": {"model": {f"model.{k}": v for k, v in sd.items()}}, "global_step": 7}, path)
    return path


def test_cli_infer(tmp_path, img_dir, ckpt, capsys):
    out = tmp_path / "sr.png"
    assert main(["infer", str(img_dir / "a.png"), str(out)] + CPU) == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)
    assert capsys.readouterr().out.strip().endswith(f"| wrote {out} (64x64)")
    # from the checkpoint file, with progress on stderr
    assert main(["infer", str(img_dir / "a.png"), str(out), "--ckpt", str(ckpt), "--progress"] + CPU) == 0
    assert "4/4" in capsys.readouterr().err
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)
    assert main(["infer", str(img_dir / "a.png"), str(out), "--patch", "8"] + CPU) == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)


def test_cli_infer_odd_size(tmp_path):
    src = tmp_path / "odd.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (15, 17, 3), dtype=np.uint8)).save(src)
    out = tmp_path / "sr_odd.png"
    assert main(["infer", str(src), str(out)] + CPU) == 0
    assert np.asarray(Image.open(out)).shape == (60, 68, 3)


def test_cli_eval(img_dir, capsys):
    assert main(["eval", str(img_dir / "a.png")] + CPU) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"psnr", "ssim", "lpips", "lr_psnr"}
    assert np.isnan(res["lpips"]) and all(np.isfinite(res[k]) for k in ("psnr", "ssim", "lr_psnr"))


def test_cli_test_dir_eval_and_op_point(tmp_path, img_dir, capsys):
    gen = tmp_path / "gen"
    assert main(["test", str(img_dir), "--gen_dir", str(gen)] + CPU) == 0
    assert sorted(os.listdir(gen)) == ["a.png", "b.png"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:2]] == ["| a.png", "| b.png"]
    assert {"psnr", "ssim", "lr_psnr"} <= set(json.loads(lines[-1]))
    gen2 = tmp_path / "gen2"
    argv = ["test", str(img_dir), "--gen_dir", str(gen2), "--no_png", "--check-op-point", "--op-point-images", "1"]
    assert main(argv + CPU) == 0
    assert os.listdir(gen2) == ["op_point_check.json"]
    res = json.loads((gen2 / "op_point_check.json").read_text())
    assert set(res) == {"operating_point", "ancestral_mean_psnr_vs_hr", "op_mean_psnr_vs_hr", "delta_db", "tol_db",
                        "within_tol", "n_images"}
    assert res["n_images"] == 1
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("| op-point check: ")
    assert main(["test"] + CPU) == 2  # no input directory


def test_cli_interp(tmp_path, img_dir, capsys):
    out = tmp_path / "mix.png"
    assert main(["interp", str(img_dir / "a.png"), str(img_dir / "b.png"), str(out), "--lam", "0.3"] + CPU) == 0
    assert np.asarray(Image.open(out)).shape == (16, 16, 3)
    assert capsys.readouterr().out.strip() == f"| wrote {out} (lam=0.3)"


def test_srdiff_app_functions(tmp_path, ckpt, monkeypatch):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str) else f"{k}: {v}\n" for k, v in TINY.items()))
    pipe = st_app_srdiff.load_pipeline({"SRDIFF_CONFIG": str(cfg), "SRDIFF_CKPT": str(ckpt)}, device="cpu")
    want = torch.load(ckpt, weights_only=False)["state_dict"]["model"]
    assert all(torch.equal(v, want[f"model.{k}"]) for k, v in pipe.model.state_dict().items())
    seen = []
    lr = np.random.default_rng(2).integers(0, 256, (12, 12, 3), dtype=np.uint8)
    sr = st_app_srdiff.enhance(pipe, lr, lambda d, t: seen.append((d, t)))
    assert sr.shape == (48, 48, 3) and sr.dtype == np.uint8 and seen[-1] == (4, 4)
    monkeypatch.setattr(st_app_srdiff, "WHOLE_MAX", 8)
    monkeypatch.setattr(st_app_srdiff, "TILE", 4)  # 12x12 is now served in 9 tiles of 4
    seen.clear()
    tiled = st_app_srdiff.enhance(pipe, lr, lambda d, t: seen.append((d, t)))
    assert tiled.shape == (48, 48, 3) and seen[-1] == (4, 4)
    # without a checkpoint file: seeded random weights
    rand = st_app_srdiff.load_pipeline({"SRDIFF_CONFIG": str(cfg), "SRDIFF_CKPT": str(tmp_path / "none")},
                                       device="cpu")
    assert not torch.equal(rand.model.state_dict()["rrdb.conv_first.weight"], pipe.model.state_dict()["rrdb.conv_first.weight"])


def test_sd_app_functions(tmp_path):
    from safetensors.torch import save_file

    # 32 noise-level classes: the app serves at the pipeline's default noise level 20
    kw = dict(dtype=torch.float32, unet_config=dict(UNET_TINY, num_class_embeds=32), vae_config=VAE_TINY,
              text_config=CLIP_TINY)
    pipe, from_ckpt = st_app_sd.load_pipeline({}, device="cpu", **kw)
    assert not from_ckpt
    for comp, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text_encoder", pipe.text_encoder)):
        (tmp_path / comp).mkdir()
        save_file(module.state_dict(), str(tmp_path / comp / "model.safetensors"))
    loaded, from_ckpt = st_app_sd.load_pipeline({"SD_X4_CKPT_DIR": str(tmp_path)}, device="cpu", **kw)
    assert from_ckpt
    lr = st_app_sd.prepare_input(Image.fromarray(np.zeros((30, 40, 3), np.uint8)))
    assert lr.shape == (128, 128, 3) and lr.dtype == np.uint8
    small = np.random.default_rng(3).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    pipe.generator.manual_seed(4)
    loaded.generator.manual_seed(4)
    fracs = []
    a = st_app_sd.upscale(pipe, "", small, fracs.append, num_steps=2)
    b = st_app_sd.upscale(loaded, "", small, num_steps=2)
    assert a.shape == (16, 16, 3) and a.dtype == np.uint8 and fracs == [0.5, 1.0]
    np.testing.assert_array_equal(a, b)


def test_apps_import_without_streamlit(monkeypatch):
    import importlib

    monkeypatch.setitem(sys.modules, "streamlit", None)  # an import of it raises
    for app in (st_app_sd, st_app_srdiff):
        importlib.reload(app)
        with pytest.raises(ImportError):
            app.main()
