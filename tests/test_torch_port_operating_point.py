"""The port's DDIM operating-point study (``tools/torch_port_ddim_operating_point.py``)
held against the JAX package's (``tools/ddim_operating_point.py``) on the CPU.

The JAX tool is imported as a file, its ``_REF_DIR`` and ``_FILES`` pointed
at a directory of two small PNGs (``cat_img.png``, ``car_img.png``) that
both tools read.

- The training iterator: the same batches for two seeds (JAX's and the
  port's ``DIV2KDataset`` with the same crops and flips, bit for bit).
- The evaluation regions: the HR crops uint8-exact, the LR to 1e-6.
- ``MODES``: a literal copy of the JAX tool's sweep (``:164-176``).
- ``choose_operating_point`` against a copy of the JAX tool's rule
  (``:231-246``) on hand-made results: eta 0 before eta 1 at equal steps,
  the encoder-propagation modes never chosen, None when no mode is within
  0.1 dB, the seed floor.
- ``evaluate`` on a tiny model (hidden 8, RRDB 2 x 8, mults 1|2, T = 8,
  float32) against the JAX tool's loop over JAX's ``SRDiffPipeline``: the
  same random JAX params carried across by ``ckpt/jax_params.py``, the port
  fed JAX's noise for each mode's key (``torch_port_helpers.jax_noise``);
  the ancestral chain, ddim4 eta 1 and ddim4 eta 1 at ``enc_interval`` 2.
  Outputs to 1e-4 in float and +-1 in uint8 (``test_torch_port_pipeline.py``'s
  bounds), PSNR to 0.01 dB.
- ``main`` at a tiny size, 2 updates: the record has the JAX record's keys
  (``backend`` given as ``device``) plus ``images``, ``kernels_vs_plain``
  and ``launches``; a second call with the same work dir neither trains
  nor serves and writes the same record.
- The synthetic images: deterministic by seed, and not flat (edges and
  texture).
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.metrics.measure import Measure as JaxMeasure
from dgm_img_super_resolution_tpu_torch import inference
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.train import trainer as port_trainer

from chip_smoke import json_keys_of
from torch_port_helpers import jax_noise, random_jax_params

ROOT = Path(__file__).resolve().parents[1]
JAX_TOOL = ROOT / "tools" / "ddim_operating_point.py"
FILES = ["cat_img.png", "car_img.png"]
TINY = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2",
            compute_dtype="float32")
TINY_HP = "hidden_size=8,rrdb_num_block=2,rrdb_num_feat=8,timesteps=8,unet_dim_mults=1|2,compute_dtype=float32," \
          "patch_size=32,save_codes=[]"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jtool = _load(JAX_TOOL, "jax_ddim_operating_point")
tool = _load(ROOT / "tools" / "torch_port_ddim_operating_point.py", "port_ddim_operating_point")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def images(tmp_path, monkeypatch):
    """Two small PNGs of unequal sizes, the JAX tool pointed at them."""
    d = tmp_path / "images"
    d.mkdir()
    for i, (f, size) in enumerate(zip(FILES, (72, 88))):
        Image.fromarray(tool.synthetic_image(i, size=size)).save(d / f)
    monkeypatch.setattr(jtool, "_REF_DIR", str(d))
    monkeypatch.setattr(jtool, "_FILES", list(FILES))
    return str(d)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 7])
def test_train_iter_matches_jax(images, seed):
    want, got = jtool.make_train_iter(3, 32, 4, seed), tool.make_train_iter(3, 32, 4, seed, images, FILES)
    for _ in range(3):
        a, b = next(want), next(got)
        assert sorted(a) == sorted(b) == ["hr", "lr", "lr_up"]
        for k in a:
            assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])


def test_eval_regions_match_jax(images):
    want, got = jtool.eval_regions(48, 4), tool.eval_regions(48, 4, images, FILES)
    assert list(got) == list(want) == ["cat", "car"]
    for name in want:
        assert got[name]["hr_u8"].dtype == np.uint8 and got[name]["hr_u8"].shape == (48, 48, 3)
        np.testing.assert_array_equal(got[name]["hr_u8"], want[name]["hr_u8"])
        assert got[name]["lr_pm1"].dtype == np.float32 and got[name]["lr_pm1"].shape == (12, 12, 3)
        np.testing.assert_allclose(got[name]["lr_pm1"], want[name]["lr_pm1"], rtol=0, atol=1e-6)


# ------------------------------------------------------------------ modes
def _jax_modes(seed):
    """A literal copy of ``tools/ddim_operating_point.py:164-176`` at
    ``args.seed = seed``."""
    return [
        ("ddpm", 100, 0.0, "ddpm100", seed, 1),
        ("ddpm", 100, 0.0, "ddpm100_seed2", seed + 1, 1),
        ("ddim", 10, 0.0, "ddim10_eta0", seed, 1),
        ("ddim", 20, 0.0, "ddim20_eta0", seed, 1),
        ("ddim", 8, 1.0, "ddim8_eta1", seed, 1),
        ("ddim", 10, 1.0, "ddim10_eta1", seed, 1),
        ("ddim", 20, 1.0, "ddim20_eta1", seed, 1),
        ("ddim", 50, 1.0, "ddim50_eta1", seed, 1),
        ("ddim", 20, 1.0, "ddim20_eta1_ep2", seed, 2),
        ("ddim", 30, 1.0, "ddim30_eta1_ep2", seed, 2),
        ("ddim", 30, 1.0, "ddim30_eta1_ep3", seed, 3),
    ]


def test_modes_are_jax_sweep():
    assert list(tool.MODES) == _jax_modes(0)
    assert tool.mode_list(7) == _jax_modes(7)
    assert tool.mode_list(7, "ddim20_eta1,ddpm100") == [_jax_modes(7)[0], _jax_modes(7)[6]]
    with pytest.raises(ValueError, match="unknown mode keys"):
        tool.mode_list(7, "ddim7")


def _jax_choose(results, modes, regions):
    """A copy of the JAX tool's rule, ``tools/ddim_operating_point.py:231-246``."""
    ddpm_mean = np.mean([results["ddpm100"][n]["psnr_vs_hr"] for n in regions])
    seed_floor = float(
        ddpm_mean - np.mean([results["ddpm100_seed2"][n]["psnr_vs_hr"] for n in regions])
    )
    chosen = None
    pure = [m for m in modes[2:] if m[5] == 1]
    for sampler, steps, eta, key, _, _k in sorted(pure, key=lambda m: m[1]):
        if key not in results:
            continue
        mean = np.mean([results[key][n]["psnr_vs_hr"] for n in regions])
        if ddpm_mean - mean <= 0.1:
            chosen = {"sampler": sampler, "steps": steps, "eta": eta, "mode": key,
                      "delta_db_vs_ddpm100": round(float(ddpm_mean - mean), 4)}
            break
    return chosen, float(ddpm_mean), seed_floor


def _results(means: dict) -> dict:
    """Hand-made results: each mode's two images 0.3 dB either side of its mean."""
    return {k: {"cat": {"psnr_vs_hr": m + 0.3}, "car": {"psnr_vs_hr": m - 0.3}} for k, m in means.items()}


BASE = {"ddpm100": 40.0, "ddpm100_seed2": 40.05}
CHOOSE_CASES = {
    # eta 0 listed before eta 1 at 10 steps: a stable sort keeps it first
    "eta0_before_eta1": (dict(BASE, ddim10_eta0=39.95, ddim10_eta1=39.99, ddim8_eta1=39.5), "ddim10_eta0"),
    # the _ep modes sit within 0.1 dB at fewer steps than anything chosen, and are skipped
    "ep_never_chosen": (dict(BASE, ddim20_eta1_ep2=40.2, ddim30_eta1_ep3=40.0, ddim50_eta1=39.95,
                             ddim20_eta1=39.0), "ddim50_eta1"),
    "none_within": (dict(BASE, ddim8_eta1=39.0, ddim20_eta1=39.89, ddim50_eta1=38.0, ddim20_eta1_ep2=40.0), None),
    "fewest_steps": (dict(BASE, ddim8_eta1=39.91, ddim10_eta1=40.3, ddim20_eta1=40.1, ddim10_eta0=36.0), "ddim8_eta1"),
    "missing_modes_skipped": (dict(BASE, ddim20_eta0=39.0, ddim20_eta1=40.0), "ddim20_eta1"),
}


@pytest.mark.parametrize("case", sorted(CHOOSE_CASES))
def test_choose_operating_point_matches_jax(case):
    means, mode = CHOOSE_CASES[case]
    results, modes, regions = _results(means), tool.mode_list(7), ("cat", "car")
    got = tool.choose_operating_point(results, modes, regions)
    assert got == _jax_choose(results, modes, regions)
    chosen, ddpm_mean, seed_floor = got
    assert (chosen and chosen["mode"]) == mode
    assert ddpm_mean == pytest.approx(40.0) and seed_floor == pytest.approx(-0.05)


# ------------------------------------------------------------------ evaluate
EVAL_MODES = [("ddpm", 100, 0.0, "ddpm100", 7, 1), ("ddim", 4, 1.0, "ddim4_eta1", 7, 1),
              ("ddim", 4, 1.0, "ddim4_eta1_ep2", 8, 2)]


def _jax_loop(hp, params, regions, modes):
    """The JAX tool's evaluation loop (``tools/ddim_operating_point.py:185-230``):
    (results, each mode's float outputs by image)."""
    measure = JaxMeasure()
    results, goldens, outs = {}, {}, {}
    for sampler, steps, eta, key, skey, enc_k in modes:
        mhp = hp.replace(sampler=sampler, sample_timesteps=steps if sampler == "ddim" else 0, ddim_eta=eta,
                         enc_interval=enc_k)
        pipe = JaxPipeline(mhp, params=params)
        results[key] = {"sampler": sampler, "steps": steps, "eta": eta, "enc_interval": enc_k}
        for name, reg in regions.items():
            out = pipe.upscale(reg["lr_pm1"], jax.random.PRNGKey(skey))
            outs[key, name] = out
            u8 = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
            if key == "ddpm100":
                goldens[name] = u8
            results[key][name] = {"psnr_vs_hr": measure.psnr(u8, reg["hr_u8"]),
                                  "ssim_vs_hr": measure.ssim(u8, reg["hr_u8"])}
            if key != "ddpm100" and name in goldens:
                results[key][name]["psnr_vs_golden"] = measure.psnr(u8, goldens[name])
                results[key][name]["ssim_vs_golden"] = measure.ssim(u8, goldens[name])
    return results, outs


def test_evaluate_matches_jax_loop(images, tmp_path, monkeypatch):
    jhp = JHparams(TINY)
    _, params = random_jax_params(jhp, 3)
    regions = tool.eval_regions(32, 4, images, FILES)
    want, want_outs = _jax_loop(jhp, params, regions, EVAL_MODES)

    outs = []
    upscale = inference.SRDiffPipeline.upscale

    def spy(self, image, generator=None, noise=None, **kw):
        outs.append(upscale(self, image, generator=generator, noise=noise, **kw))
        return outs[-1]

    monkeypatch.setattr(inference.SRDiffPipeline, "upscale", spy)

    def noise(skey, name):
        return jax_noise(jax.random.PRNGKey(skey), (1, 32, 32, 3), range(TINY["timesteps"]))

    results, goldens, launches = {}, {}, {}
    tool.evaluate(Hparams(TINY), jax_params_to_state_dict(params), regions, EVAL_MODES, results, goldens, noise,
                  device="cpu", work_dir=str(tmp_path), launches=launches)
    assert list(results) == list(want)
    for i, (_, _, _, key, _, _) in enumerate(EVAL_MODES):
        for j, name in enumerate(regions):
            got, ref = outs[i * len(regions) + j], np.asarray(want_outs[key, name])
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
            u8 = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.int16)  # noqa: E731
            assert np.abs(u8(got) - u8(ref)).max() <= 1
            w, g = want[key][name], results[key][name]
            assert sorted(g) == sorted(list(w) + ["wall_s_incl_compile"])
            for metric in w:
                tol = 0.01 if metric.startswith("psnr") else 1e-3
                assert g[metric] == pytest.approx(w[metric], abs=tol), (key, name, metric)
        assert {k: results[key][k] for k in ("sampler", "steps", "eta", "enc_interval")} == \
               {k: want[key][k] for k in ("sampler", "steps", "eta", "enc_interval")}
    # the records a killed run resumes from, and no kernel launched on the CPU
    assert json.loads((tmp_path / "eval_partial.json").read_text()) == json.loads(json.dumps(results))
    saved = np.load(tmp_path / "goldens.npz")
    assert sorted(saved.files) == sorted(regions) and all((saved[n] == goldens[n]).all() for n in regions)
    assert launches == {key: {} for _, _, _, key, _, _ in EVAL_MODES}
    # a mode already in the results is not served again
    n = len(outs)
    tool.evaluate(Hparams(TINY), jax_params_to_state_dict(params), regions, EVAL_MODES, results, goldens, noise,
                  device="cpu")
    assert len(outs) == n


# ------------------------------------------------------------------ main
def test_main_writes_the_record_and_resumes(images, tmp_path, monkeypatch):
    out, wd = tmp_path / "rec.json", tmp_path / "wd"
    argv = ["--device", "cpu", "--train-steps", "2", "--batch", "2", "--hr-size", "32", "--work-dir", str(wd),
            "--out", str(out), "--image-dir", images, "--files", ",".join(FILES), "--modes",
            "ddpm100,ddpm100_seed2,ddim8_eta1",
            "-hp", TINY_HP]
    rec = tool.main(argv)
    jax_keys = json_keys_of(JAX_TOOL, "operating_point")
    assert list(rec) == [("device" if k == "backend" else k) for k in jax_keys] + \
        ["images", "kernels_vs_plain", "launches"]
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["device"] == "cpu" and rec["images"] == FILES and rec["train_steps"] == 2
    assert rec["config"] == "hidden=8 nb=2 nf=8 gc=4 mults=1|2 T=8 cosine"
    assert sorted(rec["results"]) == ["ddim8_eta1", "ddpm100", "ddpm100_seed2"]
    # eta 1 over all T steps is the ancestral chain: chosen at ~0 dB, served again on the plain versions
    assert rec["operating_point"]["mode"] == "ddim8_eta1"
    assert abs(rec["operating_point"]["delta_db_vs_ddpm100"]) < 0.01
    assert list(rec["kernels_vs_plain"]) == ["ddim8_eta1", "ddpm100"]
    assert rec["kernels_vs_plain"]["ddim8_eta1"]["mean_gap_db"] == 0.0  # the CPU runs the plain versions
    assert rec["launches"] == {"train": {"updates": 2, "launches": {}},
                               "modes": {k: {} for k in ("ddpm100", "ddpm100_seed2", "ddim8_eta1")},
                               "kernels_vs_plain": {k: {"kernels": {}, "plain": {}}
                                                    for k in ("ddim8_eta1", "ddpm100")}}
    for key, entry in rec["results"].items():
        for name in ("cat", "car"):
            assert all(np.isfinite(entry[name][k]) for k in ("psnr_vs_hr", "ssim_vs_hr"))
    # ddim8 eta 1 is the T = 8 chain itself: at the golden's seed it serves the golden image
    assert all(rec["results"]["ddim8_eta1"][n]["psnr_vs_golden"] == float("inf") for n in ("cat", "car"))
    assert all(np.isfinite(rec["results"]["ddpm100_seed2"][n]["psnr_vs_golden"]) for n in ("cat", "car"))

    def refuse(*a, **kw):
        raise AssertionError("a resumed study trained or served again")

    monkeypatch.setattr(port_trainer.Trainer, "train_step", refuse)
    monkeypatch.setattr(inference.SRDiffPipeline, "upscale", refuse)
    out.unlink()
    assert tool.main(argv) == rec
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))


# ------------------------------------------------------------------ images
def test_synthetic_images_are_deterministic_and_not_flat(tmp_path):
    a, b, c = tool.synthetic_image(3, size=160), tool.synthetic_image(3, size=160), tool.synthetic_image(4, 160)
    assert a.dtype == np.uint8 and a.shape == (160, 160, 3)
    np.testing.assert_array_equal(a, b)
    assert (a != c).mean() > 0.5
    for img in (a, c):
        x = img.astype(np.float32)
        assert (x.std(axis=(0, 1)) > 20).all()  # shading and colour, not a flat field
        grad = np.abs(np.diff(x, axis=1)).max(axis=2)
        assert (grad > 60).mean() > 0.005  # hard edges
        assert np.median(grad) > 1.0  # texture and noise everywhere, not smooth fills
    files = tool.write_synthetic_images(str(tmp_path), 5, size=96)
    assert files == list(tool.SYNTHETIC_FILES)
    again = tool.write_synthetic_images(str(tmp_path / "again"), 5, size=96)
    for i, f in enumerate(files):
        with Image.open(tmp_path / f) as im, Image.open(tmp_path / "again" / f) as im2:
            assert im.size == (96, 96) and im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), np.asarray(im2))
        with Image.open(tmp_path / f) as im, Image.open(tmp_path / files[1 - i]) as other:
            assert (np.asarray(im) != np.asarray(other)).mean() > 0.5
    assert again == files



def test_drift_warnings_name_the_port_study(caplog):
    """A drifted operating point sends the user to the port's own study,
    which exists (``validation.py`` and ``dgmsr-torch test --check-op-point``)."""
    import inspect

    from dgm_img_super_resolution_tpu_torch import validation
    from dgm_img_super_resolution_tpu_torch.apps import cli
    from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params

    path = "tools/torch_port_ddim_operating_point.py"
    assert (ROOT / path).is_file()
    hp = Hparams(TINY)
    model = build_srdiff(hp)
    init_srdiff_params(model, seed=0)
    g = np.random.default_rng(2)
    pairs = [(g.integers(0, 256, (4, 4, 3), dtype=np.uint8), g.integers(0, 256, (16, 16, 3), dtype=np.uint8))]
    op = {"sampler": "ddim", "steps": 2, "eta": 1.0, "enc_interval": 1}
    with caplog.at_level("WARNING", logger="dgm_img_super_resolution_tpu_torch.validation"):
        res = validation.validate_operating_point(hp, model.state_dict(), pairs, op=op, tol_db=-1e9, device="cpu")
    assert not res["within_tol"]
    assert path in caplog.text and "DDIM_OPERATING_POINT.json" in caplog.text
    assert path in inspect.getsource(cli.cmd_test)
