"""The port's training path around the step, on the CPU: the checkpoint
store (``ckpt/ckpt_io.py``), ``Trainer.fit`` (sanity validation,
``save_best``, the final save, resume, ``metrics.jsonl`` and TensorBoard
events that the JAX package's ``read_records`` reads), the DIV2K dataset
and loader against the JAX package's on the same PNGs, ``dgmsr-torch
train --device cpu``, the utils, and that the whole path imports no JAX
and needs the card unless it is asked for the CPU.

A tiny stack (hidden 16, mults 1|2, RRDB 2 blocks x 8, HR 32, B = 2).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dgm_img_super_resolution_tpu.data.div2k import DIV2KDataset as JaxDIV2K
from dgm_img_super_resolution_tpu.data.loader import DataLoader as JaxLoader
from dgm_img_super_resolution_tpu.utils.tbwriter import read_records
import dgm_img_super_resolution_tpu_torch as port
from dgm_img_super_resolution_tpu_torch.ckpt import ckpt_io
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.data import DataLoader, DIV2KDataset
from dgm_img_super_resolution_tpu_torch.models.factory import build_srdiff, init_srdiff_params
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
from dgm_img_super_resolution_tpu_torch.train.trainer import lr_at

from test_tbwriter import _decode_event

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(hidden_size=16, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=8, timesteps=100,
            patch_size=32, batch_size=2, num_workers=1, compute_dtype="float32", rrdb_ckpt="",
            tb_log_interval=1, save_codes=["models", "utils"])
HP_STR = ("hidden_size=16,unet_dim_mults=1|2,rrdb_num_block=2,rrdb_num_feat=8,compute_dtype=float32,patch_size=32,"
          "batch_size=2,num_workers=1,val_check_interval=0,tb_log_interval=1,rrdb_ckpt=,data_augmentation=true")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from torch's intra-op threads, and the
    suite runs several files at once on the host's cores: one thread here,
    the setting restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six PNGs from a seed, larger than the HR crop."""
    d = tmp_path_factory.mktemp("div2k")
    g = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(g.integers(0, 256, (40 + i, 44, 3), dtype=np.uint8)).save(d / f"{i:04d}.png")
    return str(d)


def fit(images, work_dir, max_updates, **kw):
    hp = Hparams(**dict(TINY, work_dir=str(work_dir), **kw))
    ds = DIV2KDataset(images, 4, 32, 32, data_augmentation=True)
    task = SRDiffTask(hp)
    trainer = task.make_trainer(device="cpu")
    val = task.make_val_fn([{k: v[None] for k, v in ds[i].items()} for i in range(2)])
    batches = iter(DataLoader(ds, 2, endless=True, num_workers=1))
    try:
        state = trainer.fit(batches, 0, max_updates=max_updates, val_fn=val)
    finally:
        batches.close()
    return trainer, state


def steps_in(d) -> list[int]:
    return [int(Path(p).stem.rsplit("_", 1)[1]) for p in ckpt_io.get_all_ckpts(str(d))]


# -------------------------------------------------------- checkpoint store
def test_store_keeps_the_newest_k_newest_first(tmp_path):
    for step in (1, 2, 3, 4):
        ckpt_io.save_checkpoint({"global_step": step, "x": torch.full((2,), float(step))}, str(tmp_path), step, 2)
    (tmp_path / "model_ckpt_steps_9.ckpt.tmp").write_bytes(b"cut mid-save")
    assert steps_in(tmp_path) == [4, 3]
    ckpt, step = ckpt_io.load_checkpoint(str(tmp_path))
    assert step == 4 and ckpt["x"].tolist() == [4.0, 4.0]
    assert ckpt_io.load_checkpoint(str(tmp_path), steps=3)[1] == 3
    assert ckpt_io.load_checkpoint(str(tmp_path / "none")) == (None, 0)


def test_fit_resumes_where_it_stopped(images, tmp_path):
    """Three updates (saves at 2 and 3), then a resumed fit to 5: the
    restored model, Adam state and step equal the step-3 checkpoint, the
    count and the learning rate go on from there, and keep-2 leaves 4, 5."""
    kw = dict(val_check_interval=2, num_ckpt_keep=2, decay_steps=2, num_sanity_val_steps=0)
    _, s3 = fit(images, tmp_path, 3, **kw)
    assert steps_in(tmp_path) == [3, 2]
    saved = ckpt_io.load_checkpoint(str(tmp_path))[0]
    hp = Hparams(**dict(TINY, work_dir=str(tmp_path), **kw))
    trainer = SRDiffTask(hp).make_trainer(device="cpu")
    state = trainer.init_state()
    trainer.restore(state, saved)
    assert state.step == 3 and state.optimizer.updates == 3
    for n, v in state.model.state_dict().items():
        assert torch.equal(v, s3.model.state_dict()[n]), n
    a, b = state.optimizer.adam.state_dict()["state"], s3.optimizer.adam.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"]) for i in b)
    _, s5 = fit(images, tmp_path, 5, **kw)
    assert s5.step == 5 and s5.optimizer.updates == 5
    assert all(float(st["step"]) == 5 for st in s5.optimizer.adam.state.values())
    assert s5.optimizer.adam.param_groups[0]["lr"] == lr_at(hp, 4) == 2e-4 * 0.25
    assert steps_in(tmp_path) == [5, 4]


def test_fit_validates_saves_best_and_on_exit_and_logs(images, tmp_path):
    """Sanity validation at step 0, validation and a best checkpoint at
    step 2, the final save at 3 (off the cadence), metrics.jsonl and TB
    events with the same scalars, and the package's sources copied."""
    trainer, _ = fit(images, tmp_path, 3, val_check_interval=2, num_sanity_val_steps=1, save_best=True)
    assert steps_in(tmp_path) == [3, 2] and steps_in(tmp_path / "best") == [2]
    lines = [json.loads(v) for v in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["step"] == 0 and "sanity_loss" in lines[0]
    assert [v["step"] for v in lines if "grad_norm" in v] == [1, 2, 3]
    assert [v["step"] for v in lines if "val_loss" in v] == [2]
    (tb,) = list((tmp_path / "tb").iterdir())
    recs = [_decode_event(r) for r in read_records(str(tb))]
    assert recs[0]["file_version"] == "brain.Event:2"
    got = {(r["step"], r["tag"]): r["simple_value"] for r in recs[1:]}
    for v in lines:
        for k, x in v.items():
            if k != "step":
                assert abs(got[(v["step"], k)] - x) <= 1e-6 * max(1.0, abs(x)), (v["step"], k)
    assert (tmp_path / "codes" / "models" / "unet.py").is_file()
    assert (tmp_path / "codes" / "utils" / "tbwriter.py").is_file()
    assert len(trainer.save_s) == 3  # best at 2, 2, 3


def test_val_fn_with_sample_metrics(images):
    """``make_val_fn(sample_metrics=True)``: the mean loss over the
    batches (the same on a second call: generators seeded 0, 1) and PSNR /
    SSIM of the T-step ``sample`` through ``Measure`` (T = 4 here)."""
    hp = Hparams(**dict(TINY, valid_steps=2, timesteps=4))
    task = SRDiffTask(hp)
    state = task.make_trainer(device="cpu").init_state()
    ds = DIV2KDataset(images, 4, 32, 32)
    val = task.make_val_fn([{k: v[None] for k, v in ds[i].items()} for i in range(3)], sample_metrics=True)
    a, b = val(state), val(state)
    assert sorted(a) == ["loss", "psnr", "ssim"] and a == b
    assert np.isfinite(a["loss"]) and 0 < a["psnr"] < 100 and -1 <= a["ssim"] <= 1


def test_serving_without_the_rrdb():
    """``use_rrdb`` false: the condition is the LR image (3 channels), which
    the UNet's projection takes; the pipeline serves (it raised before)."""
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    pipe = SRDiffPipeline(Hparams(**dict(TINY, use_rrdb=False, timesteps=4)), device="cpu")
    assert pipe.model.rrdb is None and pipe.model.denoise_fn.cond_proj.in_channels == 3
    out = pipe.upscale(np.full((8, 8, 3), 100, np.uint8))
    assert out.shape == (32, 32, 3) and np.isfinite(out).all()


def test_load_ckpt_partial_merge_shape_pruning_and_rrdb_ckpt(tmp_path):
    """``load_ckpt``: a sub-model by name, strict errors, the non-strict
    merge that keeps missing entries and skips shape mismatches; an
    upstream-format file (``model.`` names, the diffusion buffers beside
    them) too; and ``rrdb_ckpt`` loading the encoder at init."""
    src = init_srdiff_params(build_srdiff(Hparams(**TINY)), seed=1)
    sd = src.state_dict()
    path = str(tmp_path / "up.ckpt")
    upstream = {f"model.{k}": v for k, v in sd.items()} | {"model.betas": torch.zeros(100)}
    torch.save({"state_dict": {"model": upstream}, "global_step": 7}, path)
    wide = init_srdiff_params(build_srdiff(Hparams(**dict(TINY, hidden_size=32))), seed=2)
    before = {k: v.clone() for k, v in wide.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_io.load_ckpt(wide, path)
    ckpt_io.load_ckpt(wide, path, strict=False)
    merged = wide.state_dict()
    assert all(torch.equal(merged[k], sd[k]) for k in sd if k.startswith("rrdb."))
    assert torch.equal(merged["denoise_fn.mlp.0.weight"], before["denoise_fn.mlp.0.weight"])
    assert torch.equal(merged["denoise_fn.final_conv.1.bias"], sd["denoise_fn.final_conv.1.bias"])
    attn = build_srdiff(Hparams(**dict(TINY, use_attn=True)))
    with pytest.raises(KeyError, match="mid_attn"):
        ckpt_io.load_ckpt(attn, path)
    g_before = attn.denoise_fn.mid_attn.fn.g.clone()
    ckpt_io.load_ckpt(attn, path, strict=False)
    assert torch.equal(attn.denoise_fn.mid_attn.fn.g, g_before)
    rrdb = build_srdiff(Hparams(**TINY)).rrdb
    with pytest.raises(FileNotFoundError):
        ckpt_io.load_ckpt(rrdb, str(tmp_path), model_name="rrdb")  # a dir without step-named checkpoints
    assert ckpt_io.load_ckpt(rrdb, str(tmp_path), model_name="rrdb", force=False) is rrdb
    task = SRDiffTask(Hparams(**dict(TINY, rrdb_ckpt=path)))
    model = task.init_params(3)
    assert all(torch.equal(v, sd[f"rrdb.{k}"]) for k, v in model.rrdb.state_dict().items())
    fresh = init_srdiff_params(build_srdiff(Hparams(**TINY)), seed=3)
    assert torch.equal(model.denoise_fn.mlp[0].weight, fresh.denoise_fn.mlp[0].weight)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("augment", [False, True], ids=["resized", "augmented"])
def test_div2k_samples_match_jax(images, augment):
    """The same PNGs and seed: every sample within 1e-6 of JAX's, with the
    whole image resized, and with seeded crops and flips."""
    ours = DIV2KDataset(images, 4, 32, 32, data_augmentation=augment, seed=5)
    ref = JaxDIV2K(images, 4, 32, 32, data_augmentation=augment, seed=5)
    assert len(ours) == len(ref) == 6
    for i in list(range(6)) * 2:
        a, b = ours[i], ref[i]
        assert sorted(a) == ["hr", "lr", "lr_up"]
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == np.float32
            assert np.abs(a[k] - b[k]).max() <= 1e-6, (i, k)
    assert np.array_equal(DIV2KDataset(images, only_img=True)[2], JaxDIV2K(images, only_img=True)[2])


def test_loader_batches_and_order_match_jax(images):
    """Shuffled batches over two epochs (endless), the same order for the
    same seed as the JAX loader's."""
    ours = iter(DataLoader(DIV2KDataset(images, 4, 32, 32), 2, seed=3, num_workers=2, endless=True))
    ref = iter(JaxLoader(JaxDIV2K(images, 4, 32, 32), 2, seed=3, num_workers=2, endless=True))
    for _ in range(6):
        a, b = next(ours), next(ref)
        assert a["hr"].shape == (2, 32, 32, 3)
        assert all(np.abs(a[k] - b[k]).max() <= 1e-6 for k in a)
    ours.close()
    ref.close()
    assert len(DataLoader(list(range(5)), 2)) == 2 and len(DataLoader(list(range(5)), 2, drop_last=False)) == 3


def test_loader_raises_a_sample_error_instead_of_hanging():
    """A sample that fails (a file that does not decode) is raised by the
    iterator, after the batches before it."""
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise OSError("cannot decode 0004.png")
            return np.full((2,), i, np.float32)

    it = iter(DataLoader(Broken(), 2, shuffle=False, num_workers=2))
    assert next(it).tolist() == [[0, 0], [1, 1]] and next(it).tolist() == [[2, 2], [3, 3]]
    with pytest.raises(OSError, match="0004"):
        next(it)


# ------------------------------------------------------------ entry points
def test_cli_train_on_cpu(images, tmp_path):
    """``dgmsr-torch train DIR --max_updates 2 --device cpu``: two updates
    and the final checkpoint."""
    from dgm_img_super_resolution_tpu_torch.apps.cli import main

    work = tmp_path / "work"
    rc = main(["train", images, "--max_updates", "2", "--device", "cpu", "-hp", f"{HP_STR},work_dir={work}"])
    assert rc == 0 and steps_in(work) == [2]
    lines = [json.loads(v) for v in (work / "metrics.jsonl").read_text().splitlines()]
    assert [v["step"] for v in lines if "loss" in v] == [1, 2]
    assert ckpt_io.load_checkpoint(str(work))[0]["optimizer_states"][0]["updates"] == 2


def test_training_entry_points_need_cuda_unless_asked_for_cpu(images, monkeypatch, tmp_path):
    from dgm_img_super_resolution_tpu_torch.apps.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = SRDiffTask(Hparams(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        task.make_trainer()
    assert task.make_trainer(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", images, "--max_updates", "1", "-hp", f"{HP_STR},work_dir={tmp_path}"])


def test_training_path_imports_no_jax(images, tmp_path):
    """The isolation walk reaches the training modules, and a fit through
    the loader, validation, the checkpoint store and TensorBoard runs in a
    process where JAX cannot be imported."""
    pkg = Path(port.__file__).resolve().parent
    walked = {str(p.relative_to(pkg)) for p in pkg.rglob("*.py")}
    for mod in ("train/trainer.py", "train/tasks/srdiff.py", "data/div2k.py", "data/loader.py", "utils/misc.py",
                "utils/profiling.py", "utils/tbwriter.py", "ckpt/ckpt_io.py", "models/param_transforms.py"):
        assert mod in walked, mod
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from dgm_img_super_resolution_tpu_torch.apps.cli import main\n"
        f"rc = main(['train', {images!r}, '--max_updates', '2', '--device', 'cpu', '-hp',\n"
        f"           {HP_STR + ',val_check_interval=1,use_wn=true,ema_decay=0.5,work_dir=' + str(tmp_path)!r}])\n"
        "print('RC', rc)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "RC 0"
    assert steps_in(tmp_path) == [2, 1]


def test_utils(tmp_path):
    from dgm_img_super_resolution_tpu_torch import utils

    g = utils.set_seed(7)
    assert isinstance(g, torch.Generator) and torch.equal(torch.rand(3, generator=g),
                                                           torch.rand(3, generator=torch.Generator().manual_seed(7)))
    tree = {"a": np.ones((2, 3), np.float32), "b": [torch.zeros(2)], "c": 1}
    dev = utils.to_device(tree, "cpu")
    assert isinstance(dev["a"], torch.Tensor) and dev["c"] == 1
    assert utils.tensors_to_scalars({"x": torch.tensor([2.5])}) == {"x": 2.5}
    assert utils.tensors_to_np(dev)["a"].shape == (2, 3)
    assert utils.reduce_metrics({"loss": 1.0}) == {"loss": 1.0}
    assert utils.num_to_groups(10, 4) == [4, 4, 2] and utils.num_to_groups(8, 4) == [4, 4]
    it = utils.cycle([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    utils.plot_img(np.zeros((4, 4, 3), np.float32) - 1, str(tmp_path / "x.png"))
    assert np.asarray(Image.open(tmp_path / "x.png")).max() == 0
    assert os.path.isdir(utils.make_run_dir(str(tmp_path), "run"))
    timer = utils.StepTimer()
    with utils.profile_to(str(tmp_path / "prof")):
        for _ in range(3):
            with utils.trace_annotation("step"):
                torch.ones(4).sum()
            timer.tick()
    assert timer.steps_per_sec > 0 and timer.p50_latency > 0
    assert any((tmp_path / "prof").iterdir())
