"""The port's example scripts (``examples_torch/``) held against the JAX
package's (``examples/``) on the CPU.

- ``examples_torch/common.py``: ``batches`` (the index order over epochs),
  ``save_grid`` (the PNG's bytes) and ``get_mnist`` (synthetic, 28 and 32)
  equal JAX's ``examples/common.py`` bit for bit.
- Each script builds the task and ``Hparams`` JAX's script builds from the
  same arguments: both scripts run until the task would train, where a
  patched ``make_trainer`` / ``init_state`` hands the task back.
- The AE path of ``train_vae``: both scripts train 3 updates on the same
  batches (a small MNIST IDX directory written here), the port from JAX's
  initial parameters (carried across by ``ckpt/jax_params.py``). Bounds as
  ``tests/test_torch_port_train_step.py``'s, in units of the learning rates
  applied (``lr_sum``): an Adam update is about +-lr whatever the gradient,
  so an element whose gradient is as small as the frameworks' float32
  differences may step the other way, by up to 2 ``lr_sum``
  (``PARAM_ALL``). Where none steps the other way the parameters agree
  within ``PARAM_STEADY`` (1e-3) ``lr_sum``, so the reconstruction of
  ``x[:16]`` lies within ``PARAM_STEADY`` of its own move over the 3
  updates (the updates move every parameter by about ``lr_sum``), plus one
  float32 forward's differences (``FWD_TOL``, the samples' bound of
  ``tests/test_torch_port_edu_tasks.py``); a wrong rate, clip or moment
  moves it by a good part of that move.
- Each script's ``main([..., "--device", "cpu"])`` at tiny settings writes
  its PNG at JAX's name and size (4 columns: 128x128 at 32², 112x112 at
  28²); with no card and no ``--device`` a script raises at once.

The two helper modules are both ``common``: JAX's is loaded from its file
under a name of its own, and JAX's scripts find it through
``sys.modules['common']`` for the length of a test; the port's scripts
import ``examples_torch.common``.
"""

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.train.tasks import gan as jgan
from dgm_img_super_resolution_tpu.train.tasks import vae as jvae
from dgm_img_super_resolution_tpu.train.trainer import Trainer as JaxTrainer
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_module_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.train.tasks import gan as tgan
from dgm_img_super_resolution_tpu_torch.train.tasks import vae as tvae

from torch_port_helpers import write_mnist_idx

ROOT = Path(__file__).resolve().parents[1]
AE_LR, AE_UPDATES = 1e-3, 3  # train_vae's Hparams(lr=1e-3); no decay within 3 updates
PARAM_ALL, PARAM_STEADY = 2.0, 1e-3  # in lr_sum, as tests/test_torch_port_train_step.py
FWD_TOL = 1e-5
N_IMAGES = 64  # the IDX directory's images: 8 batches of 8, and the 16 of the grids


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jcommon():
    return _load("jax_examples_common", ROOT / "examples" / "common.py")


@pytest.fixture(scope="module")
def tcommon():
    return importlib.import_module("examples_torch.common")


@pytest.fixture
def jax_script(jcommon, monkeypatch):
    """JAX's ``examples/<name>.py`` as a module, its ``common`` JAX's;
    ``sys.path`` and ``sys.modules['common']`` restored after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(sys.modules, "common", jcommon)
    monkeypatch.chdir(ROOT)  # the script puts the relative "examples" on the path
    return lambda name: _load(f"jax_examples_{name}", ROOT / "examples" / f"{name}.py")


def port_script(name: str):
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """An MNIST IDX directory of ``N_IMAGES`` synthetic digits, which both
    ``get_mnist`` read through ``--data_dir``."""
    return write_mnist_idx(tmp_path_factory.mktemp("mnist"), N_IMAGES, seed=4)


# ------------------------------------------------------------------ common
def test_batches_match_jax_over_epochs(jcommon, tcommon):
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    for seed in (0, 5):
        got, want = tcommon.batches(x, 4, seed), jcommon.batches(x, 4, seed)
        for _ in range(7):  # 2 batches an epoch (the 3 left over dropped): into the fourth epoch
            np.testing.assert_array_equal(next(got), next(want))


@pytest.mark.parametrize("n,h,c,unit,cols", [(16, 32, 1, False, 4), (16, 28, 1, True, 4), (5, 9, 3, False, 4),
                                             (7, 6, 3, True, 8), (3, 5, 1, False, 2)])
def test_save_grid_writes_jaxs_png(jcommon, tcommon, tmp_path, capsys, n, h, c, unit, cols):
    """NHWC in [-1, 1] or [0, 1], 1 or 3 channels, a partial last row."""
    g = np.random.default_rng(n * h + c)
    imgs = g.uniform(0 if unit else -1, 1, (n, h, h + 1, c)).astype(np.float32)
    tcommon.save_grid(imgs, str(tmp_path / "port" / "g.png"), cols=cols)
    jcommon.save_grid(imgs, str(tmp_path / "jax" / "g.png"), cols=cols)
    assert (tmp_path / "port" / "g.png").read_bytes() == (tmp_path / "jax" / "g.png").read_bytes()
    assert capsys.readouterr().out.count("| wrote ") == 2


@pytest.mark.parametrize("size", [28, 32])
def test_get_mnist_matches_jax(jcommon, tcommon, mnist_dir, size):
    for data_dir, seed in (("", 3), (mnist_dir, 0)):
        args = argparse.Namespace(data_dir=data_dir, seed=seed)
        got, want = tcommon.get_mnist(args, size=size, n_synth=40), jcommon.get_mnist(args, size=size, n_synth=40)
        assert got.dtype == want.dtype == np.float32 and got.shape[1:] == (size, size, 1)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- tasks and Hparams
class _Built(Exception):
    def __init__(self, task, arg=None):
        self.task, self.arg = task, arg


def _built(monkeypatch, cls, method: str):
    def stop(self, *a, **kw):
        raise _Built(self, a[0] if a else None)

    monkeypatch.setattr(cls, method, stop)


def _task_of(main, *argv) -> _Built:
    with pytest.raises(_Built) as e:
        main(*argv)
    return e.value


def _n_leaves(tree) -> int:
    return sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(tree))


SCRIPTS = [("train_vae", ["--model", "vae", "--latent_dim", "5", "--seed", "3"]),
           ("train_vae", ["--model", "ae"]),
           ("train_gan", ["--kind", "gan", "--seed", "2"]), ("train_gan", ["--kind", "dcgan"]),
           ("train_gan", ["--kind", "wgan-gp"]),
           ("train_ddpm", ["--timesteps", "7", "--dim", "16", "--seed", "1"])]


@pytest.mark.parametrize("name,argv", SCRIPTS)
def test_scripts_build_jaxs_task_and_hparams(jax_script, monkeypatch, mnist_dir, name, argv):
    argv = argv + ["--data_dir", mnist_dir]
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    jax_gan_init = jgan.GANTask.init_state
    for cls in (jvae.AETask, jvae.VAETask, jvae.DDPMTask, tvae.AETask, tvae.VAETask, tvae.DDPMTask):
        _built(monkeypatch, cls, "make_trainer")
    for cls in (jgan.GANTask, tgan.GANTask):
        _built(monkeypatch, cls, "init_state")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    want = _task_of(jax_script(name).main)  # JAX's main() reads sys.argv
    got = _task_of(port_script(name).main, argv + ["--device", "cpu"])
    jt, tt = want.task, got.task
    assert type(tt).__name__ == type(jt).__name__
    assert dict(tt.hp) == dict(jt.hp) and tt.hp["seed"] == seed
    assert str(tt.device) == "cpu"
    if name == "train_gan":
        assert (tt.kind, tt.img_shape, tt.z_dim, tt.crit_repeats, tt.gp_lambda) == (
            jt.kind, jt.img_shape, jt.z_dim, jt.crit_repeats, jt.gp_lambda)
        # JAX seeds the init with PRNGKey(seed), the port with the seed
        np.testing.assert_array_equal(np.asarray(want.arg), np.asarray(jax.random.PRNGKey(seed)))
        assert got.arg == seed
        shapes = jax.eval_shape(lambda k: jax_gan_init(jt, k), jax.random.PRNGKey(0))
        n_jax = _n_leaves((shapes.gen_params, shapes.disc_params))
        n_port = sum(p.numel() for m in tt._models() for p in m.parameters())
    else:
        assert (tt.img_hw, tt.img_ch) == (jt.img_hw, jt.img_ch)
        if name == "train_ddpm":
            assert tt.ddpm.num_timesteps == jt.ddpm.num_timesteps == int(argv[argv.index("--timesteps") + 1])
            assert tt.model.model.dim == jt.ddpm.model.dim
        else:
            assert tt.model.latent_dim == jt.model.latent_dim
            if type(jt).__name__ == "VAETask":
                assert tt.beta == jt.beta
        n_jax = _n_leaves(jax.eval_shape(jt.init_params, jax.random.PRNGKey(0)))
        n_port = sum(p.numel() for p in tt.model.parameters())
    assert n_port == n_jax


# ------------------------------------------------------ the AE, 3 updates
def test_ae_script_trains_as_jaxs(jax_script, tcommon, monkeypatch, mnist_dir, tmp_path):
    argv = ["--model", "ae", "--steps", str(AE_UPDATES), "--batch_size", "8", "--data_dir", mnist_dir]
    jscript, tscript = jax_script("train_vae"), port_script("train_vae")
    seen = {}

    def keep(key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen[key] = jax.tree_util.tree_map(np.array, out)  # a host copy: the jitted step donates its input
            return out
        return wrapped

    monkeypatch.setattr(jvae.AETask, "init_params", keep("jax_init", jvae.AETask.init_params))
    monkeypatch.setattr(JaxTrainer, "fit", keep("jax_state", JaxTrainer.fit))
    grids = {}
    for key, script in (("jax", jscript), ("port", tscript)):
        orig = script.save_grid
        monkeypatch.setattr(script, "save_grid", lambda imgs, path, cols=8, key=key, orig=orig: (
            grids.__setitem__(key, (np.array(imgs), path, cols)), orig(imgs, path, cols)))
    monkeypatch.setattr(sys, "argv", ["train_vae"] + argv + ["--out_dir", str(tmp_path / "jax")])
    jscript.main()

    def from_jax(self, seed=0):
        self.model.load_state_dict(jax_module_params_to_state_dict(self.model, seen["jax_init"]), strict=True)
        return self.model

    monkeypatch.setattr(tvae.AETask, "init_params", from_jax)
    out = tscript.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])

    lr_sum = AE_LR * AE_UPDATES
    model = out["state"].model
    want = jax_module_params_to_state_dict(model, seen["jax_state"].params)
    init = jax_module_params_to_state_dict(model, seen["jax_init"])
    moved = 0.0
    for name, p in model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= PARAM_ALL * lr_sum, (name, err / lr_sum)
        moved = max(moved, float((want[name] - init[name]).abs().max()))
    assert moved > 0.5 * lr_sum  # the updates moved the parameters by about lr each
    (got, tpath, tcols), (ref, jpath, jcols) = grids["port"], grids["jax"]
    assert got.shape == ref.shape == (16, 32, 32, 1) and (tcols, jcols) == (4, 4)
    assert Path(tpath).name == Path(jpath).name == "ae_recon.png"
    x16 = (tcommon.get_mnist(argparse.Namespace(data_dir=mnist_dir, seed=0), size=32)[:16] + 1.0) / 2.0
    start = tvae.AETask(Hparams(), latent_dim=2, device="cpu").model
    start.load_state_dict(init)
    with torch.no_grad():
        before = start(torch.from_numpy(x16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    move = float(np.abs(ref - before).max())
    assert move > 10 * FWD_TOL
    err = float(np.abs(got - ref).max())
    assert err <= PARAM_STEADY * move + FWD_TOL, (err, move)


# ------------------------------------------------------------- the runs
RUNS = [("train_vae", ["--model", "vae", "--steps", "2"], "vae_samples.png", 128),
        ("train_vae", ["--model", "ae", "--steps", "2"], "ae_recon.png", 128),
        ("train_gan", ["--kind", "gan", "--steps", "100"], "gan_samples_100.png", 112),
        ("train_ddpm", ["--steps", "2", "--dim", "8", "--timesteps", "2"], "ddpm_samples.png", 128)]


@pytest.mark.parametrize("name,argv,png,side", RUNS)
def test_script_main_writes_jaxs_png(mnist_dir, tmp_path, name, argv, png, side):
    from PIL import Image

    out = port_script(name).main(argv + ["--data_dir", mnist_dir, "--batch_size", "4", "--out_dir", str(tmp_path),
                                         "--device", "cpu"])
    written = out["png"] if isinstance(out["png"], str) else out["png"][-1]
    assert Path(written) == tmp_path / png
    img = Image.open(written)
    assert img.size == (side, side) and img.mode == "L"
    params = out["state"].gen.parameters() if name == "train_gan" else out["state"].model.parameters()
    assert all(bool(torch.isfinite(p).all()) for p in params)
    if name == "train_gan":
        assert set(out["scalars"]) == {"disc_loss", "gen_loss"} and np.isfinite(list(out["scalars"].values())).all()
        assert out["it_per_s"] > 0


@pytest.mark.parametrize("name", ["train_vae", "train_gan", "train_ddpm"])
def test_scripts_need_the_card_unless_asked_for_cpu(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_script(name).main(["--out_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
