"""The port stands alone and never falls back quietly.

- No module of ``dgm_img_super_resolution_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax``, ``flax`` or anything of ``dgm_img_super_resolution_tpu``;
  the package imports in a process where those imports fail.
- The kernel regions run their plain versions on CPU tensors without touching
  the ``launches`` counters, which count CUDA launches only.
- The pipeline defaults to CUDA and raises when there is none.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dgm_img_super_resolution_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "flax", "dgm_img_super_resolution_tpu")
# the child processes run tiny models: torch's intra-op threads only contend
# with the other files of the suite for the host's cores
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["diffusion", "models", "train/tasks"])
def test_models_and_losses_import_nothing_of_the_mesh(sub):
    """Data parallelism stays in the serve, the trainer and the loader: the
    samplers, models and tasks draw through ``utils/draws.py`` alone."""
    files = sorted((PKG / sub).rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert not name.startswith("dgm_img_super_resolution_tpu_torch.parallel"), f"{f} imports {name}"


def test_no_jax_imports_anywhere_in_the_port():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import dgm_img_super_resolution_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_educational_tasks_and_native_run_with_jax_blocked():
    """The AE, VAE, DDPM and GAN tasks, MNIST, MultiheadAttention and the
    native resize run in a process where JAX cannot be imported; the native
    library builds from the port's own copy of the source."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import itertools, numpy as np, torch\n"
        "from dgm_img_super_resolution_tpu_torch import native\n"
        "from dgm_img_super_resolution_tpu_torch.core.config import Hparams\n"
        "from dgm_img_super_resolution_tpu_torch.data.mnist import synthetic_mnist, to_model_input\n"
        "from dgm_img_super_resolution_tpu_torch.models.layers import MultiheadAttention\n"
        "from dgm_img_super_resolution_tpu_torch.ops.resize import imresize\n"
        "from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask\n"
        "from dgm_img_super_resolution_tpu_torch.train.tasks.vae import AETask, DDPMTask, VAETask\n"
        "hp = Hparams(ddpm_dim=8, ddpm_timesteps=2, crit_repeats=1)\n"
        "x = to_model_input(synthetic_mnist(4, seed=0)[0], 32)\n"
        "for task, b in ((AETask(hp, device='cpu'), (x + 1) / 2), (VAETask(hp, device='cpu'), (x + 1) / 2),\n"
        "                (DDPMTask(hp, device='cpu'), x)):\n"
        "    tr = task.make_trainer()\n"
        "    tr.train_step(tr.init_state(0), {'x': b})\n"
        "g = GANTask(hp, 'wgan-gp', device='cpu')\n"
        "s, r = g.fit(itertools.repeat(to_model_input(synthetic_mnist(4, seed=1)[0], 28)), 1, 1)\n"
        "o, w = MultiheadAttention(8, 2)(torch.zeros(1, 3, 8))\n"
        "assert native.available() and native._SRC.startswith(native._HERE)"
        " and native._so_path().startswith(native._HERE)\n"
        "print(imresize(np.zeros((8, 8, 3), np.uint8), scale=0.5).shape, np.isfinite(r['gen_train_loss']).all())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(4,", "4,", "3)", "True"]


def test_new_serving_paths_run_with_jax_blocked():
    """The over-budget sub-batches and feathered tiles, progress, encoder
    propagation and the UNet's attention and GroupNorm run in a process
    where JAX cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from dgm_img_super_resolution_tpu_torch.core.config import Hparams\n"
        "from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline\n"
        "hp = Hparams(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=4, compute_dtype='float32',\n"
        "             sampler='ddim', sample_timesteps=4, ddim_eta=1.0, enc_interval=2, use_attn=True, gn_groups=4,\n"
        "             max_native_hr_pixels=2 * 32 * 32, infer_patch_size=8, infer_patch_overlap=2)\n"
        "pipe = SRDiffPipeline(hp, device='cpu')\n"
        "seen = []\n"
        "out = pipe.upscale_batch(np.zeros((3, 8, 8, 3), np.uint8), progress_cb=lambda d, t: seen.append((d, t)))\n"
        "big = pipe.upscale(np.zeros((12, 12, 3), np.uint8))\n"
        "print(out.shape, big.shape, seen[-1], bool(np.isfinite(out).all() and np.isfinite(big).all()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == "(3, 32, 32, 3) (48, 48, 3) (8, 8) True".split()


def test_cli_runs_with_jax_blocked(tmp_path):
    """Every subcommand of the port's CLI (the checkpoint import, the
    metrics, the MATLAB resize, interpolate and the operating-point check
    included) runs in a process where JAX cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import json, os, numpy as np, torch\n"
        "from PIL import Image\n"
        "from dgm_img_super_resolution_tpu_torch.apps.cli import main\n"
        "from dgm_img_super_resolution_tpu_torch.core.config import Hparams\n"
        "from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline\n"
        "hp = 'hidden_size=8,rrdb_num_block=2,rrdb_num_feat=8,timesteps=4,unet_dim_mults=1|2,compute_dtype=float32'\n"
        "tiny = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=4, unet_dim_mults='1|2',\n"
        "            compute_dtype='float32')\n"
        "sd = SRDiffPipeline(Hparams(tiny), device='cpu').model.state_dict()\n"
        f"d = {str(tmp_path)!r}\n"
        "torch.save({'state_dict': {'model': {'model.' + k: v for k, v in sd.items()}}}, d + '/m.ckpt')\n"
        "os.makedirs(d + '/hr')\n"
        "Image.fromarray(np.full((16, 16, 3), 90, np.uint8)).save(d + '/hr/a.png')\n"
        "cpu = ['-hp', hp, '--device', 'cpu', '--ckpt', d + '/m.ckpt']\n"
        "rcs = [main(['infer', d + '/hr/a.png', d + '/sr.png'] + cpu), main(['eval', d + '/hr/a.png'] + cpu),\n"
        "       main(['test', d + '/hr', '--gen_dir', d + '/gen', '--check-op-point'] + cpu),\n"
        "       main(['interp', d + '/hr/a.png', d + '/hr/a.png', d + '/mix.png'] + cpu)]\n"
        "print('RCS', rcs, sorted(os.listdir(d + '/gen')), np.asarray(Image.open(d + '/sr.png')).shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ONE_THREAD, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last == "RCS [0, 0, 0, 0] ['a.png', 'op_point_check.json'] (64, 64, 3)"


def test_cpu_regions_leave_the_launch_counters_alone():
    from chip_smoke import Regions
    from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
    from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3
    from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

    fns = (bc.block_chain3_stem, bc.block_chain3, tf.tail_fuse, k3.conv3x3)
    before = [f.launches for f in fns] + [k3.conv3x3.launches_wgmma]
    r = Regions(1, 8, 8, torch.bfloat16, "cpu")
    for f, args in zip(fns, (r.stem, r.chain, r.tail, r.conv3x3)):
        assert torch.isfinite(f(*args)).all()
    assert [f.launches for f in fns] + [k3.conv3x3.launches_wgmma] == before


def test_every_cuda_source_is_built(tmp_path, monkeypatch):
    """Each ``csrc/*.cu`` is one library of ``_build.SOURCES`` (and no name
    there lacks its source), and an edit to a shared header such as
    ``hopper.cuh`` renames, so rebuilds, every library."""
    import shutil

    from dgm_img_super_resolution_tpu_torch.ops.kernels import _build

    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._target(name) for name in _build.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n")
    assert all(_build._target(name) != before[name] for name in _build.SOURCES)


def test_pipeline_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from dgm_img_super_resolution_tpu_torch.core.config import Hparams
    from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = Hparams(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=4, unet_dim_mults="1|2",
                 compute_dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SRDiffPipeline(hp)
    assert SRDiffPipeline(hp, device="cpu").device.type == "cpu"


def test_flash_attention_on_cpu_leaves_its_counter_alone():
    from dgm_img_super_resolution_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v = torch.randn(3, 1, 70, 2, 64).unbind(0)
    before = fa.flash_attention.launches
    assert torch.isfinite(fa.flash_attention(q, k, v)).all()
    assert fa.flash_attention.launches == before


def test_sd_pipeline_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline
    from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dict(unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StableDiffusionUpscalePipeline(**cfg)
    pipe = StableDiffusionUpscalePipeline(**cfg, device="cpu")
    assert {p.device.type for p in pipe.unet.parameters()} == {"cpu"}
