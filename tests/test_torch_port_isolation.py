"""The port stands alone and never falls back quietly.

- No module of ``dgm_img_super_resolution_tpu_torch`` (nor ``chip_smoke.py``
  and ``examples_torch/``) imports ``jax``, ``flax`` or anything of
  ``dgm_img_super_resolution_tpu``; the package imports, and the example
  scripts run, in a process where those imports fail.
- The kernel regions run their plain versions on CPU tensors without touching
  the ``launches`` counters, which count CUDA launches only.
- The pipeline defaults to CUDA and raises when there is none; so do the
  benchmark scripts (``bench_torch.py``, ``tools/torch_port_*_bench.py``)
  and the DDIM operating-point study
  (``tools/torch_port_ddim_operating_point.py``), which also run with JAX
  blocked.
"""

import ast
import json
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
    files = sorted(PKG.rglob("*.py")) + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
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


def test_examples_run_with_jax_blocked(tmp_path):
    """Each example script, run as a file from another directory, in a
    process where JAX cannot be imported: it finds the port and its
    ``common`` from its own place in the checkout and writes its grid."""
    from torch_port_helpers import write_mnist_idx

    cpu_args = ["--data_dir", write_mnist_idx(tmp_path, 32, seed=1), "--device", "cpu", "--batch_size", "4"]
    runs = {"train_vae": (["--steps", "2"], "vae_samples.png"),
            "train_gan": (["--kind", "gan", "--steps", "100"], "gan_samples_100.png"),
            "train_ddpm": (["--steps", "1", "--dim", "8", "--timesteps", "2"], "ddpm_samples.png")}
    procs = {}
    for name, (argv, _) in runs.items():
        script = str(ROOT / "examples_torch" / f"{name}.py")
        code = (
            "import runpy, sys\n"
            "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = {[script] + argv + cpu_args + ['--out_dir', str(tmp_path / name)]!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n"
        )
        procs[name] = subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, env=ONE_THREAD,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert (tmp_path / name / runs[name][1]).is_file(), out


BENCH_FILES = ("bench_torch.py", "tools/torch_port_sd_bench.py", "tools/torch_port_train_bench.py")


def test_bench_scripts_import_no_jax():
    files = [ROOT / f for f in BENCH_FILES] + sorted((ROOT / "tools").glob("torch_port_*.py"))
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {name}"


def test_bench_scripts_run_with_jax_blocked(tmp_path):
    """``dgmsr-torch bench --device cpu`` (``bench_torch.py``, its Hparams
    narrowed to a hidden-16 two-stage model) and the two tools, run as
    files from another directory (the SD tool on the tiny SD configs), in
    processes where JAX cannot be imported: each prints its JSON line."""
    from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY

    block = "import runpy, sys\nfor m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n    sys.modules[m] = None\n"
    bench = (
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import dgm_img_super_resolution_tpu_torch.core.config as c\n"
        "narrow = dict(hidden_size=16, unet_dim_mults='1|2', rrdb_num_block=2, rrdb_num_feat=8)\n"
        "c.Hparams = lambda *a, _h=c.Hparams, **kw: _h(*a, **{**kw, **narrow})\n"
        "from dgm_img_super_resolution_tpu_torch.apps.cli import main\n"
        "sys.exit(main(['bench', '--device', 'cpu']))\n"
    )
    sd_script = str(ROOT / "tools" / "torch_port_sd_bench.py")
    sd = (
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import dgm_img_super_resolution_tpu_torch.models.sd.pipeline as p\n"
        f"tiny = dict(unet_config=dict({UNET_TINY!r}, num_class_embeds=1000), vae_config={VAE_TINY!r},\n"
        f"            text_config={CLIP_TINY!r})\n"
        "p.StableDiffusionUpscalePipeline = lambda _p=p.StableDiffusionUpscalePipeline, **kw: _p(**kw, **tiny)\n"
        f"sys.argv = [{sd_script!r}, '--device', 'cpu']\n"
        f"runpy.run_path({sd_script!r}, run_name='__main__')\n"
    )
    train_script = str(ROOT / "tools" / "torch_port_train_bench.py")
    train = (f"sys.argv = [{train_script!r}, '--tiny', '--device', 'cpu']\n"
             f"runpy.run_path({train_script!r}, run_name='__main__')\n")
    env = dict(ONE_THREAD, BENCH_STEPS="2", BENCH_BATCH="1", BENCH_ITERS="1", BENCH_LAT_ITERS="1",
               BENCH_FULL_CHAIN="0", SD_STEPS="2", SD_ITERS="1", SD_LR="32")
    procs = {name: subprocess.Popen([sys.executable, "-c", block + code], cwd=tmp_path, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, code in (("bench", bench), ("sd", sd), ("train", train))}
    metrics = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        line = json.loads(out.strip().splitlines()[-1])
        assert line["device"] == "cpu", line
        metrics[name] = line["metric"]
    assert metrics == {"bench": "srdiff_x4_512_upscales_per_sec_per_chip", "sd": "sd_x4_512_upscale_p50_s",
                       "train": "srdiff_train_steps_per_sec"}


def test_bench_scripts_need_cuda_unless_asked_for_cpu(monkeypatch):
    """Without a card and without ``--device`` each script raises before it
    builds anything, as the pipelines do."""
    import importlib.util

    from dgm_img_super_resolution_tpu_torch.apps.cli import main as cli_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", [str(ROOT)] + sys.path)
    mains = [lambda: cli_main(["bench"])]
    for f in BENCH_FILES:
        spec = importlib.util.spec_from_file_location(f"isolation_{Path(f).stem}", ROOT / f)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        mains.append(lambda m=module: m.main([]))
    for run in mains:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


STUDY = "tools/torch_port_ddim_operating_point.py"


def test_operating_point_study_imports_no_jax():
    for name in _imports(ROOT / STUDY):
        assert name.split(".")[0] not in FORBIDDEN, f"{STUDY} imports {name}"


def test_operating_point_study_runs_with_jax_blocked(tmp_path):
    """The DDIM operating-point study run as a file from another directory,
    in a process where JAX cannot be imported, at a tiny size on the CPU: it
    writes its two synthetic images, trains one update, serves three modes
    and writes its record."""
    script = str(ROOT / STUDY)
    argv = [script, "--device", "cpu", "--train-steps", "1", "--batch", "2", "--hr-size", "32",
            "--modes", "ddpm100,ddpm100_seed2,ddim8_eta1", "--work-dir", str(tmp_path / "wd"),
            "--out", str(tmp_path / "rec.json"),
            "-hp", "hidden_size=8,rrdb_num_block=2,rrdb_num_feat=8,timesteps=8,unet_dim_mults=1|2,"
                   "compute_dtype=float32,patch_size=32,save_codes=[]"]
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'flax', 'dgm_img_super_resolution_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=ONE_THREAD, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["device"] == "cpu" and rec["images"] == "synthetic, seed 7"
    assert sorted(rec["results"]) == ["ddim8_eta1", "ddpm100", "ddpm100_seed2"]
    assert sorted(p.name for p in (tmp_path / "wd" / "images").iterdir()) == ["synth0_img.png", "synth1_img.png"]


def test_operating_point_study_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    """Without a card and without ``--device`` the study raises before it
    writes or builds anything."""
    import importlib.util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location("isolation_study", ROOT / STUDY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--work-dir", str(tmp_path / "wd"), "--out", str(tmp_path / "rec.json")])
    assert not any(tmp_path.iterdir())


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
