"""The port stands alone and never falls back quietly.

- No module of ``dgm_img_super_resolution_tpu_torch`` (nor ``chip_smoke.py``)
  imports ``jax``, ``flax`` or anything of ``dgm_img_super_resolution_tpu``;
  the package imports in a process where those imports fail.
- The kernel regions run their plain versions on CPU tensors without touching
  the ``launches`` counters, which count CUDA launches only.
- The pipeline defaults to CUDA and raises when there is none.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dgm_img_super_resolution_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "flax", "dgm_img_super_resolution_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


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
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


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
