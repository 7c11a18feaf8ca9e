"""The port's benchmark scripts held against the JAX package's on the CPU:
``bench_torch.py`` against ``bench.py``, ``tools/torch_port_sd_bench.py``
against ``tools/sd_bench.py``, ``tools/torch_port_train_bench.py`` against
``tools/train_bench.py``.

- (a) ``bench_torch.resolve_operating_point`` equals ``bench.py``'s on the
  cases of ``tests/test_bench_config.py`` and with ``BENCH_ENC`` set.
- (b) Each port script prints every key of its JAX counterpart's JSON line,
  in its order, read from the dict literal in the JAX script by ``ast``
  (``chip_smoke.json_keys_of``), plus ``device`` and nothing else.
- (c) The protocol: each JAX script runs with its pipeline (or task)
  replaced by a fake that records the calls and returns zeros of the right
  shape, and so does its port; the two recordings are equal: the
  ``Hparams``, the LR batches' shapes and dtype, ``as_uint8``, the calls in
  order and the seeds (``jax.random.PRNGKey(i)`` against a generator
  seeded ``i``), under the default knobs and under others.
- (d) One real CPU run of each port script at a tiny size: ``bench_torch``
  with its ``Hparams`` narrowed to a hidden-16, two-stage model, 2 DDIM
  steps, one image; the training tool ``--tiny`` for 2 steps; the SD tool
  on the tiny SD configs at LR 32 for 2 steps. Each line parses, its
  numbers finite.

JAX's scripts set a persistent compilation cache (``jax.config.update``),
which the suite keeps off (``tests/conftest.py``): the update is patched
out for the length of a test.
"""

import importlib.util
import json
import math
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgm_img_super_resolution_tpu.inference as jinference
import dgm_img_super_resolution_tpu.models.sd.pipeline as jsd_pipeline
import dgm_img_super_resolution_tpu.train.tasks.srdiff as jsrdiff
from dgm_img_super_resolution_tpu.ckpt.sd_inventory import X4_UNET_CONFIG as JAX_X4_UNET
from dgm_img_super_resolution_tpu.models.sd.unet import UNet2DCondition as JaxUNet
from dgm_img_super_resolution_tpu_torch.ckpt.sd_inventory import X4_UNET_CONFIG
from dgm_img_super_resolution_tpu_torch.core.config import Hparams

from chip_smoke import BENCH_KNOBS, BENCH_SCRIPTS, json_keys_of
from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402  (the JAX benchmark imports no JAX at module level)
import bench_torch  # noqa: E402

NARROW = dict(hidden_size=16, unet_dim_mults="1|2", rrdb_num_block=2, rrdb_num_feat=8)  # (d)'s SRDiff model
SD_TINY = dict(unet_config=dict(UNET_TINY, num_class_embeds=1000), vae_config=VAE_TINY, text_config=CLIP_TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def knobs(monkeypatch):
    """Every knob of the scripts unset, JAX's configuration left as it is;
    returns a setter."""
    for k in BENCH_KNOBS:
        monkeypatch.delenv(k, raising=False)
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None if name in (
        "jax_compilation_cache_dir", "jax_platforms") else update(name, value))
    monkeypatch.setattr(sys, "path", list(sys.path))
    return lambda env: [monkeypatch.setenv(k, v) for k, v in env.items()]


def _tool(name: str):
    """A port tool as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"port_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _jax_seed(key) -> int:
    return int(np.asarray(key).ravel()[-1])  # jax.random.PRNGKey(i) is [0, i]


# ----------------------------------------------------------------- (a) op point
OP_CASES = {  # (record, env): test_bench_config.py's four cases, and BENCH_ENC
    "no_record": (None, {}),
    "record": ({"operating_point": {"sampler": "ddim", "steps": 10, "eta": 1.0, "enc_interval": 2}}, {}),
    "null_record": ({"operating_point": None}, {}),
    "env_over_record": ({"operating_point": {"sampler": "ddim", "steps": 10, "eta": 1.0}},
                        {"BENCH_SAMPLER": "ddpm", "BENCH_STEPS": "100", "BENCH_ETA": "0.0"}),
    "enc_env": ({"operating_point": {"sampler": "ddim", "steps": 10, "eta": 0.5, "enc_interval": 2}},
                {"BENCH_ENC": "3"}),
    "enc_env_no_record": (None, {"BENCH_ENC": "2", "BENCH_STEPS": "8"}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_operating_point_matches_bench(tmp_path, case):
    record, env = OP_CASES[case]
    path = tmp_path / "DDIM_OPERATING_POINT.json"
    if record is not None:
        path.write_text(json.dumps(record))
    want = bench.resolve_operating_point(env=env, record_path=str(path))
    assert bench_torch.resolve_operating_point(env=env, record_path=str(path)) == want


def test_operating_point_reads_the_repos_record(knobs):
    assert bench_torch.resolve_operating_point() == bench.resolve_operating_point()


# --------------------------------------------------------- (b) the JSON keys
@pytest.mark.parametrize("script", sorted(BENCH_SCRIPTS))
def test_port_scripts_carry_jaxs_keys(script):
    """The dict literals: the port's is JAX's plus ``device``, in order."""
    jax_path, port_path = BENCH_SCRIPTS[script]
    want = json_keys_of(ROOT / jax_path)
    assert want[:2] == ["metric", "value"] and len(want) == {"bench": 16, "sd": 12, "train": 14}[script]
    assert json_keys_of(ROOT / port_path) == want + ["device"]


# ---------------------------------------------------------- (c) the protocol
class _Recorder:
    """Fake pipelines for both frameworks, writing one list of events."""

    def __init__(self):
        self.events = []
        self.pipes = 0

    def jax_pipeline(self):
        rec = self

        class Fake:
            def __init__(self, hp, params=None):
                self.index = rec.pipes
                rec.pipes += 1
                rec.events.append(("pipeline", dict(hp), params is not None))
                self.params = {}

            def upscale_batch_device(self, imgs, key, as_uint8=False):
                a = np.asarray(imgs)
                rec.events.append(("serve", self.index, a.shape, str(a.dtype), as_uint8, _jax_seed(key)))
                n, h, w, c = a.shape
                return jnp.zeros((n, 4 * h, 4 * w, c), jnp.uint8 if as_uint8 else jnp.float32)

        return Fake

    def port_pipeline(self):
        rec = self

        class Fake:
            def __init__(self, hp, params=None, device=None):
                self.index = rec.pipes
                rec.pipes += 1
                rec.events.append(("pipeline", dict(hp), params is not None))
                self.model = torch.nn.Identity()

            def upscale_batch_device(self, imgs, generator=None, as_uint8=False):
                a = np.asarray(imgs)
                rec.events.append(("serve", self.index, a.shape, str(a.dtype), as_uint8, generator.initial_seed()))
                n, h, w, c = a.shape
                return torch.zeros((n, 4 * h, 4 * w, c), dtype=torch.uint8 if as_uint8 else torch.float32)

        return Fake


BENCH_ENVS = {
    "defaults": {},
    "small": {"BENCH_BATCH": "2", "BENCH_ITERS": "3", "BENCH_LAT_ITERS": "2", "BENCH_FULL_ITERS": "2",
              "BENCH_ENC": "2", "BENCH_ETA": "0.5", "BENCH_STEPS": "10"},
    "op_is_the_chain": {"BENCH_SAMPLER": "ddpm", "BENCH_STEPS": "100", "BENCH_BATCH": "1"},
    "no_chain": {"BENCH_FULL_CHAIN": "0", "BENCH_BATCH": "3"},
}


@pytest.mark.parametrize("env", sorted(BENCH_ENVS))
def test_bench_protocol_matches_jax(knobs, monkeypatch, capsys, env):
    knobs(BENCH_ENVS[env])
    jrec, trec = _Recorder(), _Recorder()
    monkeypatch.setattr(jinference, "SRDiffPipeline", jrec.jax_pipeline())
    bench.main()
    jax_line = _last_json(capsys.readouterr().out)
    monkeypatch.setattr(bench_torch, "SRDiffPipeline", trec.port_pipeline())
    port_line = bench_torch.main(["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == port_line
    assert trec.events == jrec.events
    serves = [e for e in jrec.events if e[0] == "serve"]
    assert len(serves) >= 4 and {e[5] for e in serves} >= {0, 100, 200}
    assert list(port_line) == list(jax_line) + ["device"] == json_keys_of(ROOT / "bench.py") + ["device"]
    assert port_line["device"] == "cpu"
    for k in ("sampler", "steps", "eta", "enc_interval", "latency_batch", "full_chain_sampler"):
        assert port_line[k] == jax_line[k], k


SD_ENVS = {"defaults": {}, "knobs": {"SD_FLASH": "0", "SD_ENC": "2", "SD_STEPS": "5", "SD_BATCH": "2",
                                     "SD_ITERS": "2"}}


@pytest.mark.parametrize("env", sorted(SD_ENVS))
def test_sd_bench_protocol_matches_jax(knobs, monkeypatch, capsys, env):
    knobs(SD_ENVS[env])
    jev, tev = [], []

    def jax_unet(cfg, dtype=jnp.float32, use_flash=True):
        jev.append(("unet", cfg, jnp.dtype(dtype).name, use_flash))
        return "unet"

    class JaxFake:
        def __init__(self, unet=None, **kw):
            assert unet == "unet" and not kw

        def __call__(self, prompt, img, num_inference_steps=20, enc_interval=1, rng=None):
            jev.append(("call", prompt, img.shape, str(img.dtype), num_inference_steps, enc_interval,
                        None if rng is None else _jax_seed(rng)))
            return np.zeros((img.shape[0], 4 * img.shape[1], 4 * img.shape[2], 3), np.float32)

    class PortFake:
        def __init__(self, **kw):
            tev.append(("unet", kw.pop("unet_config", X4_UNET_CONFIG), str(kw.pop("dtype")).split(".")[-1],
                        kw.pop("use_flash")))
            assert set(kw) == {"device"}

        def __call__(self, prompt, img, num_inference_steps=20, enc_interval=1, generator=None):
            tev.append(("call", prompt, img.shape, str(img.dtype), num_inference_steps, enc_interval,
                        None if generator is None else generator.initial_seed()))
            return np.zeros((img.shape[0], 4 * img.shape[1], 4 * img.shape[2], 3), np.float32)

    monkeypatch.setattr(JaxUNet, "from_config", staticmethod(jax_unet))
    monkeypatch.setattr(jsd_pipeline, "StableDiffusionUpscalePipeline", JaxFake)
    runpy.run_path(str(ROOT / "tools" / "sd_bench.py"), run_name="jax_sd_bench")
    jax_line = _last_json(capsys.readouterr().out)
    tool = _tool("torch_port_sd_bench")
    monkeypatch.setattr(tool, "StableDiffusionUpscalePipeline", PortFake)
    port_line = tool.main(["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == port_line
    assert jev[0][1] is JAX_X4_UNET and tev[0][1] is X4_UNET_CONFIG and jev[0][1] == tev[0][1]
    assert [e[2:] if e[0] == "unet" else e for e in tev] == [e[2:] if e[0] == "unet" else e for e in jev]
    assert len(jev) == 2 + int(SD_ENVS[env].get("SD_ITERS", 3))
    assert list(port_line) == list(jax_line) + ["device"]
    for k in ("batch", "steps", "enc_interval", "use_flash", "cfg", "baseline"):
        assert port_line[k] == jax_line[k], k
    assert (jax_line["backend"], port_line["backend"], port_line["device"]) == ("cpu", "cpu", "cpu")


@pytest.mark.parametrize("tiny", [True, False])
def test_train_bench_protocol_matches_jax(knobs, monkeypatch, capsys, tiny):
    knobs({"BENCH_ITERS": "3"})
    jev, tev = [], []

    class JaxTask:
        def __init__(self, hp):
            jev.append(("hp", dict(hp)))

        def make_trainer(self, mesh=None):
            return self

        def init_state(self, key):
            jev.append(("init", _jax_seed(key)))
            return "state"

        def compile_step(self, batch_sharding=None):
            def step(state, batch, key):
                jev.append(("step", {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}, _jax_seed(key)))
                return state, {"loss": jnp.float32(0.5)}
            return step

    class PortTask:
        def __init__(self, hp):
            tev.append(("hp", dict(hp)))

        def make_trainer(self, device=None, mesh=None):
            assert str(device) == "cpu" and mesh.world == 1
            return self

        def init_state(self, seed):
            tev.append(("init", seed))
            return "state"

        def compile_step(self):
            def step(state, batch, generator):
                tev.append(("step", {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in batch.items()},
                            generator.initial_seed()))
                return state, {"loss": torch.tensor(0.5)}
            return step

    monkeypatch.setattr(jsrdiff, "SRDiffTask", JaxTask)
    monkeypatch.setattr(sys, "argv", ["train_bench.py"] + ["--tiny"] * tiny)
    runpy.run_path(str(ROOT / "tools" / "train_bench.py"), run_name="jax_train_bench")["main"]()
    jax_line = _last_json(capsys.readouterr().out)
    tool = _tool("torch_port_train_bench")
    monkeypatch.setattr(tool, "SRDiffTask", PortTask)
    port_line = tool.main(["--device", "cpu"] + ["--tiny"] * tiny)
    assert _last_json(capsys.readouterr().out) == port_line
    assert tev == jev
    assert [e[2] for e in jev if e[0] == "step"] == [1, 2, 3, 4]
    assert list(port_line) == list(jax_line) + ["device"]
    for k in ("batch", "hr_crop", "compute_dtype", "tiny", "loss_first", "loss_last"):
        assert port_line[k] == jax_line[k], k
    assert (port_line["mesh"], port_line["n_devices"], port_line["backend"]) == ("dp=1", 1, "cpu")


# ------------------------------------------------------------ (d) real runs
def _finite(line: dict) -> bool:
    nums = [v for v in line.values() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return bool(nums) and all(math.isfinite(v) for v in nums)


def test_bench_runs_on_the_cpu(knobs, monkeypatch, capsys):
    knobs({"BENCH_STEPS": "2", "BENCH_BATCH": "1", "BENCH_ITERS": "1", "BENCH_LAT_ITERS": "1",
           "BENCH_FULL_CHAIN": "0"})
    monkeypatch.setattr(bench_torch, "Hparams", lambda **kw: Hparams(**kw, **NARROW))
    line = bench_torch.main(["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == line
    assert line["value"] > 0 and line["p50_latency_s_b1"] > 0 and _finite(line)
    assert (line["sampler"], line["steps"], line["latency_batch"], line["full_chain_value"]) == ("ddim", 2, 1, None)


def test_train_bench_runs_on_the_cpu(knobs, capsys):
    knobs({"BENCH_ITERS": "2"})
    line = _tool("torch_port_train_bench").main(["--tiny", "--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == line
    assert line["value"] > 0 and line["loss_last"] > 0 and _finite(line)
    assert (line["batch"], line["hr_crop"], line["compute_dtype"], line["tiny"]) == (8, 32, "float32", True)


def test_sd_bench_runs_on_the_cpu(knobs, monkeypatch, capsys):
    knobs({"SD_STEPS": "2", "SD_ITERS": "1", "SD_LR": "32"})
    tool = _tool("torch_port_sd_bench")
    real = tool.StableDiffusionUpscalePipeline
    monkeypatch.setattr(tool, "StableDiffusionUpscalePipeline", lambda **kw: real(**kw, **SD_TINY))
    line = tool.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert _last_json("\n".join(out)) == line
    assert out[0].startswith("first call (incl. capture):") and "out=(1, 64, 64, 3)" in out[0]  # the tiny VAE: x2
    assert line["value"] > 0 and line["use_flash"] is True and _finite(line)
