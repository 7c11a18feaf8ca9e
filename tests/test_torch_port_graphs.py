"""The port's compile boundaries (``core/graphs.py``) on the CPU: the
functions the card captures as CUDA graphs, run eagerly, against today's
eager paths and the JAX package's jitted ones; the graph route with a
capture emulated on the CPU against ``graphs.eager()``; the graph cache's
keys and eviction; the launch counters' registry and replay rule.

- The SRDiff serve's program (``SRDiffPipeline._program``, JAX's
  ``_sample_fn``) equals, bit for bit, the serve composed of the
  pipeline's pieces as ``_serve`` ran them before (uint8 -> [-1, 1], pad,
  bicubic, sampler, clamp, crop, round): ddim4 eta 1 at ``enc_interval`` 1
  and 2 and the T = 8 ancestral chain; and JAX's pipeline within 1e-4 (the
  bound of ``tests/test_torch_port_pipeline.py``) at ``enc_interval`` 2
  with JAX's draws fed in.
- The SD serve's program (``_upscale_fn``, JAX's ``_denoise_segment``
  with the encode and decode around it) equals the callback path (eager,
  every step) bit for bit.
- ``Trainer.compile_step()`` through its graphs (emulated) over three
  micro-batches at ``accumulate_grad_batches`` 2 with the clip active gives
  the state of the eager ``train_step`` bit for bit, and the rate Adam
  reads at each update is ``lr_at``; an optimizer state written and read
  back resumes to the same next update.
- ``GANTask.jitted_step()`` through its graph (emulated) for the three
  kinds equals the sequence of its updates bit for bit.

On the CPU, the pipelines' entry points and ``train_step`` run these same
functions eagerly, and the JAX package holds them there: the SD serve in
``tests/test_torch_port_sd_pipeline.py`` (1e-3), the training step at
these hparams in ``tests/test_torch_port_train_step.py``, the GAN rounds
(``train_step`` is ``jitted_step`` there) in ``tests/test_torch_port_gan.py``.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu.train.tasks.gan import GANTask as JaxGANTask
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.models import layers
from dgm_img_super_resolution_tpu_torch.ops.image import uint8_to_pm1
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3, flash_attention, group_norm, tail_fuse
from dgm_img_super_resolution_tpu_torch.ops.resize import resize
from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask, _draw_fn
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
from dgm_img_super_resolution_tpu_torch.train.trainer import Trainer, lr_at

from test_torch_port_gan import jax_draws, real_batch
from test_torch_port_sd_pipeline import pipelines  # noqa: F401  (the tiny SD pair, a fixture)
from test_torch_port_train_losses import jax_draws as train_draws
from test_torch_port_train_losses import make_batch, port_model
from test_torch_port_train_step import RUN, tree_np
from torch_port_helpers import jax_noise, random_jax_params, sd_jax_noise

SERVE = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2|3|4",
             compute_dtype="float32")
SAMPLERS = {
    "ddim4_eta1": dict(sampler="ddim", sample_timesteps=4, ddim_eta=1.0),
    "ddim4_eta1_enc2": dict(sampler="ddim", sample_timesteps=4, ddim_eta=1.0, enc_interval=2),
    "ancestral_T8": dict(sampler="ddpm"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ serving
def serve_before(pipe: SRDiffPipeline, imgs, gen, noise, as_uint8):
    """The world-1 serve as ``_serve`` composed it before the program."""
    hp, d = pipe.hp, pipe.model
    x = torch.from_numpy(imgs)
    n, h, w = x.shape[:3]
    ph, pw = pipe._pad(h, w)
    x = uint8_to_pm1(x).permute(0, 3, 1, 2)
    x = F.pad(x, (0, pw, 0, ph), mode="reflect" if ph < h and pw < w else "replicate")
    s = hp["sr_scale"]
    up = resize(x, ((h + ph) * s, (w + pw) * s), variant="torch")
    if hp.get("sampler") == "ddim":
        img = d.ddim_sample(x, up, num_steps=hp["sample_timesteps"], eta=hp["ddim_eta"], noise=noise, generator=gen,
                            enc_interval=int(hp.get("enc_interval", 1)))[0]
    else:
        img = d.sample(x, up, noise=noise, generator=gen)[0]
    out = (img * 0.5 + 0.5).clamp(0.0, 1.0)[:, :, : h * s, : w * s].permute(0, 2, 3, 1)
    return torch.round(out * 255.0).to(torch.uint8) if as_uint8 else out


@pytest.fixture(scope="module")
def serve_params():
    return random_jax_params(JHparams(SERVE), 1)[1]


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_serve_program_is_the_eager_serve(serve_params, sampler):
    """Drawn noise and a fed hook, float and uint8: the program, the
    pipeline's entry point and the serve as composed before are one."""
    pipe = SRDiffPipeline(Hparams(dict(SERVE, **SAMPLERS[sampler])), params=jax_params_to_state_dict(serve_params),
                          device="cpu")
    imgs = np.random.default_rng(6).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    for as_uint8 in (False, True):
        outs = [fn(torch.Generator().manual_seed(3)) for fn in (
            lambda g: serve_before(pipe, imgs, g, None, as_uint8),
            lambda g: pipe._program(torch.from_numpy(imgs), g, None, as_uint8),
            lambda g: pipe.upscale_batch_device(imgs, generator=g, as_uint8=as_uint8))]
        assert outs[0].dtype == (torch.uint8 if as_uint8 else torch.float32)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    g = torch.Generator().manual_seed(5)
    noise = (torch.randn(2, 3, 32, 40, generator=g), {t: torch.randn(2, 3, 32, 40, generator=g) for t in range(8)})
    assert torch.equal(serve_before(pipe, imgs, None, noise, False), pipe._program(torch.from_numpy(imgs), None,
                                                                                   noise, False))


def test_serve_program_matches_jax_with_encoder_propagation(serve_params):
    cfg = dict(SERVE, **SAMPLERS["ddim4_eta1_enc2"])
    jpipe = JaxPipeline(JHparams(cfg), params=serve_params, mesh=make_mesh("", devices=jax.devices()[:1]))
    pipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(serve_params), device="cpu")
    imgs = np.random.default_rng(7).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(12)
    noise = jax_noise(key, (2, 32, 40, 3), pipe.model.ddim_timesteps(4)[0])
    ref = np.asarray(jpipe.upscale_batch_device(imgs, rng=key))
    with torch.inference_mode():
        got = pipe._program(torch.from_numpy(imgs), None, noise, False)
    assert tuple(got.shape) == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_sd_program_is_the_callback_path(pipelines):  # noqa: F811
    _, tpipe = pipelines
    kw = dict(num_inference_steps=2, guidance_scale=9.0, sampler="ddpm", noise_level=5)
    imgs = np.random.default_rng(15).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(16)
    ts = (np.arange(2) * (1000 // 2))[::-1] + tpipe.steps_offset
    noise = sd_jax_noise(key, 2, 8, 8, [int(t) for t in ts])
    got = tpipe.upscale_device("a cat", imgs, noise=noise, **kw)
    seen = []
    eager = tpipe.upscale_device("a cat", imgs, noise=noise, callback=lambda i, t, x: seen.append(i), **kw)
    assert seen == [0, 1] and torch.equal(got, eager)
    ids = tpipe._token_ids(["a cat"] * 2, ["", ""])
    cond, uncond = tpipe.encode_prompt(["a cat"] * 2)
    assert torch.equal(tpipe.text_encoder(ids), torch.cat([cond, uncond]))


# -------------------------------------------------------------------- cache
class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_capture(fn, inputs, generator, pool):
    out = fn(inputs, generator)
    entry = graphs.Entry(_FakeGraph(), {k: v.clone() for k, v in inputs.items()}, out, None, {})
    return out, entry


def test_cache_reuses_a_key_keeps_eight_and_evicts_the_least_recently_used(monkeypatch):
    monkeypatch.setattr(graphs.GraphCache, "_capture", staticmethod(_fake_capture))
    cache, calls = graphs.GraphCache(), []

    def fn(inputs, g):
        calls.append(1)
        return inputs["x"] * 2

    x = torch.ones(3)
    for k in range(8):
        assert torch.equal(cache.run(("k", k), fn, {"x": x}), 2 * x)
    assert len(cache) == 8 and len(calls) == 8
    cache.run(("k", 0), fn, {"x": x})  # a hit: replayed, and now the most recent
    assert len(calls) == 8 and cache.entries[(("k", 0), True, graphs.routing())].graph.replays == 1
    cache.run(("k", 8), fn, {"x": x})
    keys = [k[0][1] for k in cache.entries]
    assert len(cache) == 8 and keys == [2, 3, 4, 5, 6, 7, 0, 8]  # key 1 was the least recently used
    prev = torch.backends.cudnn.deterministic  # cuDNN's choice of algorithms is part of the key
    torch.backends.cudnn.deterministic = not prev
    try:
        cache.run(("k", 8), fn, {"x": x})
    finally:
        torch.backends.cudnn.deterministic = prev
    assert len(calls) == 10
    cache.clear()
    assert len(cache) == 0 and cache.pool is None


def test_routing_key_reads_the_switch_table(monkeypatch):
    """The kernel routing that the callers put in their keys: every switch
    of the gates' table, the chain widths and ``kernels_disabled()``."""
    base = layers.routing_key()
    for name, default in layers._SWITCHES.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(name, "0" if default == "1" else "1")
            assert layers.routing_key() != base, name
            mp.setenv(name, default)
            assert layers.routing_key() == base, name
    monkeypatch.setenv("DGMSR_CHAIN_C", "64,128")
    assert layers.routing_key() != base
    monkeypatch.delenv("DGMSR_CHAIN_C")
    with layers.kernels_disabled():
        assert layers.routing_key() != base
    assert layers.routing_key() == base


def test_eager_and_enabled():
    assert graphs.enabled(torch.device("cuda")) and not graphs.enabled(torch.device("cpu"))
    with graphs.eager():
        with graphs.eager():
            assert not graphs.enabled(torch.device("cuda"))
        assert not graphs.enabled(torch.device("cuda"))
    assert graphs.enabled(torch.device("cuda"))


def test_tensor_inputs_rebuild_and_signature():
    x, e = torch.zeros(2, 3), {4: torch.ones(2), 1: torch.full((2,), 2.0)}
    tree = (x, e)
    flat = graphs.tensor_inputs("noise", tree)
    assert sorted(flat) == ["noise.0", "noise.1.1", "noise.1.4"]
    back = graphs.rebuild("noise", tree, {k: v + 1 for k, v in flat.items()})
    assert torch.equal(back[0], x + 1) and torch.equal(back[1][4], e[4] + 1)
    assert graphs.signature(tree) == (((2, 3), torch.float32), ((4, ((2,), torch.float32)), (1, ((2,), torch.float32))))
    assert graphs.tensor_inputs("noise", lambda t: x) is None
    assert graphs.tensor_inputs("kw", {"t": x, "noise": (x, lambda t: x)}) is None


def test_replay_adds_the_captured_launches_once_per_replay():
    """Every wrapper that counts its launches is registered. A capture's
    counts are taken back and kept as the entry's deltas; every replay adds
    them once (ints and the by-shape dict)."""
    counting = {fn for mod in (bc, tail_fuse, conv3x3, flash_attention, group_norm)
                for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")}
    assert len(counting) == 8 and counting <= set(graphs._COUNTED)
    before = graphs.counts()
    graphs.set_counts({k: ({} if isinstance(v, dict) else 0) for k, v in before.items()})
    try:
        warm = graphs.counts()
        assert (bc.block_chain3, "launches_by_shape") in warm and (bc.block_chain3_stem, "launches_wgmma") in warm
        bc.block_chain3.launches += 20  # what a capture of one serve counts on the host
        bc.block_chain3.launches_by_shape[64, 16, 16] = 20
        bc.block_chain3_stem.launches_wgmma += 20
        deltas = graphs.count_deltas(warm, graphs.counts())
        graphs.set_counts(warm)
        assert deltas == {(bc.block_chain3, "launches"): 20, (bc.block_chain3, "launches_by_shape"): {(64, 16, 16): 20},
                          (bc.block_chain3_stem, "launches_wgmma"): 20}
        assert graphs.counts() == warm
        entry = graphs.Entry(_FakeGraph(), {"x": torch.zeros(2)}, torch.zeros(2), None, deltas)
        for n in (1, 2, 3):
            out = entry.replay({"x": torch.ones(2)}, None)
            assert bc.block_chain3.launches == 20 * n and bc.block_chain3.launches_by_shape == {(64, 16, 16): 20 * n}
            assert bc.block_chain3_stem.launches_wgmma == 20 * n and bc.block_chain3_stem.launches == 0
        assert entry.graph.replays == 3 and torch.equal(entry.inputs["x"], torch.ones(2))
        assert sum(v for v in graphs.counts().values() if isinstance(v, int)) == 120  # nothing else moved
        assert out is not entry.outputs
        with pytest.raises(KeyError):
            entry.replay({"y": torch.ones(2)}, None)
    finally:
        graphs.set_counts(before)


# ----------------------------------------------------------------- training
def _trainer(hp, model, tmp_path):
    task = SRDiffTask(hp, model)
    return Trainer(hp, task.loss_fn, init_params_fn=lambda seed: model, device="cpu", work_dir=str(tmp_path))


def _snapshot(state):
    adam = state.optimizer.adam
    return {"params": [p.detach().clone() for p in state.model.parameters()],
            "mu": [adam.state[p]["exp_avg"].clone() for p in state.model.parameters() if p in adam.state],
            "nu": [adam.state[p]["exp_avg_sq"].clone() for p in state.model.parameters() if p in adam.state],
            "ema": [v.clone() for v in state.ema.values()],
            "bufs": [b.clone() for b in state.optimizer.bufs if b is not None],
            "counts": (state.step, state.optimizer.updates, state.optimizer.mini_step)}


def _equal(a, b):
    assert a["counts"] == b["counts"]
    for key in ("params", "mu", "nu", "ema", "bufs"):
        assert len(a[key]) == len(b[key]) and all(torch.equal(x, y) for x, y in zip(a[key], b[key])), key


@pytest.fixture(scope="module")
def train_params():
    return random_jax_params(JHparams(**RUN), seed=3)[1]


def _rate(state) -> float:
    """The rate Adam reads at its next step: a float on the CPU."""
    return float(state.optimizer.adam.param_groups[0]["lr"])


def test_compile_step_is_train_step_and_writes_the_rate_of_lr_at(train_params, emulated_graphs, tmp_path):
    """Three micro-batches at k = 2 (one update, then one held), clip on,
    decay_steps 1, EMA 0.9, without weight norm: ``compile_step`` through
    its graphs against ``train_step`` under ``graphs.eager()``."""
    hp = Hparams(**dict(RUN, use_wn=False))
    tr_c = _trainer(hp, port_model(hp, tree_np(train_params)), tmp_path / "c")
    tr_e = _trainer(hp, port_model(hp, tree_np(train_params)), tmp_path / "e")
    sc, se = tr_c.init_state(), tr_e.init_state()
    step = tr_c.compile_step()
    for i in range(3):
        batch = make_batch(seed=20 + i)
        t, noise = train_draws(jax.random.PRNGKey(200 + i), 2, batch["hr"].shape, 100)
        due_lr = lr_at(hp, sc.optimizer.updates)
        sc, mc = step(sc, batch, t=t, noise=noise)
        with graphs.eager():
            se, me = tr_e.train_step(se, batch, t=t, noise=noise)
        _equal(_snapshot(sc), _snapshot(se))
        assert all(torch.equal(mc[k], me[k]) for k in me) and set(mc) == set(me)
        if i == 1:  # the update: the rate was lr_at of the updates before it
            assert _rate(sc) == due_lr == hp["lr"]
    assert sorted(k[0][0] for k in sc.optimizer.graphs.entries) == ["ema", "micro", "update"]
    assert sc.optimizer.lr == lr_at(hp, 1) == hp["lr"] / 2  # the next update's, written before it


def test_optimizer_state_round_trip_resumes_the_same_update(train_params, tmp_path):
    """Mid-accumulation (k = 2, after one micro-batch) the optimizer's
    state, written and read back into a fresh trainer, gives the same next
    update as the trainer that went on."""
    hp = Hparams(**dict(RUN, use_wn=False))
    tr_a = _trainer(hp, port_model(hp, tree_np(train_params)), tmp_path / "a")
    sa = tr_a.init_state()
    step = tr_a.compile_step()
    for i in range(3):  # an update, then one micro-batch held
        t, noise = train_draws(jax.random.PRNGKey(300 + i), 2, (2, 32, 32, 3), 100)
        sa, _ = step(sa, make_batch(seed=30 + i), t=t, noise=noise)
    tr_a.save(sa, sa.step)
    tr_b = _trainer(hp, port_model(hp, tree_np(train_params)), tmp_path / "a")
    sb = tr_b.init_state()
    ckpt, at = tr_b.load_latest()
    tr_b.restore(sb, ckpt)
    assert at == 3 and sb.optimizer.mini_step == 1 and sb.optimizer.updates == 1
    assert _rate(sb) == lr_at(hp, 1)
    t, noise = train_draws(jax.random.PRNGKey(303), 2, (2, 32, 32, 3), 100)
    batch = make_batch(seed=33)
    sa, _ = step(sa, batch, t=t, noise=noise)
    sb, _ = tr_b.compile_step()(sb, batch, t=t, noise=noise)
    _equal(_snapshot(sa), _snapshot(sb))


# ------------------------------------------- the graph route, emulated on the CPU
def _emulated_capture(fn, inputs, generator, pool):
    """``GraphCache._capture`` without a card: the first call runs eagerly,
    and a "replay" runs the function again on the static inputs with the
    entry's generator and copies its result into the static outputs, as a
    replayed graph writes them."""
    static = {k: v.clone() for k, v in inputs.items()}
    gen = None
    if generator is not None:
        gen = torch.Generator()
        gen.set_state(generator.get_state())
    out = fn(static, gen)
    if generator is not None:
        generator.set_state(gen.get_state())
    outputs = graphs.tree_map(torch.clone, out)

    class Replay:
        def replay(self):
            new = []
            graphs.tree_map(new.append, fn(static, gen))
            old = []
            graphs.tree_map(old.append, outputs)
            for o, n in zip(old, new):
                o.copy_(n)

    return out, graphs.Entry(Replay(), static, outputs, gen, {})


@pytest.fixture
def emulated_graphs(monkeypatch):
    monkeypatch.setattr(graphs.GraphCache, "_capture", staticmethod(_emulated_capture))
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)


# ---------------------------------------------------------------------- GANs
@pytest.mark.parametrize("kind", ["gan", "dcgan", "wgan-gp"])
def test_jitted_step_is_the_update_sequence(kind, emulated_graphs):
    """Two rounds through the round's graph (the first eager, then a
    replay), JAX's draws fed in, against the sequence of the updates."""
    hp = dict(compute_dtype="float32", crit_repeats=1)
    jt = JaxGANTask(JHparams(**hp), kind=kind)
    tt = GANTask(Hparams(**hp), kind=kind, device="cpu")
    ts = tt.init_state(0)
    seq = copy.deepcopy(ts)
    step = tt.jitted_step()
    for r in range(2):
        real = real_batch(seed=r)
        draws = jax_draws(jt, jax.random.PRNGKey(4 + r), real.shape[0])
        ts, metrics = step(ts, real, noise=draws)
        draw = _draw_fn(draws, None, tt.device)
        want_d, extra = tt._disc_update(seq, tt._real(real), 0, draw)
        want_g = tt._gen_update(seq, real.shape[0], draw)
        for a, b in ((ts.gen, seq.gen), (ts.disc, seq.disc)):
            assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
        assert torch.equal(metrics["disc_loss"], want_d) and torch.equal(metrics["gen_loss"], want_g)
        assert all(torch.equal(metrics[k], v) for k, v in extra.items())
    assert ts.step == 2 and len(ts.graphs) == 1


# ------------------------------------------------------- the whole graph route
def test_graph_route_serve_replays_the_eager_calls(serve_params, emulated_graphs, monkeypatch):
    """Three calls through the cache (the first eager, two replays), one
    generator carried across them, against three eager calls; a hook of
    tensors is a static input."""
    pipe = SRDiffPipeline(Hparams(dict(SERVE, **SAMPLERS["ddim4_eta1"])), params=jax_params_to_state_dict(serve_params),
                          device="cpu")
    calls = []
    capture = graphs.GraphCache._capture
    monkeypatch.setattr(graphs.GraphCache, "_capture", staticmethod(lambda *a: calls.append(1) or capture(*a)))
    imgs = [np.random.default_rng(s).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8) for s in (1, 2, 3)]
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = [pipe.upscale_batch_device(x, generator=ga, as_uint8=True) for x in imgs]
    with graphs.eager():
        want = [pipe.upscale_batch_device(x, generator=gb, as_uint8=True) for x in imgs]
    assert len(pipe._graphs) == 1 and calls == [1]
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and torch.equal(ga.get_state(), gb.get_state())
    assert not torch.equal(got[1], got[2])
    g = torch.Generator().manual_seed(5)
    for _ in range(2):
        noise = (torch.randn(2, 3, 32, 40, generator=g), {t: torch.randn(2, 3, 32, 40, generator=g) for t in range(8)})
        a = pipe.upscale_batch_device(imgs[0], noise=noise)
        with graphs.eager():
            b = pipe.upscale_batch_device(imgs[0], noise=noise)
        assert torch.equal(a, b)
    assert len(pipe._graphs) == 2
    monkeypatch.setenv("DGMSR_PALLAS_FUSED", "0")  # another kernel routing: another graph
    pipe.upscale_batch_device(imgs[0], generator=ga)
    assert len(pipe._graphs) == 3


def test_graph_route_training_and_gan_replay_the_eager_steps(train_params, emulated_graphs, tmp_path):
    """Four micro-batches at k = 2 through ``compile_step`` (micro-batch,
    update and EMA graphs) against ``graphs.eager()``; two GAN rounds."""
    hp = Hparams(**dict(RUN, use_wn=False))
    states = []
    for eager in (False, True):
        tr = _trainer(hp, port_model(hp, tree_np(train_params)), tmp_path / str(eager))
        st = tr.init_state()
        gen = torch.Generator().manual_seed(4)
        with graphs.eager() if eager else pytest.MonkeyPatch.context():
            for i in range(4):
                st, _ = tr.train_step(st, make_batch(seed=40 + i), gen)
        states.append(st)
    assert sorted(k[0][0] for k in states[0].optimizer.graphs.entries) == ["ema", "micro", "update"]
    assert len(states[1].optimizer.graphs) == 0
    _equal(_snapshot(states[0]), _snapshot(states[1]))

    task = GANTask(Hparams(compute_dtype="float32", crit_repeats=2), kind="wgan-gp", device="cpu")
    out = []
    for eager in (False, True):
        st, gen = task.init_state(0), torch.Generator().manual_seed(2)
        with graphs.eager() if eager else pytest.MonkeyPatch.context():
            for seed in (1, 2):
                st, m = task.train_step(st, real_batch(seed=seed), gen)
        out.append((st, m))
    (a, ma), (b, mb) = out
    assert len(a.graphs) == 1 and len(b.graphs) == 0
    for x, y in ((a.gen, b.gen), (a.disc, b.disc)):
        assert all(torch.equal(u, v) for u, v in zip(x.state_dict().values(), y.state_dict().values()))
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
