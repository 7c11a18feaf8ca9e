"""The segmented compile boundaries (``core/graphs.py`` ``Program``: the
SRDiff progress path, the SD callback path) and the calls captured whole
beside them (interpolation, SRDiff validation, the GAN ``val_step``, the
DDPM sampler, LPIPS), through the graph route with a capture emulated on
the CPU, against the eager route (``graphs.eager()``) bit for bit.

The emulation (as ``tests/test_torch_port_graphs.py``'s, a call captured
whole being a program of one piece): a first call runs eagerly, a "replay"
runs each piece again on the static inputs and the previous piece's static
outputs and copies its result into its own, as a replayed graph writes
them. What is held here: the route (one cache entry per call shape, the
pieces in order, the host callbacks between them with the eager sequence,
the generator carried across), not the card's graphs, which
``chip_smoke.py``'s ``phase_graphs`` holds on the H100.

- The progress path equals the one-program serve at ``enc_interval`` 1
  with the same generator, and JAX's ``_run_segmented`` within 1e-4 (the
  bound of ``tests/test_torch_port_pipeline.py``) with JAX's draws fed in.
- The SD callback path at 20 steps and ``callback_steps`` 1 is one cache
  entry of 22 pieces, evicts nothing, and its second call captures nothing;
  the latents a callback kept are not overwritten by the next call.
- Validation replayed after an optimizer update reads the updated weights;
  a parameter rebound captures anew.
- Threads that share a cache each get their own call's result.
- The calls that callers seldom repeat (interpolation, the DDPM sampler,
  LPIPS) capture at a key's second call: a one-off call runs eagerly and
  captures nothing.

The JAX comparisons of the eager paths at their tolerances stay in
``test_torch_port_serving.py`` (progress), ``test_torch_port_sd_pipeline.py``
(callback), ``test_torch_port_interp_validation.py``,
``test_torch_port_edu_tasks.py`` (DDPM), ``test_torch_port_gan.py`` and
``test_torch_port_resize_metrics.py`` (LPIPS).
"""

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from dgm_img_super_resolution_tpu.core.config import Hparams as JHparams
from dgm_img_super_resolution_tpu.inference import SRDiffPipeline as JaxPipeline
from dgm_img_super_resolution_tpu.parallel.mesh import make_mesh
from dgm_img_super_resolution_tpu_torch.ckpt.jax_params import jax_params_to_state_dict
from dgm_img_super_resolution_tpu_torch.core import graphs
from dgm_img_super_resolution_tpu_torch.core.config import Hparams
from dgm_img_super_resolution_tpu_torch.inference import SRDiffPipeline
from dgm_img_super_resolution_tpu_torch.metrics.lpips import LPIPS, _LPIPSNet
from dgm_img_super_resolution_tpu_torch.models.sd.pipeline import StableDiffusionUpscalePipeline
from dgm_img_super_resolution_tpu_torch.train.tasks.gan import GANTask
from dgm_img_super_resolution_tpu_torch.train.tasks.srdiff import SRDiffTask
from dgm_img_super_resolution_tpu_torch.train.tasks.vae import DDPMTask

from test_torch_port_gan import real_batch
from test_torch_port_train_losses import TINY, make_batch
from torch_port_helpers import CLIP_TINY, UNET_TINY, VAE_TINY, jax_noise, random_jax_params

SERVE = dict(hidden_size=8, rrdb_num_block=2, rrdb_num_feat=8, timesteps=8, unet_dim_mults="1|2|3|4",
             compute_dtype="float32")
SAMPLERS = {"ddim4_eta1": dict(sampler="ddim", sample_timesteps=4, ddim_eta=1.0), "ancestral_T8": dict(sampler="ddpm")}
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _PieceReplay:
    """A piece's emulated graph: ``fn`` again on the static inputs and the
    previous piece's static outputs, copied into its own."""

    def __init__(self, fn, static, prev, gen, outputs):
        self.fn, self.static, self.prev, self.gen, self.outputs = fn, static, prev, gen, outputs

    def replay(self):
        new, old = [], []
        graphs.tree_map(new.append, self.fn(self.static, self.prev, self.gen))
        graphs.tree_map(old.append, self.outputs)
        for o, n in zip(old, new, strict=True):
            o.copy_(n)


def _emulated_program(fns, inputs, generator, pool, after):
    """``GraphCache._capture_program`` without a card: the eager first call
    (callbacks between the pieces), then a piece's static outputs a copy of
    what it returned."""
    static = {k: v.clone() for k, v in inputs.items()}
    gen = None
    if generator is not None:
        gen = torch.Generator()
        gen.set_state(generator.get_state())
    state, states = None, []
    for fn, cb in zip(fns, after, strict=True):
        state = fn(static, state, gen)
        states.append(graphs.tree_map(torch.clone, state))
        if cb is not None:
            cb(state)
    if generator is not None:
        generator.set_state(gen.get_state())
    pieces, prev = [], None
    for fn, outputs in zip(fns, states):
        pieces.append(graphs.Entry(_PieceReplay(fn, static, prev, gen, outputs), static, outputs, gen, {}))
        prev = outputs
    return state, graphs.Program(pieces)


def _emulated_capture(fn, inputs, generator, pool):
    """``GraphCache._capture`` without a card: a program of one piece."""
    out, program = _emulated_program([lambda inputs, _, g: fn(inputs, g)], inputs, generator, pool, [None])
    return out, program.pieces[0]


@pytest.fixture
def captures(monkeypatch):
    """The graph route with the emulated captures; the captures made, by kind."""
    made = []
    monkeypatch.setattr(graphs.GraphCache, "_capture",
                        staticmethod(lambda *a: made.append("graph") or _emulated_capture(*a)))
    monkeypatch.setattr(graphs.GraphCache, "_capture_program",
                        staticmethod(lambda *a: made.append("program") or _emulated_program(*a)))
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER)
    return made


def _both(call, seed=3):
    """``call(generator)`` through the graph route, then under
    ``graphs.eager()``, from one generator state: (graph's, eager's, the
    generators' states equal)."""
    ga, gb = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    got = call(ga)
    with graphs.eager():
        want = call(gb)
    return got, want, torch.equal(ga.get_state(), gb.get_state())


def _equal(a, b) -> bool:
    xs, ys = [], []
    graphs.tree_map(xs.append, a)
    graphs.tree_map(ys.append, b)
    return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))


def _pipe(sampler):
    return SRDiffPipeline(Hparams(dict(SERVE, **SAMPLERS[sampler])), device="cpu")


# ------------------------------------------------------------ programs
def test_program_replays_its_pieces_in_order_with_the_callbacks_between(captures):
    """Three pieces: each replay copies the inputs in, runs the pieces in
    order with the callbacks between them, carries the generator, and
    returns a clone of the last piece's outputs."""
    cache, seen = graphs.GraphCache(), []
    fns = [lambda inputs, _, g: inputs["x"] * 2,
           lambda inputs, st, g: st + torch.randn(st.shape, generator=g),
           lambda inputs, st, g: (st, st.sum())]
    after = [lambda st: seen.append(("prep", st.clone())), lambda st: seen.append(("seg", st.clone())), None]
    outs = []
    for x in (torch.ones(3), torch.arange(3.0), torch.full((3,), -1.0)):
        got, want, same_gen = _both(lambda g, x=x: cache.run_program("k", fns, {"x": x}, g, after))
        assert _equal(got, want) and same_gen
        outs.append(got)
    assert captures == ["program"] and len(cache) == 1 and len(cache.entries[("program", "k"), False,
                                                                         graphs.routing()].pieces) == 3
    assert [k for k, _ in seen] == ["prep", "seg"] * 6  # per input: the graph route's, then the eager's
    assert all(torch.equal(seen[k][1], seen[k + 2][1]) for k in range(12) if k % 4 < 2)
    assert outs[0][0] is not outs[1][0] and not torch.equal(outs[0][0], outs[1][0])
    with pytest.raises(KeyError):
        cache.run_program("k", fns, {"y": torch.ones(3)}, torch.Generator(), after)


def test_on_repeat_captures_at_a_keys_second_call(captures, monkeypatch):
    """``on_repeat``: a key's first call runs eagerly and captures nothing,
    its second captures, its third replays; the keys run once are
    remembered as the entries are (``MAXSIZE``), and ``clear`` forgets
    them."""
    monkeypatch.setattr(graphs, "MAXSIZE", 2)
    cache = graphs.GraphCache()

    def fn(inputs, g):
        return inputs["x"] + torch.randn(inputs["x"].shape, generator=g)

    def call(g):  # as a site routes it: the cache unless graphs.eager()
        x = {"x": torch.ones(3)}
        return fn(x, g) if graphs._EAGER else cache.run("k", fn, x, g, on_repeat=True)

    for made in ([], ["graph"], ["graph"]):
        got, want, same_gen = _both(call)
        assert torch.equal(got, want) and same_gen and captures == made and len(cache) == len(made)
    for key in ("a", "b", "c", "a"):  # "a" forgotten once two other keys have run
        cache.run(key, fn, {"x": torch.ones(3)}, on_repeat=True)
    assert captures == ["graph"] and list(cache.seen) == [("c", True, graphs.routing()), ("a", True, graphs.routing())]
    cache.clear()
    assert len(cache) == 0 and not cache.seen
    cache.run("k", fn, {"x": torch.ones(3)}, on_repeat=True)
    assert captures == ["graph"]


def test_threads_sharing_a_cache_get_their_own_calls(captures):
    """Eight threads on two cores, each serving its own input through one
    cache's program with a yield between the pieces: every result is its
    own call's."""
    cache = graphs.GraphCache()
    fns = [lambda inputs, _, g: inputs["x"] + 1, lambda inputs, st, g: st * inputs["x"]]
    cache.run_program("k", fns, {"x": torch.zeros(4)}, None, [None, None])
    bad, prev = [], sys.getswitchinterval()

    def worker(i):
        for j in range(20):
            x = torch.full((4,), float(i * 100 + j))
            out = cache.run_program("k", fns, {"x": x}, None, [lambda st: threading.Event().wait(1e-5), None])
            if not torch.equal(out, (x + 1) * x):
                bad.append((i, j))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and bad == [] and captures == ["program"]


# --------------------------------------------------------------- progress
@pytest.mark.parametrize("sampler,every", [("ddim4_eta1", 3), ("ancestral_T8", 3), ("ancestral_T8", 10)])
def test_progress_path_replays_the_eager_calls(captures, sampler, every):
    """Three calls with progress through the cache (one program, then
    replays) against three eager calls: the images (uint8 and float), the
    callbacks' (done, total) and the generator's state; the first call's
    image is the one-program serve's at ``enc_interval`` 1 from the same
    generator state; a hook of tensors is a static input."""
    pipe = _pipe(sampler)
    imgs = [np.random.default_rng(s).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8) for s in (1, 2, 3)]
    total = 4 if sampler == "ddim4_eta1" else 8
    want_seq = [(d, total) for d in list(range(every, total, every)) + [total]]

    def calls(g, seen):
        return [pipe.upscale_batch_device(x, generator=g, as_uint8=i != 1, callback_steps=every,
                                          progress_cb=lambda d, t: seen.append((d, t))) for i, x in enumerate(imgs)]

    seen_g, seen_e = [], []
    ga, gb = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = calls(ga, seen_g)
    with graphs.eager():
        want = calls(gb, seen_e)
    assert _equal(got, want) and torch.equal(ga.get_state(), gb.get_state()) and not torch.equal(got[0], got[2])
    assert seen_g == seen_e == want_seq * 3
    assert captures == ["program", "program"] and len(pipe._graphs) == 2  # uint8 and float: two call shapes
    entry = next(iter(pipe._graphs.entries.values()))
    assert isinstance(entry, graphs.Program) and len(entry.pieces) == 2 + len(want_seq)
    one = pipe.upscale_batch_device(imgs[0], generator=torch.Generator().manual_seed(9), as_uint8=True)
    assert torch.equal(one, got[0]) and captures[-1] == "graph"
    g = torch.Generator().manual_seed(5)
    for _ in range(2):
        noise = (torch.randn(2, 3, 32, 40, generator=g), {t: torch.randn(2, 3, 32, 40, generator=g) for t in range(8)})
        a = pipe.upscale_batch_device(imgs[0], noise=noise, progress_cb=lambda d, t: None, callback_steps=every)
        with graphs.eager():
            b = pipe.upscale_batch_device(imgs[0], noise=noise, progress_cb=lambda d, t: None, callback_steps=every)
        assert torch.equal(a, b)
    assert captures.count("program") == 3


def test_progress_path_matches_jax_run_segmented(captures):
    """The graph route's replay against JAX's ``_run_segmented`` (ddim4
    eta 1, callback every 2 steps; a two-stage UNet)
    with JAX's draws fed in: the image within 1e-4 and the callbacks'
    sequence."""
    cfg = dict(SERVE, unet_dim_mults="1|2", **SAMPLERS["ddim4_eta1"])
    params = random_jax_params(JHparams(cfg), 1)[1]
    jpipe = JaxPipeline(JHparams(cfg), params=params, mesh=make_mesh("", devices=jax.devices()[:1]))
    pipe = SRDiffPipeline(Hparams(cfg), params=jax_params_to_state_dict(params), device="cpu")
    imgs = np.random.default_rng(7).integers(0, 256, (2, 7, 9, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(12)
    noise = jax_noise(key, (2, 28, 36, 3), pipe.model.ddim_timesteps(4)[0])
    seen_j, seen_t = [], []
    ref = np.asarray(jpipe.upscale_batch_device(imgs, rng=key, callback_steps=2,
                                                progress_cb=lambda d, t: seen_j.append((d, t))))
    for _ in range(2):  # the first call, then a replay
        seen_t.clear()
        got = pipe.upscale_batch_device(imgs, noise=noise, callback_steps=2,
                                        progress_cb=lambda d, t: seen_t.append((d, t)))
    assert captures == ["program"] and seen_t == seen_j == [(2, 4), (4, 4)]
    assert tuple(got.shape) == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


# --------------------------------------------------------------------- SD
@pytest.fixture(scope="module")
def sd_pipe():
    return StableDiffusionUpscalePipeline(unet_config=UNET_TINY, vae_config=VAE_TINY, text_config=CLIP_TINY,
                                          dtype=torch.float32, device="cpu", seed=4)


def test_sd_callback_path_is_one_entry_of_its_segments(sd_pipe, captures):
    """20 steps, eta 1, a callback every step: one cache entry of 22
    pieces beside the serve without a callback, nothing evicted, no capture
    on the second call; the images, the generator, and the callbacks' (i,
    t, latents) as the eager path's; the latents a callback kept outlive
    the next call."""
    imgs = np.random.default_rng(15).integers(0, 256, (1, 8, 8, 3), dtype=np.uint8)
    kw = dict(num_inference_steps=20, guidance_scale=9.0, sampler="ddpm", noise_level=5)

    def serve(g, seen, every=1):
        return sd_pipe.upscale_device("a cat", imgs, generator=g, callback_steps=every,
                                      callback=lambda i, t, x: seen.append((i, t, x)), **kw)

    runs = []
    for seed in (0, 1):
        seen_g, seen_e = [], []
        ga, gb = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        got = serve(ga, seen_g)
        with graphs.eager():
            want = serve(gb, seen_e)
        assert torch.equal(got, want) and torch.equal(ga.get_state(), gb.get_state())
        assert [(i, t) for i, t, _ in seen_g] == [(i, t) for i, t, _ in seen_e] == \
            [(i, 950 - 50 * i + sd_pipe.steps_offset) for i in range(20)]
        runs.append((got, seen_g, seen_e))
    assert captures == ["program"] and len(sd_pipe._graphs) == 1
    assert len(next(iter(sd_pipe._graphs.entries.values())).pieces) == 22
    for _, seen_g, seen_e in runs:  # the first call's latents too, after the second call's replays
        assert all(torch.equal(a[2], b[2]) for a, b in zip(seen_g, seen_e))
    seen = []
    got, want, _ = _both(lambda g: serve(g, seen, every=3))
    assert torch.equal(got, want) and [i for i, _, _ in seen] == [2, 5, 8, 11, 14, 17, 19] * 2
    plain = sd_pipe.upscale_device("a cat", imgs, generator=torch.Generator().manual_seed(0), **kw)
    assert torch.equal(plain, runs[0][0]) and len(sd_pipe._graphs) == 3
    assert captures == ["program", "program", "graph"]


# ----------------------------------------------------- calls captured whole
def test_interpolate_is_one_graph_per_shape_and_t(captures):
    """A shape and ``t`` seen once runs eagerly (the CLI's one call), its
    second call captures, and other mixing weights replay (``lam`` is an
    input); each equals the eager call from the same generator."""
    pipe = _pipe("ancestral_T8")
    g = np.random.default_rng(3)
    a, b = (g.integers(0, 256, (16, 16, 3), dtype=np.uint8) for _ in range(2))
    outs, made = [], []
    for lam, t, capture in ((0.3, None, []), (0.7, 5, []), (0.7, None, ["graph"]), (0.5, None, ["graph"])):
        got, want, same_gen = _both(lambda gen, lam=lam, t=t: pipe.interpolate(a, b, lam=lam, t=t, generator=gen))
        np.testing.assert_array_equal(got, want)
        assert same_gen and captures == capture
        outs.append(got)
    assert len(pipe._graphs) == 1 and not np.array_equal(outs[2], outs[3])


def test_validation_replays_and_reads_updated_weights(captures):
    """The validation loss (one graph per batch shape, the generators seeded
    i) and the T-step sample: as the eager validation; after an optimizer
    update in place the replays read the new weights (no new capture); a
    parameter rebound captures anew."""
    hp = Hparams(**dict(TINY, compute_dtype="float32", timesteps=4, valid_steps=2))
    task = SRDiffTask(hp)
    trainer = task.make_trainer(device="cpu")
    state = trainer.init_state()
    val = task.make_val_fn([make_batch(seed=50 + i) for i in range(2)], sample_metrics=True)

    def check():
        got = val(state)
        with graphs.eager():
            want = val(state)
        assert got == want and sorted(got) == ["loss", "psnr", "ssim"]
        return got

    first = check()
    assert captures == ["graph", "graph"] and len(val.graphs) == 2
    with graphs.eager():
        trainer.train_step(state, make_batch(seed=1), torch.Generator().manual_seed(2))
    second = check()
    assert captures == ["graph", "graph"] and second["loss"] != first["loss"]
    p = next(state.model.parameters())
    p.data = p.data.clone()
    check()
    assert captures == ["graph"] * 4 and len(val.graphs) == 4


@pytest.mark.parametrize("kind", ["gan", "dcgan", "wgan-gp"])
def test_gan_val_step_replays_the_eager_step(captures, kind):
    task = GANTask(Hparams(compute_dtype="float32", crit_repeats=1), kind=kind, device="cpu")
    state = task.init_state(0)
    for seed in (1, 2):
        got, want, same_gen = _both(lambda g, seed=seed: task.val_step(state, real_batch(seed=seed), g))
        assert _equal(got, want) and same_gen and set(got) == {"disc_loss", "gen_loss"}
    assert captures == ["graph"] and len(state.graphs) == 1
    assert not state.gen.training and not state.disc.training
    p = next(state.disc.parameters())
    p.data = p.data.clone()  # a rebound tensor: a new key, captured anew
    got, want, _ = _both(lambda g: task.val_step(state, real_batch(seed=1), g))
    assert _equal(got, want) and captures == ["graph", "graph"] and len(state.graphs) == 2


def test_ddpm_sampler_is_one_graph_over_the_chain(captures):
    """Eager at a key's first call, captured at its second, replayed at its
    third, each equal to the eager chain; fed noise is an input; a
    parameter rebound makes a new key."""
    task = DDPMTask(Hparams(compute_dtype="float32", ddpm_dim=8, ddpm_timesteps=4), img_hw=8, device="cpu")
    for made in ([], ["graph"], ["graph"]):
        got, want, same_gen = _both(lambda g: task.sample(task.model, n=2, generator=g))
        assert torch.equal(got, want) and same_gen and tuple(got.shape) == (2, 1, 8, 8) and captures == made
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        noise = (torch.randn(2, 1, 8, 8, generator=g), {t: torch.randn(2, 1, 8, 8, generator=g) for t in range(1, 4)})
        a = task.sample(task.model, n=2, noise=noise)
        with graphs.eager():
            assert torch.equal(a, task.sample(task.model, n=2, noise=noise))
    assert captures == ["graph", "graph"] and len(task.model._graphs) == 2
    p = next(task.model.parameters())
    p.data = p.data.clone()
    for made in (2, 3):
        task.sample(task.model, n=2, generator=torch.Generator().manual_seed(0))
        assert len(captures) == made


def test_lpips_is_one_graph_per_shape(captures):
    """A size scored once runs eagerly; a size's second pair captures, its
    third replays; each score equals the eager one."""
    torch.manual_seed(0)
    scorer = LPIPS(_LPIPSNet().state_dict(), device="cpu")
    g = np.random.default_rng(2)
    for hw in (64, 72, 64, 64):
        a, b = (g.integers(0, 256, (hw, hw, 3), dtype=np.uint8) for _ in range(2))
        got = scorer(a, b)
        with graphs.eager():
            assert got == scorer(a, b) and np.isfinite(got)
    assert captures == ["graph"] and len(scorer._graphs) == 1
