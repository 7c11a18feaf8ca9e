"""The backward of the port's conv regions (rows 1-6 of the kernel table), on
the CPU.

On the card each region's wrapper runs its kernel forward and, when grad is
on, differentiates through its plain PyTorch version
(``ops/kernels/_autograd.py``), as the JAX package's custom VJPs take
``jax.vjp`` of their reference compositions. On CPU tensors the wrappers run
the plain versions, so these tests drive the shared ``Recompute`` Function
directly, with the plain version in place of the launch, and hold the
gradient of every input in float32 against ``jax.vjp`` of the JAX reference
(``block_chain3_reference``, ``block_chain3_stem_reference``,
``block_chain3_stem_ds_reference``, ``block_chain3_head_reference``,
``tail_reference``, and ``_reflect_conv_mish_ref`` for conv3x3; the zero
border against JAX's SAME conv with the package's ``mish``). Tolerance:
1e-4 of max(1, max |JAX grad|) per input: float32 sums in another order
through up to 5 chained convs and their transposes.

Then the routing: with grad off (``torch.inference_mode()``,
``torch.no_grad()``) or no input that requires grad, each wrapper calls its
launch directly and never the Function; with grad on, it goes through the
Function, whose backward runs the plain version and not the launch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgm_img_super_resolution_tpu.models.layers import _reflect_conv_mish_ref
from dgm_img_super_resolution_tpu.models.layers import mish as jax_mish
from dgm_img_super_resolution_tpu.ops.pallas.block_chain import (
    block_chain3_head_reference,
    block_chain3_reference,
    block_chain3_stem_ds_reference,
    block_chain3_stem_reference,
)
from dgm_img_super_resolution_tpu.ops.pallas.tail_fuse import tail_reference
from dgm_img_super_resolution_tpu_torch.ops.kernels import _autograd
from dgm_img_super_resolution_tpu_torch.ops.kernels import _common as K
from dgm_img_super_resolution_tpu_torch.ops.kernels import block_chain as bc
from dgm_img_super_resolution_tpu_torch.ops.kernels import conv3x3 as k3
from dgm_img_super_resolution_tpu_torch.ops.kernels import tail_fuse as tf

from chip_smoke import Regions
from torch_port_helpers import hwio

GRAD_TOL = 1e-4  # of max(1, max |JAX grad|), per input

# Each argument's layout: torch -> JAX, and a JAX gradient -> torch.
LAYOUTS = {
    "act": (lambda a: np.transpose(a, (0, 2, 3, 1)), lambda g: np.transpose(g, (0, 3, 1, 2))),
    "w": (hwio, lambda g: np.transpose(g, (3, 2, 0, 1))),
    "w1": (lambda a: a[:, :, 0, 0].T, lambda g: g.T[:, :, None, None]),  # 1x1 conv (O, I, 1, 1) <-> (I, O)
    "wt": (lambda a: np.transpose(a[:, :, ::-1, ::-1], (2, 3, 0, 1)),  # ConvT (I, O, 4, 4) <-> flipped HWIO
           lambda g: np.transpose(g, (2, 3, 0, 1))[:, :, ::-1, ::-1]),
    "v": (lambda a: a, lambda g: g),
}


class _Maker:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def act(self, *shape):
        return (self.rng.standard_normal(shape).astype(np.float32), "act")

    def conv(self, co, ci, k=3):
        w = self.rng.standard_normal((co, ci, k, k)) / np.sqrt(ci * k * k)
        return (w.astype(np.float32), "w" if k == 3 else "w1")

    def vec(self, *shape, scale=0.2):
        return ((self.rng.standard_normal(shape) * scale).astype(np.float32), "v")


def _chain_tail(m, b, c):
    """tv1, tv2 and the three chained convs of a chain at width c."""
    return [m.vec(b, c, scale=0.5), m.vec(b, c, scale=0.5),
            m.conv(c, c), m.vec(c), m.conv(c, c), m.vec(c), m.conv(c, c), m.vec(c)]


def _case(name, c, cond):
    """(plain, [(value, layout)], JAX function of the tensor arguments)."""
    m = _Maker(sum(map(ord, name)) * 1000 + 2 * c + cond)
    b, h, w = 2, 6, 8
    none = (None, None)
    if name == "chain":
        args = [m.act(b, c, h, w), m.act(b, c, h, w), *_chain_tail(m, b, c), m.act(b, c, h, w) if cond else none]
        fn = block_chain3_reference if cond else (lambda *a: block_chain3_reference(*a, None))
        return bc.block_chain3_plain, args, fn
    if name in ("stem", "stem_ds"):
        args = [m.act(b, 3, h, w), m.conv(c, 3), m.vec(c), m.conv(c, 3, 1), m.vec(c), *_chain_tail(m, b, c),
                m.act(b, c, h, w) if cond else none]
        if name == "stem":
            fn = block_chain3_stem_reference if cond else (lambda *a: block_chain3_stem_reference(*a, None))
            return bc.block_chain3_stem_plain, args, fn
        args += [m.conv(c, c), m.vec(c)]
        fn = block_chain3_stem_ds_reference if cond else (
            lambda *a: block_chain3_stem_ds_reference(*a[:13], None, *a[13:]))
        return bc.block_chain3_stem_ds_plain, args, fn
    if name == "head":
        cs = c // 2
        args = [m.act(b, cs, h, w), m.act(b, cs, h, w), m.conv(c, 2 * cs), m.vec(c), m.conv(c, 2 * cs, 1), m.vec(c),
                *_chain_tail(m, b, c)]
        return bc.block_chain3_head_plain, args, block_chain3_head_reference
    if name == "tail":
        wt = (m.rng.standard_normal((c, c, 4, 4)) / np.sqrt(4 * c)).astype(np.float32)
        args = [m.act(b, c, h, w), (wt, "wt"), m.vec(c), m.conv(c, c), m.vec(c), m.conv(3, c, 1), m.vec(3)]
        return tf.tail_fuse_plain, args, tail_reference
    raise ValueError(name)


def _conv_case(border, act):
    m = _Maker(7 + 2 * (border == "zero") + act)
    args = [m.act(2, 16, 5, 7), m.conv(16, 16), m.vec(16), (border, None), (act, None)]
    if border == "reflect":
        fn = lambda x, w, b: _reflect_conv_mish_ref(x, w, b, act, jnp.float32)  # noqa: E731
    else:
        def fn(x, w, b):
            y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
            return jax_mish(y) if act else y
    return k3.conv3x3_plain, args, fn


def _check_grads(plain, args, jax_fn, drop_first_output=False):
    """Backward through ``Recompute`` (plain forward in place of the launch)
    against ``jax.vjp`` of the JAX reference, every tensor input."""
    rng = np.random.default_rng(0)
    t_args = [torch.from_numpy(v.copy()).requires_grad_() if isinstance(v, np.ndarray) else v for v, _ in args]
    out = _autograd.Recompute.apply(plain, plain, *t_args)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(type(o.grad_fn).__name__ == "RecomputeBackward" for o in outs)
    cots = [rng.standard_normal(tuple(o.shape)).astype(np.float32) for o in outs]
    if drop_first_output:  # only the second output's gradient flows (the first is None)
        cots[0] = np.zeros_like(cots[0])
    keep = [i for i in range(len(outs)) if not (drop_first_output and i == 0)]
    tensors = [t for t in t_args if isinstance(t, torch.Tensor)]
    got = torch.autograd.grad([outs[i] for i in keep], tensors, [torch.from_numpy(cots[i]) for i in keep])

    j_args = [jnp.asarray(np.ascontiguousarray(LAYOUTS[kind][0](v))) for v, kind in args if isinstance(v, np.ndarray)]
    j_cots = tuple(jnp.asarray(np.ascontiguousarray(LAYOUTS["act"][0](c))) for c in cots)
    want = jax.jit(lambda a, g: jax.vjp(jax_fn, *a)[1](g))(j_args, j_cots if len(outs) > 1 else j_cots[0])
    kinds = [kind for v, kind in args if isinstance(v, np.ndarray)]
    assert len(got) == len(want) == len(kinds)
    for i, (g, jw, kind) in enumerate(zip(got, want, kinds)):
        w = LAYOUTS[kind][1](np.asarray(jw))
        assert g is not None and tuple(g.shape) == w.shape, i
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, f"input {i}: max |torch - JAX| {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("cond", [False, True])
def test_chain_grads_match_jax(c, cond):
    _check_grads(*_case("chain", c, cond))


@pytest.mark.parametrize("name,cond", [("stem", False), ("stem", True), ("stem_ds", True), ("head", False),
                                       ("tail", False)])
def test_region_grads_match_jax(name, cond):
    _check_grads(*_case(name, 16, cond))


def test_stem_ds_grads_without_cond_and_with_one_output_gradient():
    """No cond, and a gradient for the Downsample's output alone: the
    Function takes ``None`` for the other part."""
    _check_grads(*_case("stem_ds", 16, False), drop_first_output=True)


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("act", [False, True])
def test_conv3x3_grads_match_jax(border, act):
    _check_grads(*_conv_case(border, act))


def test_none_and_constant_arguments_get_no_gradient():
    plain, args, _ = _case("chain", 32, False)
    t_args = [torch.from_numpy(v.copy()).requires_grad_(i % 2 == 0) if isinstance(v, np.ndarray) else v
              for i, (v, _k) in enumerate(args)]
    out = _autograd.Recompute.apply(plain, plain, *t_args)
    out.sum().backward()
    for i, t in enumerate(t_args):
        if isinstance(t, torch.Tensor):
            assert (t.grad is not None) == (i % 2 == 0), i


# --------------------------------------------------- which path a wrapper takes
WRAPPERS = {  # the table's name -> (module, its launch function, wrapper, Regions attribute)
    "block_chain3_stem": (bc, "_block_chain3_stem_cuda", bc.block_chain3_stem, "stem"),
    "block_chain3": (bc, "_block_chain3_cuda", bc.block_chain3, "chain"),
    "tail_fuse": (tf, "_tail_fuse_cuda", tf.tail_fuse, "tail"),
    "block_chain3_stem_ds": (bc, "_block_chain3_stem_ds_cuda", bc.block_chain3_stem_ds, "stem_ds"),
    "block_chain3_head": (bc, "_block_chain3_head_cuda", bc.block_chain3_head, "head"),
    "conv3x3": (k3, "_conv3x3_cuda", k3.conv3x3, "conv3x3"),
}
PLAINS = {"block_chain3_stem": bc.block_chain3_stem_plain, "block_chain3": bc.block_chain3_plain,
          "tail_fuse": tf.tail_fuse_plain, "block_chain3_stem_ds": bc.block_chain3_stem_ds_plain,
          "block_chain3_head": bc.block_chain3_head_plain, "conv3x3": k3.conv3x3_plain}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrappers_launch_directly_without_grad(monkeypatch, name):
    """The wrappers' device path on CPU tensors: ``on_cpu`` answers False
    and a spy stands in for the launch. Grad off or nothing requiring grad:
    the launch alone, never the Function. Grad on: the Function, whose
    backward runs the plain version (the launch is not called again)."""
    mod, launch_name, wrapper, attr = WRAPPERS[name]
    plain = PLAINS[name]
    calls = []

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return plain(*args)

    def refuse(*args):
        raise AssertionError("went through the Function")

    monkeypatch.setattr(K, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, launch_name, spy)
    args = getattr(Regions(1, 8, 8, torch.float32, "cpu", seed=3), attr)
    weight = args[2]  # a parameter of every region
    with monkeypatch.context() as m:
        m.setattr(_autograd.Recompute, "apply", refuse)
        with torch.inference_mode():
            out = wrapper(*args)
        weight.requires_grad_()
        with torch.no_grad():
            out_ng = wrapper(*args)
        weight.requires_grad_(False)
        out_free = wrapper(*args)  # grad on, but nothing requires it
    assert len(calls) == 3
    for o in (out, out_ng, out_free):
        for part in o if isinstance(o, tuple) else (o,):
            assert part.grad_fn is None

    weight.requires_grad_()
    got = wrapper(*args)
    assert len(calls) == 4 and calls[-1] is False  # the launch ran inside the Function's forward
    first = got[-1] if isinstance(got, tuple) else got
    assert type(first.grad_fn).__name__ == "RecomputeBackward"
    (g,) = torch.autograd.grad(first.sum(), weight)
    want = plain(*args)
    want = want[-1] if isinstance(want, tuple) else want
    (g_plain,) = torch.autograd.grad(want.sum(), weight)
    assert len(calls) == 4
    torch.testing.assert_close(g, g_plain, rtol=0, atol=0)
