"""The benchmark's work counts: each port kernel's FLOP and bytes at the
main path's shapes are the bound counts the kernel table records, and the
``mfu`` FLOP counter, run on the plain reference on the meta device,
agrees with a count by hand at a tiny width.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark.harness.peaks import bound_s
from benchmark.harness.spec import roofline_module


@pytest.mark.parametrize("kernel,shape,gflop,mb", [
    ("block_chain3_stem", {"b": 8, "h": 512, "w": 512}, 471.9, 549.9),   # row 1
    ("block_chain3", {"b": 8, "c": 64, "h": 256, "w": 256}, 116.0, 201.8),  # row 2
    ("tail_fuse", {"b": 8, "h": 512, "w": 512}, 224.1, 80.1),            # row 3
    ("flash_attention", {"b": 2, "l": 1024, "h": 8, "d": 128}, 8.59, 16.8),  # row 7
])
def test_kernel_work_matches_the_kernel_table(kernel, shape, gflop, mb):
    flops, nbytes = roofline_module(kernel).work(**shape)
    assert round(flops / 1e9, 2 if gflop < 10 else 1) == gflop
    assert round(nbytes / 1e6, 1) == mb


def test_bound_is_the_larger_of_operations_and_bytes():
    assert bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    f, b = roofline_module("block_chain3_stem").work(8, 512, 512)
    assert bound_s(f, b) * 1e3 == pytest.approx(0.477, abs=5e-4)  # row 1's bound ms (operations)


def _conv(cin, cout, k, h, w, n=1):
    return 2 * n * cin * cout * k * k * h * w


def test_mfu_flop_counter_matches_a_count_by_hand():
    """One request of a tiny SRDiff (hidden 8, mults 1|2, RRDB 2 blocks of
    4 features, 2 DDIM steps) at LR 4x4 -> 16x16, batch 1."""
    from benchmark.drivers.srdiff import Driver

    cfg = {"hidden_size": 8, "unet_dim_mults": "1|2", "rrdb_num_block": 2, "rrdb_num_feat": 4, "sr_scale": 4,
           "timesteps": 10, "beta_s": 0.008, "res_rescale": 2.0, "steps": 2, "eta": 1.0}
    counted = Driver(cfg, {"batch": 1, "lr": 4}, "cpu").flops_per_request()

    nf, gc, lr, hr = 4, 2, 4, 16
    rdb = sum(_conv(nf + i * gc, gc if i < 4 else nf, 3, lr, lr) for i in range(5))
    rrdb = _conv(3, nf, 3, lr, lr) + 2 * 3 * rdb + _conv(nf, nf, 3, lr, lr)
    cond = 2 * nf * 8 * 8 * 8 * lr * lr            # ConvT(4 -> 8, k 8) counted over its input
    lin = lambda i, o: 2 * i * o  # noqa: E731

    def resblock(cin, cout, s):
        res = _conv(cin, cout, 1, s, s) if cin != cout else 0
        return _conv(cin, cout, 3, s, s) + _conv(cout, cout, 3, s, s) + lin(8, cout) + res

    step = lin(8, 32) + lin(32, 8)
    step += resblock(3, 8, 16) + resblock(8, 8, 16) + _conv(8, 8, 3, 8, 8)  # down 0 and its Downsample
    step += resblock(8, 16, 8) + resblock(16, 16, 8)                          # down 1
    step += 2 * resblock(16, 16, 8)                                           # mid
    step += resblock(32, 8, 8) + resblock(8, 8, 8) + 2 * 8 * 8 * 16 * 8 * 8   # up, Upsample (ConvT k 4)
    step += _conv(8, 8, 3, hr, hr) + _conv(8, 3, 1, hr, hr)                   # final Block and 1x1
    assert counted == rrdb + cond + 2 * step
