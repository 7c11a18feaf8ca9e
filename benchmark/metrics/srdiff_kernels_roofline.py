"""SRDiff kernels (rows 1-3: ``ops/kernels/block_chain.py``,
``tail_fuse.py``): the least time the traced run's launches of them could
take on the card (each launch's bound from ``benchmark/roofline/``, the
launches from the port's counters) over the device time of the port's
region kernels in the trace, in %."""

from benchmark.harness.peaks import bound_s
from benchmark.harness.spec import roofline_module
from benchmark.harness.trace import kernel_class

KERNELS = ("block_chain3_stem", "block_chain3", "tail_fuse")


def read(rec):
    if rec.device is None:
        return None
    took = rec.device.seconds_by(kernel_class).get("port_regions")
    launches = rec.launches(KERNELS)
    if not took or not launches:
        return None
    least = sum(n * bound_s(*roofline_module(k).work(**shape)) for k, shape, n in launches)
    return 100.0 * least / took
