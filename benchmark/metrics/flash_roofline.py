"""Flash kernel (row 7: ``ops/kernels/flash_attention.py``): the least
time of the traced run's flash launches (``benchmark/roofline/
flash_attention.py``, the launches from the port's counter) over the flash
kernel's device time in the trace, in %."""

from benchmark.harness.peaks import bound_s
from benchmark.harness.spec import roofline_module
from benchmark.harness.trace import kernel_class


def read(rec):
    if rec.device is None:
        return None
    took = rec.device.seconds_by(kernel_class).get("port_flash")
    launches = rec.launches(("flash_attention",))
    if not took or not launches:
        return None
    least = sum(n * bound_s(*roofline_module(k).work(**shape)) for k, shape, n in launches)
    return 100.0 * least / took
