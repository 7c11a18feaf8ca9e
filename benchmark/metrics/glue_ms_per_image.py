"""Glue: the device milliseconds of elementwise kernels, norms, copies and
fills (the profile tool's class) per image of the traced run."""

from benchmark.harness.trace import kernel_class


def read(rec):
    if rec.device is None or not rec.traced_images:
        return None
    s = rec.device.seconds_by(kernel_class).get("glue")
    return None if s is None else 1e3 * s / rec.traced_images
