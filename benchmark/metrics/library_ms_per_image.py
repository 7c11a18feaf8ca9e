"""cuDNN and cuBLAS: the device milliseconds of the library's convs and
matrix products per image of the traced run."""

from benchmark.harness.trace import kernel_class


def read(rec):
    if rec.device is None or not rec.traced_images:
        return None
    s = rec.device.seconds_by(kernel_class).get("library")
    return None if s is None else 1e3 * s / rec.traced_images
