"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card (1 less the union of their intervals over the
window's length), in %."""


def read(rec):
    if rec.device is None or rec.device.window_s <= 0 or not rec.device.device:
        return None
    return 100.0 * (1.0 - rec.device.busy_s() / rec.device.window_s)
