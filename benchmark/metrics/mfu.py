"""The whole serve: the model FLOP of one request, counted on the plain
reference at the cell's shapes (``torch.utils.flop_counter`` on the meta
device, so the same whatever implements it), times the requests of the
window, over its seconds by the host's clock and the card's bf16 peak, in
%: the whole serve's share of the peak, which bounds every kernel's."""

from benchmark.harness.peaks import PEAK_FLOPS


def read(rec):
    if rec.flops is None or not rec.window.timed:
        return None
    return 100.0 * rec.flops * len(rec.window.timed) / rec.window.seconds / PEAK_FLOPS["bfloat16"]
