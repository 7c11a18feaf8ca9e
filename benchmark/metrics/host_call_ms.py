"""Entry layer: the mean host time of a call into the program's entry
(``SRDiffPipeline.upscale_batch_device``, ``upscale_device``) until it
returns, over every request of the window: the benchmark's own span around
each call."""


def read(rec):
    calls = [r.t_return - r.t_call for r in rec.window.timed]
    return 1e3 * sum(calls) / len(calls) if calls else None
