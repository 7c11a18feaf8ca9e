"""Captured programs (``core/graphs.py``): the seconds that capturing the
cell's CUDA graphs took in set-up (``Entry.capture_s`` and
``Program.capture_s`` of the pipeline's graph cache); nothing on a path
that captures none."""


def read(rec):
    return rec.capture_s
