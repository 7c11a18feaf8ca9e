"""Device memory: the most the caching allocator held from the end of
the program's build to the window's close (``torch.cuda.max_memory_reserved``,
the graphs' pools included), in GiB."""


def read(rec):
    return None if rec.peak_reserved is None else rec.peak_reserved / 2**30
