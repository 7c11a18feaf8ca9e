"""Kernel routing (``models/layers.py``'s gates): the port's kernel
wrappers' launches (every wrapper's ``launches`` counter, which a graph
replay adds as its capture counted) over the window's calls, those still
in flight at its close included, per image they served."""


def read(rec):
    images = rec.images_per_request * len(rec.window.attempted)
    if not images:
        return None
    return sum(v for k, v in rec.counts.items() if k.endswith(".launches")) / images
