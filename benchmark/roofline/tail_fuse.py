"""Work of one ``tail_fuse`` launch (kernel row 3): the last Upsample (a
ConvTranspose k4 s2 p1, c -> c) from (b, c, h/2, w/2) to HR (h, w), the
final Block's c -> c 3x3 with Mish and the 1x1 conv to ``cout`` channels.
Bytes: the input and the output in the activation type, the float32
weights."""


def work(b: int, h: int, w: int, c: int = 64, cout: int = 3, esize: int = 2) -> tuple[float, float]:
    flops = 2.0 * b * h * w * (4 * c * c + 9 * c * c + cout * c)
    nbytes = esize * (b * (h // 2) * (w // 2) * c + b * h * w * cout) + 4 * (25 * c * c + cout * c)
    return flops, nbytes
