"""Work of one ``block_chain3_stem`` launch (kernel row 1): down stage 0's
ResnetBlock pair at HR, (b, 3, h, w) -> (b, c, h, w): the stem's 3 -> c
3x3 conv and its 1x1 residual, then three c -> c 3x3 convs, the condition
(b, c, h, w) added. Each input byte read once and each output byte written
once: the 3-channel input, the condition and the output in the activation
type, the float32 weights."""


def work(b: int, h: int, w: int, c: int = 64, esize: int = 2) -> tuple[float, float]:
    flops = 2.0 * b * h * w * (27 * c + 3 * c + 27 * c * c)
    nbytes = esize * b * h * w * (3 + 2 * c) + 4 * (30 * c + 27 * c * c)
    return flops, nbytes
