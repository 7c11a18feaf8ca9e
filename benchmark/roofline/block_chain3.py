"""Work of one ``block_chain3`` launch (kernel row 2): a ResnetBlock pair
of width c at (b, c, h, w) from its first conv's pre-activation and
residual: three c -> c 3x3 convs. Bytes: the two inputs and the output (and
the condition, when one is added) in the activation type, the float32
weights."""


def work(b: int, c: int, h: int, w: int, cond: bool = False, esize: int = 2) -> tuple[float, float]:
    flops = 2.0 * b * h * w * 27 * c * c
    nbytes = esize * b * h * w * (3 + int(cond)) * c + 4 * 27 * c * c
    return flops, nbytes
