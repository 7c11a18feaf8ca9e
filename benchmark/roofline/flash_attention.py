"""Work of one ``flash_attention`` launch (kernel row 7): softmax(q k^T /
sqrt(d)) v over (b, l, h, d) q, k and v, self-attention (l queries and l
keys): two products of 2 b h l^2 d operations each. Bytes: q, k, v read and
the output written once, in bfloat16."""


def work(b: int, l: int, h: int, d: int, esize: int = 2) -> tuple[float, float]:  # noqa: E741
    return 4.0 * b * h * l * l * d, esize * b * l * h * d * 4
