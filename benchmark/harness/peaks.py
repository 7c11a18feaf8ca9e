"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, no sparsity, at the full 700 W power limit). Every roofline share
and ``mfu`` is stated against these, with the card's power limit beside
it in the run's ``device``."""

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
