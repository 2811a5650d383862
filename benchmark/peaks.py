"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit). Every roofline and MFU of the
benchmark is stated against these; a run prints the card's power limit."""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time of a piece of work: the larger of its operations at
    the dtype's peak and its bytes at the memory's."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
