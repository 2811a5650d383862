"""Device ms a step between the events of `model.heads` (both views' DPT
heads: convolutions, float32 resizes, casts and elementwise work), from the
program's spans in the traced slice; None without a card."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "heads"
MOVES = "pairs_per_s"


def read(run):
    return per_request(run, ["model.heads"], "device_ms")
