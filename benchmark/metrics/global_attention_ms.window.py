"""Device ms a window between the events of the `vggt.global_attention`
spans (each global block's K2 call over the whole window's tokens), from the
program's spans in the traced slice; None without a card or without them."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "K2/K3"
MOVES = "frames_per_s"


def read(run):
    return per_request(run, ["vggt.global_attention"], "device_ms")
