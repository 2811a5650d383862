"""Device ms a window between the events of `vggt.heads` (the depth and
point DPT heads over every frame and the camera head's rounds), from the
program's spans in the traced slice; None without a card."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "heads"
MOVES = "frames_per_s"


def read(run):
    return per_request(run, ["vggt.heads"], "device_ms")
