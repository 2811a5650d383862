"""Host ms a window of the generator's entry span (`vggt.request` around
WindowGenerator.run_window_async: the patch trunk, the aggregator, the
heads), from the program's spans in the traced slice."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "entry"
MOVES = "frames_per_s"


def read(run):
    return per_request(run, ["vggt.request"], "host_ms")
