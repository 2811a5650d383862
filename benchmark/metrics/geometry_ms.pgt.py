"""Host ms a step of the geometry (`pgt.geometry`: the intrinsics' median
focal fit and the Umeyama pose, whose SVD waits for the step's device work),
from the program's spans in the traced slice."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "geometry"
MOVES = "pairs_per_s"


def read(run):
    return per_request(run, ["pgt.geometry"], "host_ms")
