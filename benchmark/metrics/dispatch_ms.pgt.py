"""Host ms a step of the generator's entry span (`pgt.request` around
PseudoGTGenerator.run_pairs_async: both views' encoder, the decoder, the
heads and the geometry, the SVD's wait included), from the program's spans in
the traced slice."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "entry"
MOVES = "pairs_per_s"


def read(run):
    return per_request(run, ["pgt.request"], "host_ms")
