"""Host ms a chunk of the engine's entry span (`engine.request` around
InferenceEngine.infer_async: resize, K1, thermal head, encoder, decoder and
head launches), from the program's spans in the traced slice."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "entry"
MOVES = "frames_per_s"


def read(run):
    return per_request(run, ["engine.request"], "host_ms")
