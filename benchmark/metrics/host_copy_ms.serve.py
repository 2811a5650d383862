"""Host ms a chunk of the pinned pipeline's own work (self time of
`pipeline.stage` and `pipeline.fetch`: the copies into and out of pinned
memory, without their waits on the device), from the program's spans in the
traced slice."""

from benchmark.spans import per_request

UNIT = "ms"
SOURCE = "program_span"
LAYER = "pipeline"
MOVES = "frames_per_s"


def read(run):
    return per_request(run, ["pipeline.stage", "pipeline.fetch"], "self_ms")
