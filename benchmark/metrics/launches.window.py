"""Device events (kernels and copies) a window in the traced slice."""

UNIT = "count"
SOURCE = "device_trace"
LAYER = "entry"
MOVES = "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return len(run.trace.spans) / run.trace.requests
