"""Share of the traced slice in which no kernel or copy ran on the device:
1 - (union of the device spans) / (the slice's host-clock length)."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    if run.trace is None or not run.trace.spans:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
