"""Frames whose outputs reached host memory in the window, a second (the
window from the completion that opened it to its last completion)."""

UNIT = "frames/s"
SOURCE = "host_clock"


def read(run):
    if run.units_name != "frames":
        return None
    return run.window.rate
