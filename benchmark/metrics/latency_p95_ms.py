"""95th percentile over every request sent in the window: from the moment it
is handed to the program to the moment its outputs are in numpy."""

from benchmark.loop import percentile

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    return percentile([(r.done - r.sent) * 1e3 for r in run.window.requests], 95)
