"""95th percentile over every request sent in the window: from the moment it
is handed to the program to the moment its outputs are in numpy.

A per-layer reading, not an end-to-end metric: in a closed loop of two
clients the host's work a chunk (the staging copy, the launches, the fetch)
is about the card's, so a host that slows for some seconds moves this tail
by up to a quarter from one run to the next on the same code."""

from benchmark.loop import percentile

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "entry"
MOVES = "frames_per_s"


def read(run):
    return percentile([(r.done - r.sent) * 1e3 for r in run.window.requests], 95)
