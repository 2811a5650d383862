"""Host ms the program's dispatch calls take for a step (PinnedStage.put, the
entry's async call, PinnedFetch.start): the harness's span around them,
averaged over the window's requests."""

UNIT = "ms"
SOURCE = "program_span"
LAYER = "entry"
MOVES = "pairs_per_s"


def read(run):
    reqs = run.window.requests
    return sum(r.issued - r.sent for r in reqs) * 1e3 / len(reqs) if reqs else None
