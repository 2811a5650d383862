"""Process start to the first timed request: imports, kernel libraries,
input pool, weights, the program's build and the warm-up requests."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_seconds
