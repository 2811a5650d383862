"""Device ms of the host-device copies (Memcpy spans) for a chunk in the
traced slice: the staged inputs in and the fetched outputs out."""

from benchmark.trace import name_matcher

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "pipeline"
MOVES = "frames_per_s"
KERNELS = name_matcher(("memcpy",))


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms(KERNELS)
    return ms / run.trace.requests if ms > 0 else None
