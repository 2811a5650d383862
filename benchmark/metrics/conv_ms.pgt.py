"""Device ms a step of the convolution kernels (cuDNN: the DPT heads'
convolutions and transposed convolutions, and the patch embedding)."""

from benchmark.trace import name_matcher

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "heads"
MOVES = "pairs_per_s"
KERNELS = name_matcher(("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit", "cudnn"))


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms(KERNELS)
    return ms / run.trace.requests if ms > 0 else None
