"""K2, the fused RoPE self-attention, against its roofline, a window: the
frame blocks' calls over each frame and the global blocks' over the whole
window's tokens (at 24 frames, B=24 S=1374 and B=1 S=32,976).

The least time of every call, each the larger of 4·B·S²·C operations (QK^T
and PV) at the dtype's peak and q, k, v read once, the output written once
and the cos/sin tables at the memory's, summed; over the device time of the
rope_attention kernels (the K prologue and the key-tile kernel) in the
traced slice, a request."""

from benchmark import counts_vggt, peaks
from benchmark.trace import name_matcher

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K2/K3"
MOVES = "frames_per_s"
KERNELS = name_matcher(("rope_attention",))


def calls(cfg, traffic):
    return counts_vggt.k2_calls(cfg, traffic["frames"])


def least_s(cfg, traffic) -> float:
    size = peaks.BYTES[cfg["dtype"]]
    return sum(peaks.least_s(counts_vggt.attention_flops([c]),
                             counts_vggt.attention_bytes([c], size), cfg["dtype"])
               for c in calls(cfg, traffic))


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms(KERNELS) / run.trace.requests
    return 100.0 * least_s(run.cfg, run.traffic) * 1e3 / ms if ms > 0 else None
