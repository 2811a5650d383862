"""K2/K3, the fused RoPE self- and cross-attention, against their roofline,
a step: the encoder over both views of its pairs, each decoder branch over its pairs.

The least time of every call, each the larger of 4·B·S²·C operations (QK^T
and PV) at the dtype's peak and q, k, v read once, the output written once
and the cos/sin tables at the memory's, summed; over the device time of the
rope_attention kernels in the traced slice, a request."""

from benchmark import counts, peaks
from benchmark.trace import name_matcher

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K2/K3"
MOVES = "pairs_per_s"
KERNELS = name_matcher(("rope_attention",))


def images(traffic):
    return 2 * traffic["pairs"], traffic["pairs"]


def calls(cfg, traffic):
    return counts.attention_calls(cfg, *images(traffic))


def operations(cfg, traffic) -> float:
    return counts.attention_flops(calls(cfg, traffic))


def bytes_moved(cfg, traffic) -> float:
    return counts.attention_bytes(calls(cfg, traffic), peaks.BYTES[cfg["dtype"]])


def least_s(cfg, traffic) -> float:
    size = peaks.BYTES[cfg["dtype"]]
    return sum(peaks.least_s(counts.attention_flops([c]), counts.attention_bytes([c], size),
                             cfg["dtype"]) for c in calls(cfg, traffic))


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms(KERNELS) / run.trace.requests
    return 100.0 * least_s(run.cfg, run.traffic) * 1e3 / ms if ms > 0 else None
