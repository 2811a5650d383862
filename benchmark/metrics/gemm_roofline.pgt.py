"""Trunk GEMMs against their roofline, a step: the encoder over both views of
its pairs, each decoder branch over its pairs.

The least time of every product of the encoder and decoder blocks and the
decoder embedding, each the larger of 2·M·K·N operations at the dtype's
peak and its operands and output moved once at the memory's, summed; over
the device time of the trunk's GEMM kernels in the traced slice, a request.
cuBLAS runs every trunk product (a bias-add GEMM, bfloat16) as an `nvjet`
kernel with a bias epilogue; the float32 products of the heads and the
resizes run other kernels. Where the trace holds another number of such
kernels than the trunk has products, the metric reads nothing."""

from benchmark import counts, peaks

UNIT = "%"
SOURCE = "device_trace"
LAYER = "trunk GEMMs"
MOVES = "pairs_per_s"


def trunk_kernel(low: str) -> bool:
    return "nvjet" in low and "_bias_" in low


def images(traffic):
    return 2 * traffic["pairs"], traffic["pairs"]


def products(cfg, traffic):
    return counts.trunk_products(cfg, *images(traffic))


def operations(cfg, traffic) -> float:
    return counts.product_flops(products(cfg, traffic))


def bytes_moved(cfg, traffic) -> float:
    return counts.product_bytes(products(cfg, traffic), peaks.BYTES[cfg["dtype"]])


def least_s(cfg, traffic) -> float:
    size = peaks.BYTES[cfg["dtype"]]
    return sum(peaks.least_s(counts.product_flops([p]), counts.product_bytes([p], size),
                             cfg["dtype"]) for p in products(cfg, traffic))


def read(run):
    if run.trace is None:
        return None
    expected = len(products(run.cfg, run.traffic)) * run.trace.requests
    if run.trace.kernel_count(trunk_kernel) != expected:
        return None
    ms = run.trace.kernel_ms(trunk_kernel) / run.trace.requests
    return 100.0 * least_s(run.cfg, run.traffic) * 1e3 / ms if ms > 0 else None
