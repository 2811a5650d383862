"""Trunk GEMMs against their roofline, a window: the products of the patch
trunk's, the frame blocks' and the global blocks' Dense layers over every
token of the window.

The least time of every product, each the larger of 2·M·K·N operations at
the dtype's peak and its operands and output moved once at the memory's,
summed; over the device time of the trunk's GEMM kernels in the traced
slice, a request. cuBLAS runs each such product (a bias-add GEMM, bfloat16)
as an `nvjet` kernel with a bias epilogue and a tile of at least 64 rows
and columns; the camera head's products, on the window's 24 camera tokens
in float32, are left out (in bfloat16 they took tiles 24 wide,
`nvjet_tst_64x24_...`: NVIDIA H100, torch 2.11.0+cu128). Where the trace holds another number of trunk kernels
than the trunk has products, the metric reads nothing."""

import re

from benchmark import counts_vggt, peaks

UNIT = "%"
SOURCE = "device_trace"
LAYER = "trunk GEMMs"
MOVES = "frames_per_s"
TILE = re.compile(r"nvjet_[a-z]+_(\d+)x(\d+)_")
MIN_TILE = 64


def trunk_kernel(low: str) -> bool:
    tile = TILE.search(low)
    return "_bias_" in low and tile is not None and min(map(int, tile.groups())) >= MIN_TILE


def products(cfg, traffic):
    return counts_vggt.trunk_products(cfg, traffic["frames"])


def least_s(cfg, traffic) -> float:
    size = peaks.BYTES[cfg["dtype"]]
    return sum(peaks.least_s(counts_vggt.product_flops([p]), counts_vggt.product_bytes([p], size),
                             cfg["dtype"]) for p in products(cfg, traffic))


def read(run):
    if run.trace is None:
        return None
    expected = len(products(run.cfg, run.traffic)) * run.trace.requests
    if run.trace.kernel_count(trunk_kernel) != expected:
        return None
    ms = run.trace.kernel_ms(trunk_kernel) / run.trace.requests
    return 100.0 * least_s(run.cfg, run.traffic) * 1e3 / ms if ms > 0 else None
