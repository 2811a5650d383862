"""The whole window's share of the card's peak: the model FLOPs of the work
completed in the measured window (a window: patch embedding, every product
of the trunk, the aggregator and the camera head, every attention call, both
DPT heads' convolutions), over the window's seconds at the dtype's peak."""

from benchmark import counts_vggt, peaks

UNIT = "%"
SOURCE = "host_clock"
LAYER = "device"
MOVES = "frames_per_s"


def read(run):
    rate = run.window.rate / run.units  # requests a second
    flops = counts_vggt.window_flops(run.cfg, run.traffic["frames"])
    return 100.0 * flops * rate / peaks.FLOPS[run.cfg["dtype"]]
