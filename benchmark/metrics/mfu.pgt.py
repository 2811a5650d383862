"""The whole step's share of the card's peak: the model FLOPs of the work
completed in the measured window (a step: the encoder over both views of its
pairs, each decoder branch over its pairs: patch embedding, trunk
products, attention, heads), over the window's seconds at the dtype's peak."""

from benchmark import counts, peaks

UNIT = "%"
SOURCE = "host_clock"
LAYER = "device"
MOVES = "pairs_per_s"


def images(traffic):
    return 2 * traffic["pairs"], traffic["pairs"]


def flops_per_request(cfg, traffic) -> float:
    return counts.model_flops(cfg, *images(traffic))


def read(run):
    rate = run.window.rate / run.units  # requests a second
    return 100.0 * flops_per_request(run.cfg, run.traffic) * rate / peaks.FLOPS[run.cfg["dtype"]]
