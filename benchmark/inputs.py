"""What the request paths share to make their input pools from --seed.

A path's `make_pool(traffic, seed, device)` reads only its traffic file's
parameters. Pools are drawn on the device from a torch.Generator (one stream
of the run's seed) in a few large calls and kept in host memory as numpy
arrays, which is what a user hands the program. Every seed gives the same
sizes; only the pixels and the order of the requests differ.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.weights import torch_seed


def generator(traffic, seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, traffic["stream"]))
    return gen


def smooth(n: int, channels: int, cells, out_hw, gen, device) -> torch.Tensor:
    """[n, channels, H, W] smooth fields in [0, 1]: uniform values on a coarse
    grid of `cells`, bilinearly upsampled, plus a finer octave at half weight."""
    coarse = torch.rand(n, channels, *cells, generator=gen, device=device)
    fine = torch.rand(n, channels, 2 * cells[0], 2 * cells[1], generator=gen, device=device)
    field = (2.0 * F.interpolate(coarse, size=out_hw, mode="bilinear", align_corners=True)
             + F.interpolate(fine, size=out_hw, mode="bilinear", align_corners=True)) / 3.0
    return field


def request_order(traffic, seed: int):
    """Pool index of each request, in turn: seeded permutations of the pool,
    one after another, so each seed sends every entry equally often."""
    rng = np.random.default_rng(torch_seed(seed, traffic["stream"] + 1))
    while True:
        yield from (int(i) for i in rng.permutation(traffic["pool"]))
