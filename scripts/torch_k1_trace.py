#!/usr/bin/env python3
"""Where K1's plain version departed from the kernel on the card, and why.

The plain version of K1 once divided its grid values by the Python scalar
65535, which torch's CUDA division takes as a multiplication by the float32
reciprocal; the kernel divides as IEEE float32 does. This script restores
that division (for one call, by swapping `image_ops.grid_value`), runs both
on chip_smoke.py's serving-shape K1 input [32,224,224], and prints the
pixel of the largest difference and, for that image, the two percentile
values each way. It also counts the grid values v in [0, 65535] for which
the two divisions round differently on the card. The plain version today
divides by a tensor and is bit-equal to the kernel (chip_smoke.py phase 3).

    python3 scripts/torch_k1_trace.py

Needs one CUDA card (it builds K1 with nvcc on first use); a few seconds.
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from thermal3d_torch.kernels import image_ops  # noqa: E402


def serving_input(b=32, h=224, w=224):
    """chip_smoke.k1_cases' input at the serving shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((b, h, w), generator=gen, device="cuda")
    x[0] = 0.0
    half = torch.rand((h, w), generator=gen, device="cuda") < 0.5
    x[1] = torch.where(half, 0.2, 0.8) + 0.01 * torch.randn((h, w), generator=gen, device="cuda")
    lo, hi = x.amin(dim=(1, 2), keepdim=True), x.amax(dim=(1, 2), keepdim=True)
    return ((x - lo) / (hi - lo).clamp(min=1e-30)).contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_trace: needs a CUDA card", file=sys.stderr)
        return 1
    x = serving_input()
    out = image_ops.percentile_enhance(x)
    now = image_ops.percentile_enhance_plain(x)
    real = image_ops.grid_value
    image_ops.grid_value = lambda v: v / image_ops.GRID
    try:
        old = image_ops.percentile_enhance_plain(x)
    finally:
        image_ops.grid_value = real
    diff = (out - old).abs()
    flat = int(diff.argmax())
    b, rest = divmod(flat, x.shape[1] * x.shape[2])
    y, xx = divmod(rest, x.shape[2])
    n = x.shape[1] * x.shape[2]
    q = torch.floor(x[b].reshape(-1) * image_ops.GRID)
    found = {}
    for name, frac in (("p_lo", 2.0), ("p_hi", 98.0)):
        v = torch.kthvalue(q, math.ceil(image_ops.search_target(frac, n))).values
        found[name] = dict(v=int(v), scalar_division=(v / image_ops.GRID).item(),
                           ieee=real(v).item(), departs=bool((v / image_ops.GRID) != real(v)))
    grid = torch.arange(65536, device="cuda", dtype=torch.float32)
    departures = int(((grid / image_ops.GRID) != real(grid)).sum())
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0),
        kernel_vs_plain_max_abs_err=(out - now).abs().max().item(),
        kernel_vs_scalar_division_plain_max_abs_err=diff.max().item(),
        pixel=[b, y, xx], percentiles=found, grid_values_departing=departures)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
