"""Seeded weights of a configuration, made on the device in the dtype they
are served in, and handed alike to the program and to the reference.

The configuration's family (benchmark/reference/<its "reference">.py, loaded
from the run's root) gives the layout, `param_shapes(cfg)`. One draw of
standard normals for every weight together, from a torch.Generator on the
device seeded by --seed, then per tensor: matrices and conv kernels scaled
by 1/sqrt(fan_in) (fan_in = the product of all but the first axis), biases
by `bias_std`, LayerNorm scales 1 + `norm_std` times the draw; with
`head_out_scale`, the family's `head_out_weights(cfg)` scaled by it, and with
`z_bias`, each of its `z_channels(cfg)` set to it.
The same seed on the same device gives the same weights, so the
reference after the window regenerates them instead of holding a copy
through it.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import torch

from benchmark.modules import family

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the checkout that holds this harness
ROOT = Path(__file__).resolve().parents[1]


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of draws of a run's seed."""
    return (seed * 1_000_003 + stream) % (1 << 63)


def make_weights(cfg, seed: int, device, root: Path = ROOT) -> Dict[str, torch.Tensor]:
    spec = cfg["weights"]
    dtype = DTYPES[cfg["dtype"]]
    ref = family(root, cfg)
    shapes = ref.param_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, spec["stream"]))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) > 1:
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith(".bias"):
            t.mul_(spec["bias_std"])
        else:  # a LayerNorm scale
            t.mul_(spec["norm_std"]).add_(1.0)
        out[name] = t
    if "head_out_scale" in spec:
        for name in ref.head_out_weights(cfg):
            out[name].mul_(spec["head_out_scale"])
    if "z_bias" in spec:
        for name, channels in ref.z_channels(cfg):
            out[name][channels] = spec["z_bias"]
    return out


def thermal_head_state(cfg, device) -> Dict[str, torch.Tensor]:
    head = cfg["thermal_head"]
    return {k: torch.tensor(float(head[k]), dtype=torch.float32, device=device)
            for k in ("edge_weight", "temp_scale")}
