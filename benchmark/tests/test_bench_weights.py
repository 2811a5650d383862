"""The seeded weights, made from the layout of the configuration's family,
equal bit for bit the draw the benchmark made when dust3r's layout and head
tensors were named in `benchmark/weights.py` itself: a frozen copy of that
draw is below."""

from __future__ import annotations

import json
import math

import pytest
import torch

from benchmark.reference.model import param_shapes
from benchmark.tests.conftest import REPO, tiny_config
from benchmark.weights import DTYPES, make_weights, torch_seed


def frozen_make_weights(cfg, seed: int, device):
    """make_weights with dust3r's layout and pointmap-head tensors named in
    it, as the benchmark made its weights before the family gave them."""
    spec = cfg["weights"]
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, spec["stream"]))
    flat = torch.randn(total, generator=gen, device=device, dtype=DTYPES[cfg["dtype"]])
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        offset += n
        if len(shape) > 1:
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith(".bias"):
            t.mul_(spec["bias_std"])
        else:
            t.mul_(spec["norm_std"]).add_(1.0)
        out[name] = t
    heads = ("downstream_head1", "downstream_head2")
    if "head_out_scale" in spec:
        for h in heads:
            name = f"{h}.proj.weight" if cfg["head_type"] == "linear" else f"{h}.dpt.head.4.weight"
            out[name].mul_(spec["head_out_scale"])
    if "z_bias" in spec:
        p2 = cfg["patch_size"] ** 2
        for h in heads:
            if cfg["head_type"] == "linear":
                out[f"{h}.proj.bias"][2 * p2:3 * p2] = spec["z_bias"]
            else:
                out[f"{h}.dpt.head.4.bias"][2] = spec["z_bias"]
    return out


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["dustr224_linear", "mastr512_catmlpdpt"])
def test_weights_equal_the_frozen_draw_bit_for_bit(config, dtype, seed):
    cfg = tiny_config(json.loads((REPO / "benchmark" / "configs" / f"{config}.json")
                                 .read_text()), dtype)
    got, want = make_weights(cfg, seed, "cpu", REPO), frozen_make_weights(cfg, seed, "cpu")
    assert list(got) == list(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
