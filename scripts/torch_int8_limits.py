#!/usr/bin/env python3
"""The CPU run that set chip_smoke.py's int8-engine limit (phase 9,
INT8_TWIN_REL_LIMIT).

On the card an int8 configuration of the serving engine is held against its
plain twin (attention 'torch', enhance 'plain', the float64 int8 product).
K1 and the int8 product are exact against their plain versions, so the two
differ only where K2/K3 round a bf16 attention output the other way than
the plain attention (a different float32 summation order); the bf16 engine
reads 3-4% max|Δ|/max|ref| from that on an H100 (NVIDIA H100 80GB HBM3,
700.00 W), under its limit chip_smoke.BF16_ENGINE_REL_LIMIT = 0.1.

This script makes that kind of difference on the CPU: one arm runs the
plain attention as it is, the other computes the same attention in float64
before the same rounding to bf16, so some outputs round the other way. It
measures max|Δ|/max|ref| between the arms for the bf16 engine and for each
of chip_smoke.INT8_CONFIGS, at full width and full depth on 4 raw frames,
and prints each configuration's ratio to the bf16 spread and the limit
that follows: BF16_ENGINE_REL_LIMIT times the largest ratio.

    python3 scripts/torch_int8_limits.py

A few minutes and ~8 GB of memory on 8 cores; no card needed.
"""

import dataclasses
import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from thermal3d_torch.core.config import DUSTR_224_LINEAR  # noqa: E402
from thermal3d_torch.infer.engine import InferenceEngine  # noqa: E402

# the module (thermal3d_torch.kernels re-exports its flash_attention function)
flash_attention = importlib.import_module("thermal3d_torch.kernels.flash_attention")

N_FRAMES = 4


def float64_attention(plain):
    """The plain attention computed in float64, returned as plain returns it."""

    def attend(q, k, v, scale):
        return plain(q.to(torch.float64), k.to(torch.float64), v.to(torch.float64),
                     scale).to(q.dtype)

    return attend


def spread(engine, frames) -> float:
    """max over outputs of max|Δ|/max|ref| between the float64-attention arm
    and the plain arm of one engine."""
    plain = flash_attention.attention_plain
    ref = engine.infer(frames)
    flash_attention.attention_plain = float64_attention(plain)
    try:
        other = engine.infer(frames)
    finally:
        flash_attention.attention_plain = plain
    return max(chip_smoke.rel_err(other[k], ref[k], np) for k in ref)


def main():
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16",
                              attention_impl="torch")
    frames = chip_smoke.raw_frames(np, 20)[:N_FRAMES]
    calib = chip_smoke.raw_frames(np, 30)[:chip_smoke.INT8_CALIB_FRAMES]
    bf16 = InferenceEngine(cfg, params_dtype="bfloat16", seed=0, device="cpu",
                           enhance_impl="plain")
    weights = bf16.model.state_dict()
    base = spread(bf16, frames)
    print(f"bf16 engine: max|d|/max|ref| {base:.4e}")
    del bf16
    worst = 0.0
    for name, opts in chip_smoke.INT8_CONFIGS:
        opts = dict(opts)
        kw = dict(quantize_int8=True, int8_impl="plain", int8_calibration=calib
                  if opts.pop("static", False) else None, **opts)
        eng = InferenceEngine(cfg, state_dict=weights, params_dtype="bfloat16", device="cpu",
                              enhance_impl="plain", **kw)
        s = spread(eng, frames)
        worst = max(worst, s / base)
        print(f"int8 {name!r}: max|d|/max|ref| {s:.4e}, {s / base:.2f} x the bf16 engine's")
        del eng
    print(f"largest ratio {worst:.2f}: limit {chip_smoke.BF16_ENGINE_REL_LIMIT} x {worst:.2f} = "
          f"{chip_smoke.BF16_ENGINE_REL_LIMIT * worst:.3f}")


if __name__ == "__main__":
    main()
