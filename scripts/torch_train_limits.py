#!/usr/bin/env python3
"""The CPU run that set chip_smoke.py's training-phase limits (phase 7).

Runs, on the CPU, the arithmetic phase 7 holds on the card: the K2/K3/K4
autograd Functions (plain forward, the restated backward) at the training
shapes against float64 autograd, in bf16 and float32
(chip_smoke.train_backward_cases); one full-width, full-depth DUSt3R-224
gradient in bf16 against its float32 twin on chip_smoke's training batch
(chip_smoke.gradient_vs_float32_twin); each raises past its limits; and
the number of 16-bit grid values v for which
v * (1/65535) and v / 65535 round differently in float32.

    python3 scripts/torch_train_limits.py

About a minute and ~10 GB of memory on 8 cores; no card needed.
"""

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from thermal3d_torch.core.config import DUSTR_224_LINEAR  # noqa: E402
from thermal3d_torch.models.dustr import trainable_model  # noqa: E402


def main():
    torch.set_num_threads(os.cpu_count() or 1)
    for case in chip_smoke.train_backward_cases(torch, device="cpu")[0]:
        print(f"{case['what']} {case['dtype']}: backward vs float64, max|d|/max|ref| "
              f"{case['max_rel_err']:.3e}")
    model = trainable_model(dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16"),
                            torch.device("cpu"), seed=0)
    batch = chip_smoke.train_batch(torch, np, device="cpu")
    chip_smoke.gradient_vs_float32_twin(torch, np, model, batch)
    v = np.arange(65536, dtype=np.float32)
    diff = int((v * (np.float32(1) / np.float32(65535)) != v / np.float32(65535)).sum())
    print(f"grid values where v * (1/65535) != v / 65535 in float32: {diff} of 65536")


if __name__ == "__main__":
    main()
