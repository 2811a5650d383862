#!/usr/bin/env python3
"""The CPU run behind chip_smoke.py's multi-GPU limits (phase 10).

Runs, on the CPU, the arithmetic phase 10 holds on the card: the 2-rank
gloo job of chip_smoke.DIST_CASES (chip_smoke.run_dist_job: DP, ZeRO-1 and
Megatron TP over 2 ranks, float32, and TP in bf16) against the
single-process step on the same global batch (chip_smoke.dist_step), and
prints each case's loss and gradient errors, the ranks' optimizer bytes and
what the gloo collectives moved. DUSt3R-224 at full width; the depth is
phase 10's (enc 8, dec 4) unless --depth ENC DEC cuts it further (the
errors are those of one block's arithmetic, summed in another order).

    python3 scripts/torch_multi_gpu_limits.py --depth 2 1

A minute and ~4 GB at --depth 2 1 on 8 cores; no card needed.
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--depth", type=int, nargs=2, default=None, metavar=("ENC", "DEC"))
    args = p.parse_args()
    depth = chip_smoke.DIST_DEPTH if args.depth is None else dict(
        enc_depth=args.depth[0], dec_depth=args.depth[1])
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with tempfile.TemporaryDirectory(prefix="mg_limits_") as out:
        chip_smoke.dist_inputs(torch, np, out, depth)
        refs = {dtype: chip_smoke.dist_step(torch, out, "cpu", dtype)
                for dtype in ("float32", "bfloat16")}
        ranks = chip_smoke.run_dist_job(torch, out, device="cpu")
    errs = chip_smoke.dist_errors(refs, ranks)
    print(f"depth {depth}; limits on the card: loss {chip_smoke.DIST_F32_LOSS_REL:.0e}, "
          f"gradients {chip_smoke.DIST_F32_GRAD_REL:.0e} (float32)")
    for name, e in errs.items():
        print(f"{name} ({e['dtype']}): loss rel {e['loss_rel']:.3e}, gradients "
              f"max|d|/max|ref| {e['grad_rel']:.3e}, grad_norm rel {e['grad_norm_rel']:.3e}, "
              f"ranks agree {e['ranks_agree']}, heads {e['heads']}, mu+nu bytes a rank "
              f"{e['slot_bytes']} (single {e['slot_bytes_single']}), host-staged {e['staged']}")


if __name__ == "__main__":
    main()
