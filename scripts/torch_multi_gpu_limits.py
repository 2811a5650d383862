#!/usr/bin/env python3
"""The CPU run behind chip_smoke.py's multi-GPU float32 limits (phase 10 and
the multi-device phase).

Runs, on the CPU, the arithmetic those phases hold on the card: a gloo job
of WORLD ranks (chip_smoke.run_dist_job) whose float32 steps are held
against the single-process step on the same global batch
(chip_smoke.dist_step), and prints each case's loss and gradient errors,
the ranks' optimizer bytes and what the gloo collectives moved. DUSt3R-224
at full width.

    python3 scripts/torch_multi_gpu_limits.py --depth 2 1
    python3 scripts/torch_multi_gpu_limits.py --world 4 --batch 16 --depth 4 2

With --world 2 (the default) the cases are phase 10's chip_smoke.DIST_CASES
(DP, ZeRO-1, TP over 2 ranks in float32, TP in bf16) on TrainConfig's batch
of 4 pairs, at phase 10's depth (enc 8, dec 4) unless --depth cuts it; with
--world 4 they are the multi-device phase's float32 layouts
(chip_smoke.md_layouts: DP, ZeRO-1, DP×TP 2×2, TP 4), --layouts picks some
of them, and --batch sets the global batch (the phase's 16). The errors are
those of each block's arithmetic summed in another order, so a cut depth
reads them for fewer blocks. About a minute and ~4 GB at --world 2 --depth
2 1 on 8 cores; no card needed.
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
    p.add_argument("--world", type=int, default=2, choices=(2, 4))
    p.add_argument("--layouts", nargs="+", default=None,
                   help="names of chip_smoke.md_layouts (world 4 only)")
    p.add_argument("--batch", type=int, default=None,
                   help="global pairs a step (default: 4, or 16 at world 4)")
    args = p.parse_args()
    if args.world == 2:
        cases, batch = chip_smoke.DIST_CASES, args.batch or chip_smoke.TRAIN_BATCH
        default_depth = chip_smoke.DIST_DEPTH
    else:
        cases = [(name, shape, "float32", zero1)
                 for name, shape, zero1 in chip_smoke.md_layouts(args.world)
                 if args.layouts is None or name in args.layouts]
        batch, default_depth = args.batch or chip_smoke.MD_TRAIN_BATCH, {}
    depth = default_depth if args.depth is None else dict(enc_depth=args.depth[0],
                                                          dec_depth=args.depth[1])
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with tempfile.TemporaryDirectory(prefix="mg_limits_") as out:
        chip_smoke.dist_inputs(torch, np, out, depth, batch)
        ranks = chip_smoke.run_dist_job(torch, out, args.world,
                                        dict(cases=cases, device="cpu", backend=None))
    errs = chip_smoke.dist_errors(ranks, cases)
    print(f"world {args.world}, global batch {batch}, depth {depth or 'full (24, 8)'}; "
          f"limits on the card: loss {chip_smoke.DIST_F32_LOSS_REL:.0e}, gradients "
          f"{chip_smoke.DIST_F32_GRAD_REL:.0e} (float32)")
    for name, e in errs.items():
        print(f"{name} (mesh {e['mesh']}, {e['dtype']}): loss rel {e['loss_rel']:.3e}, gradients "
              f"max|d|/max|ref| {e['grad_rel']:.3e}, grad_norm rel {e['grad_norm_rel']:.3e}, "
              f"ranks agree {e['ranks_agree']}, heads {e['heads']}, mu+nu bytes a rank "
              f"{e['slot_bytes']} (single {e['slot_bytes_single']}), host-staged "
              f"{e['staged'][0]}")


if __name__ == "__main__":
    main()
