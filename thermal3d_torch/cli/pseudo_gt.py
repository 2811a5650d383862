"""Generate pseudo-GT with a frozen MASt3R — `python -m thermal3d_torch.cli.pseudo_gt`
(counterpart of thermal3d/cli/pseudo_gt.py, scripts/pseudo_gt.py:613-661,
and scripts/test_pseudo_gt.py through --test_set).

The flags are the JAX CLI's, with its parser errors. --int8 runs the trunk
GEMMs in int8 (kernels/quant.py; --int8_scope, --int8_equalize, and
--int8_static_acts, which calibrates static activation scales on the first
batch of pairs that decode); --ndev N runs each batch over N devices
(cli/common.py::make_dp_mesh); --scan_layers is accepted and the model runs
unrolled (cli/common.py::apply_scan).

--model vggt1b labels the drives' RGB frames (those with an aligned thermal
frame, data.freiburg.build_rgb_thermal_index) in windows of --window
consecutive frames with a frozen VGGT-1B (pseudo_gt/window.py): depth, world
points, their confidences and a camera a frame, one npy file each. Its
frames are 518x518 (the published position embedding's size), and it takes
no size, pair, int8, mesh, calibration, test-set or figure option; its
checkpoint has no loader yet, so it runs on seeded weights.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from thermal3d_torch.cli.common import (add_preset_flag, apply_preset, apply_scan,
                                        make_dp_mesh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m thermal3d_torch.cli.pseudo_gt",
        description="Generate pseudo-GT from RGB pairs with MASt3R (PyTorch/CUDA)")
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--weights", type=str, default=None,
                   help="MASt3R .pth checkpoint; random init if omitted")
    p.add_argument("--model", type=str, default="mastr512", choices=["mastr512", "vggt1b"],
                   help="MASt3R-512 on RGB pairs, or VGGT-1B on windows of frames")
    p.add_argument("--window", type=int, default=24,
                   help="frames a VGGT-1B window (--model vggt1b)")
    p.add_argument("--img_size", type=int, nargs=2, default=None,
                   help="model input size (MASt3R: 512 512 by default; VGGT takes 518 "
                        "518 only)")
    p.add_argument("--frame_skip", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--visualize", action="store_true",
                   help="2x2 RGB/depth panels of the first 10 pairs")
    p.add_argument("--calib_file", type=str, default=None)
    p.add_argument("--max_pairs", type=int, default=None)
    p.add_argument("--test_set", action="store_true",
                   help="monocular test-set mode (test_pseudo_gt.py layout)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--int8", action="store_true",
                   help="int8 trunk GEMMs (opt-in: gate the outputs with cli.parity)")
    p.add_argument("--int8_scope", type=str, default="all", choices=["all", "mlp", "fc1"])
    p.add_argument("--int8_equalize", action="store_true",
                   help="SmoothQuant-style LN-to-GEMM fold before quantizing")
    p.add_argument("--int8_static_acts", action="store_true",
                   help="static per-GEMM activation scales from one float forward over "
                        "the first pair batch")
    p.add_argument("--dpt_f32", action="store_true",
                   help="pin the DPT/catmlpdpt head in float32")
    p.add_argument("--num_shards", type=int, default=1,
                   help="split the pair/frame index into N deterministic shards "
                        "(index[i::N]); pair filenames are disjoint, so shards can "
                        "share one --output_dir")
    p.add_argument("--shard_id", type=int, default=0,
                   help="which shard this process generates (0..N-1)")
    return add_preset_flag(p)


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.data.freiburg import build_rgb_pair_index, build_rgb_thermal_index
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator, generate_pseudo_gt
    from thermal3d_torch.pseudo_gt.test_set import generate_test_set_pseudo_gt

    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.int8_equalize or args.int8_static_acts) and not args.int8:
        parser.error("--int8_equalize/--int8_static_acts require --int8")
    if not 0 <= args.shard_id < args.num_shards:
        parser.error(f"--shard_id {args.shard_id} out of range for "
                     f"--num_shards {args.num_shards}")
    if args.model == "vggt1b":
        return _windows(args, parser)
    mesh = make_dp_mesh(args.ndev, args.batch_size, parser.error, args.device)
    config = apply_preset(MASTR_512_CATMLPDPT, args.model_preset, args.img_size or [512, 512],
                          args.compute_dtype)
    config = apply_scan(config, args.scan_layers)
    if args.dpt_f32:
        config = dataclasses.replace(
            config, head=dataclasses.replace(config.head, dpt_dtype="float32"))
    state = None
    if args.weights:
        state, _ = load_pth(args.weights, config)
        print(f"Loaded MASt3R checkpoint: {len(state)} tensors")

    if args.test_set:
        items = build_rgb_thermal_index(args.dataset_dir)
    else:
        items = build_rgb_pair_index(args.dataset_dir, frame_skip=args.frame_skip)
        print(f"Created {len(items)} RGB pairs")
    if args.num_shards > 1:
        # strided: deterministic and balanced across day/night sequences
        items = items[args.shard_id::args.num_shards]
        print(f"Shard {args.shard_id}/{args.num_shards}: {len(items)} "
              f"{'frames' if args.test_set else 'pairs'}")

    int8_kw = {}
    if args.int8:
        int8_kw = dict(quantize_int8=True, int8_only=SCOPE_TO_ONLY[args.int8_scope],
                       int8_equalize=args.int8_equalize)
        if args.int8_static_acts:
            int8_kw["int8_calibration"] = _first_pair_batch(
                items, config.img_size, args.batch_size, args.test_set, parser)
    gen = PseudoGTGenerator(config, state_dict=state, batch_size=args.batch_size,
                            calib_file=args.calib_file, device=args.device, mesh=mesh,
                            **int8_kw)
    if args.test_set:
        n = generate_test_set_pseudo_gt(items, args.output_dir, gen, max_frames=args.max_pairs)
    else:
        n = generate_pseudo_gt(items, args.output_dir, gen, visualize=args.visualize,
                               max_pairs=args.max_pairs)
    print(f"Pseudo-GT generation complete: {n} items -> {args.output_dir}")
    return n


def _windows(args, parser) -> int:
    """--model vggt1b: windows of frames through WindowGenerator."""
    from thermal3d_torch.core.config import VGGT_1B, VGGT_TINY
    from thermal3d_torch.data.freiburg import build_rgb_thermal_index
    from thermal3d_torch.pseudo_gt.window import (WindowGenerator, frame_windows,
                                                  generate_window_pseudo_gt)

    refused = [flag for flag, on in (
        ("--weights", args.weights), ("--int8", args.int8), ("--test_set", args.test_set),
        ("--visualize", args.visualize), ("--calib_file", args.calib_file),
        ("--dpt_f32", args.dpt_f32), ("--ndev", args.ndev != 1),
        ("--img_size", args.img_size is not None)) if on]
    if refused:
        parser.error(f"--model vggt1b takes none of {', '.join(refused)} (no VGGT "
                     "checkpoint loader yet; its position embedding fixes 518x518 frames; "
                     "windows run on one device)")
    if args.window < 1:
        parser.error("--window must be at least 1")
    config = dataclasses.replace(VGGT_TINY if args.model_preset == "tiny" else VGGT_1B,
                                 compute_dtype=args.compute_dtype)
    frames = build_rgb_thermal_index(args.dataset_dir)
    if args.num_shards > 1:  # whole windows a shard, each in its drive's order
        windows = frame_windows(frames, args.window)[args.shard_id::args.num_shards]
        frames = [f for w in windows for f in w]
    print(f"{len(frames)} RGB frames")
    gen = WindowGenerator(config, frames=args.window, device=args.device)
    n = generate_window_pseudo_gt(frames, args.output_dir, gen, max_frames=args.max_pairs)
    print(f"Pseudo-GT generation complete: {n} items -> {args.output_dir}")
    return n


def _first_pair_batch(items, hw, batch_size: int, test_set: bool, parser):
    """The calibration sample of --int8_static_acts: the first batch_size
    entries whose frames decode, as (rgb1, rgb2); a test-set frame is its
    own pair."""
    from thermal3d_torch.pseudo_gt.generator import decode_rgb_pairs

    keys = ("rgb", "rgb") if test_set else ("rgb_path1", "rgb_path2")
    r1s, r2s, n = [], [], 0
    for i in range(0, len(items), batch_size):
        r1, r2, kept = decode_rgb_pairs(items[i:i + batch_size], hw, keys)
        r1s.append(r1)
        r2s.append(r2)
        n += len(kept)
        if n >= batch_size:
            break
    if not n:
        parser.error("--int8_static_acts: no decodable RGB pairs to calibrate on")
    return (np.concatenate(r1s)[:batch_size], np.concatenate(r2s)[:batch_size])


if __name__ == "__main__":
    main()
