"""Evaluate thermal depth against pseudo-GT — `python -m thermal3d_torch.cli.evaluate`
(counterpart of thermal3d/cli/evaluate.py, utils/evaluate_depth_metrics.py:247-401).

The flags are the JAX CLI's; unless --no_vis, each frame also gets its
`{base}_comparison.png` panel; --ndev N serves over N devices
(cli/common.py::make_dp_mesh); --scan_layers is accepted and the model runs
unrolled (cli/common.py::apply_scan).
"""

from __future__ import annotations

import argparse
import glob
import os

from thermal3d_torch.cli.common import (add_preset_flag, apply_preset, apply_scan,
                                        make_dp_mesh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermal3d_torch.cli.evaluate",
                                description="Evaluate Thermal DUSt3R on a test set "
                                            "(PyTorch/CUDA)")
    p.add_argument("--model", type=str, default=None,
                   help=".pth checkpoint (dust3r or ThermalDUSt3R layout)")
    p.add_argument("--thermal_dir", type=str, required=True)
    p.add_argument("--pseudo_gt_dir", type=str, required=True,
                   help="directory with *_depth.npy pseudo-GT files")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--img_size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--num_samples", type=int, default=0, help="0 = all")
    p.add_argument("--batch_size", type=int, default=36,
                   help="frames a batch; the final partial batch is padded")
    p.add_argument("--no_thermal_model", action="store_true")
    p.add_argument("--no_vis", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    return add_preset_flag(p)


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.evaluation.evaluator import evaluate_test_set
    from thermal3d_torch.infer.engine import InferenceEngine

    parser = build_parser()
    args = parser.parse_args(argv)
    mesh = make_dp_mesh(args.ndev, args.batch_size, parser.error, args.device)
    config = apply_preset(DUSTR_224_LINEAR, args.model_preset, args.img_size,
                          args.compute_dtype)
    config = apply_scan(config, args.scan_layers)
    state, head_state = (None, None) if args.model is None else load_pth(args.model, config)
    engine = InferenceEngine(config, state_dict=state, thermal_head_state=head_state,
                             use_thermal_head=not args.no_thermal_model, device=args.device,
                             mesh=mesh)

    thermal_paths = sorted(glob.glob(os.path.join(args.thermal_dir, "*.png")))
    if args.num_samples:
        thermal_paths = thermal_paths[: args.num_samples]
    summary = evaluate_test_set(engine, thermal_paths, args.pseudo_gt_dir,
                                output_dir=args.output_dir, save_visualizations=not args.no_vis,
                                batch_size=args.batch_size)
    if summary:
        print("\nAverage metrics:")
        print(f"RMSE: {summary['rmse']:.4f}")
        print(f"Acc[<1.25]: {summary['acc_1']:.4f}")
        print(f"Acc[<1.25^2]: {summary['acc_2']:.4f}")
    else:
        print("No valid metrics computed")
    return summary


if __name__ == "__main__":
    main()
