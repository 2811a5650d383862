"""Grid search over the thermal-loss weights —
`python -m thermal3d_torch.cli.grid_search` (counterpart of
thermal3d/cli/grid_search.py, run_grid_search_thermal_parameters.sh).

Sweeps edge_weight × smoothness_weight (default {0.3,0.5,0.7}×{0.1,0.3,0.5})
with short trainings from the same weights, picks the lowest validation loss,
and writes best_params.json and run_best_params.sh (the training command for
the best pair). The JAX CLI's flags plus --model_preset, --device and the
parser errors of cli/common.py.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

from thermal3d_torch.cli.common import add_preset_flag, apply_preset, refuse_unported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Grid search thermal loss weights (PyTorch/CUDA)")
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--pseudo_gt_dir", type=str, required=True)
    p.add_argument("--weights", type=str, required=True,
                   help="DUSt3R .pth checkpoint, or a checkpoint directory of cli.train")
    p.add_argument("--output_dir", type=str, default="grid_search_results")
    p.add_argument("--edge_weights", type=float, nargs="*", default=[0.3, 0.5, 0.7])
    p.add_argument("--smoothness_weights", type=float, nargs="*", default=[0.1, 0.3, 0.5])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--frame_skip", type=int, default=3)
    p.add_argument("--img_size", type=int, nargs=2, default=[224, 224])
    return add_preset_flag(p)


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, LossConfig, TrainConfig
    from thermal3d_torch.core.device import resolve_device
    from thermal3d_torch.data.freiburg import FreiburgPairDataset
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.loop import train_and_evaluate

    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args, {})
    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device(args.device)
    model_cfg = apply_preset(DUSTR_224_LINEAR, args.model_preset, args.img_size, "bfloat16")
    base_state, _ = load_pth(args.weights, model_cfg)
    dataset = FreiburgPairDataset(args.dataset_dir, img_size=tuple(args.img_size),
                                  pseudo_gt_dir=args.pseudo_gt_dir, frame_skip=args.frame_skip)

    results = []
    for ew, sw in itertools.product(args.edge_weights, args.smoothness_weights):
        cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                          max_batches=args.max_batches, use_enhanced_loss=True,
                          loss=LossConfig(edge_weight=ew, smoothness_weight=sw))
        model = trainable_model(model_cfg, device, base_state)
        summary = train_and_evaluate(model, dataset, cfg)
        results.append({"edge_weight": ew, "smoothness_weight": sw,
                        "val_loss": summary["best_val_loss"]})
        print(f"edge={ew} smooth={sw} -> val_loss {summary['best_val_loss']:.4f}")
        del model

    best = min(results, key=lambda r: r["val_loss"])
    payload = {"results": results, "best": best}
    with open(os.path.join(args.output_dir, "best_params.json"), "w") as f:
        json.dump(payload, f, indent=2)
    cmd = (f"python -m thermal3d_torch.cli.train --dataset_dir {args.dataset_dir} "
           f"--pseudo_gt_dir {args.pseudo_gt_dir} --weights {args.weights} "
           f"--output_model thermal_dustr_best --use_thermal_aware_loss --multi_scale "
           f"--edge_weight {best['edge_weight']} "
           f"--smoothness_weight {best['smoothness_weight']}")
    with open(os.path.join(args.output_dir, "run_best_params.sh"), "w") as f:
        f.write("#!/bin/bash\n" + cmd + "\n")
    print(f"Best: {best}")
    return payload


if __name__ == "__main__":
    main()
