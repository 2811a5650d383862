"""Fine-tune DUSt3R on thermal pairs — `python -m thermal3d_torch.cli.train`
(counterpart of thermal3d/cli/train.py, train_thermal_dustr.py:25-58).

The JAX CLI's flags plus --device. --weights takes a .pth or a checkpoint
directory of this CLI; --output_model is such a directory (best/ and last/,
train/checkpoint.py). Parser errors naming their ROADMAP item: --mesh_shape
other than [-1] or [1], --multihost, --zero1 (multi-GPU), --scan_layers and
--ndev > 1. --no_wandb is accepted (the port logs to stdout only).
"""

from __future__ import annotations

import argparse
import dataclasses

from thermal3d_torch.cli.common import add_preset_flag, apply_preset, refuse_unported

MULTI_GPU = "ROADMAP Queue 1 item 11, multi-GPU"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fine-tune DUSt3R on thermal images with "
                                            "pseudo-GT (PyTorch/CUDA)")
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--pseudo_gt_dir", type=str, required=True)
    p.add_argument("--weights", type=str, required=True,
                   help="DUSt3R .pth checkpoint, or a checkpoint directory of this CLI")
    p.add_argument("--output_model", type=str, required=True,
                   help="checkpoint directory (best/ and last/)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--img_size", type=int, nargs=2, default=[224, 224])
    p.add_argument("--frame_skip", type=int, default=3)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--use_thermal_aware_loss", action="store_true")
    p.add_argument("--edge_weight", type=float, default=0.5)
    p.add_argument("--smoothness_weight", type=float, default=0.3)
    p.add_argument("--detail_weight", type=float, default=0.4)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--multi_scale", action="store_true")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--debug_loading", type=int, default=None, metavar="IDX",
                   help="print the index diagnostic for sample IDX and exit")
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--mesh_shape", type=int, nargs="*", default=[-1],
                   help=f"one device only: [-1] or [1] ({MULTI_GPU})")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no_wandb", action="store_true",
                   help="accepted; the port never logs to wandb")
    p.add_argument("--zero1", action="store_true", help=f"not ported ({MULTI_GPU})")
    p.add_argument("--mu_bf16", action="store_true",
                   help="store the AdamW first moment in bfloat16")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward pass")
    p.add_argument("--multihost", action="store_true", help=f"not ported ({MULTI_GPU})")
    p.add_argument("--coordinator", type=str, default=None, help="multi-host only")
    p.add_argument("--num_processes", type=int, default=None, help="multi-host only")
    p.add_argument("--process_id", type=int, default=None, help="multi-host only")
    return add_preset_flag(p)


def parse_args(parser: argparse.ArgumentParser, argv):
    """Parse and refuse what is not ported (parser errors)."""
    args = parser.parse_args(argv)
    refuse_unported(parser, args, {"multihost": MULTI_GPU, "zero1": MULTI_GPU})
    if list(args.mesh_shape) not in ([-1], [1]):
        parser.error(f"--mesh_shape {args.mesh_shape} is not ported to thermal3d_torch yet "
                     f"(one device only: [-1] or [1]; {MULTI_GPU})")
    return args


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, LossConfig, TrainConfig
    from thermal3d_torch.core.device import resolve_device
    from thermal3d_torch.data.freiburg import FreiburgPairDataset
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.logging import MetricLogger
    from thermal3d_torch.train.loop import train_and_evaluate

    args = parse_args(build_parser(), argv)
    model_cfg = apply_preset(DUSTR_224_LINEAR, args.model_preset, args.img_size,
                             args.compute_dtype)
    if args.remat:
        model_cfg = dataclasses.replace(model_cfg, remat=True)
    cfg = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay, epochs=args.epochs,
        batch_size=args.batch_size, accumulation_steps=args.accumulation_steps,
        use_enhanced_loss=args.use_thermal_aware_loss, seed=args.seed,
        log_interval=args.log_interval, max_batches=args.max_batches,
        loss=LossConfig(edge_weight=args.edge_weight,
                        smoothness_weight=args.smoothness_weight,
                        detail_weight=args.detail_weight, multi_scale=args.multi_scale),
        mesh_shape=tuple(args.mesh_shape),
        mu_dtype="bfloat16" if args.mu_bf16 else None)

    dataset = FreiburgPairDataset(args.dataset_dir, img_size=tuple(args.img_size),
                                  pseudo_gt_dir=args.pseudo_gt_dir, frame_skip=args.frame_skip)
    print(f"Created {len(dataset)} validated thermal pairs")
    if args.debug_loading is not None:
        dataset.debug_loading(args.debug_loading)
        return None

    state, _ = load_pth(args.weights, model_cfg)
    print(f"Loaded {len(state)} tensors from {args.weights}")
    model = trainable_model(model_cfg, resolve_device(args.device), state)
    logger = MetricLogger(
        run_name=f"DUSt3R_thermal_ft_ep{args.epochs}_bs{args.batch_size}_lr{args.lr}",
        config=vars(args), use_wandb=not args.no_wandb)
    summary = train_and_evaluate(model, dataset, cfg, checkpoint_dir=args.output_model,
                                 logger=logger, resume=args.resume)
    print(f"Training done: {summary}")
    logger.finish()
    return summary


if __name__ == "__main__":
    main()
