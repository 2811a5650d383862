"""Fine-tune DUSt3R on thermal pairs — `python -m thermal3d_torch.cli.train`
(counterpart of thermal3d/cli/train.py, train_thermal_dustr.py:25-58).

The JAX CLI's flags plus --device. --weights takes a
.pth or a checkpoint directory of this CLI; --output_model is such a
directory (best/ and last/, train/checkpoint.py). --no_wandb is accepted
(the port logs to stdout only).

Several devices: one process a device (core/distributed.py), launched by
torchrun, which the CLI detects and joins itself,

    torchrun --nproc_per_node 4 -m thermal3d_torch.cli.train ... --mesh_shape 4

or by --multihost, one launch a process with --coordinator host:port,
--num_processes (the job's GPUs, not its hosts) and --process_id (or the
THERMAL3D_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID variables).
--mesh_shape D lays the processes out as D data-parallel ranks, --mesh_shape
D T as D × T with Megatron tensor parallelism over T ('data', 'model'),
--zero1 shards the AdamW moments over 'data'. A mesh that needs more
processes than the job has is a parser error naming torchrun. NCCL joins
the processes on the card, gloo on the CPU (--device cpu). --ndev > 1 is a
parser error (a serving flag: training takes --mesh_shape); --scan_layers is
accepted and the model runs unrolled (cli/common.py::apply_scan).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from thermal3d_torch.cli.common import (add_preset_flag, apply_preset, apply_scan, refuse_ndev)

MESH_AXES = ("data", "model")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermal3d_torch.cli.train",
                                description="Fine-tune DUSt3R on thermal images with "
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
                   help="the processes as a mesh: D (data parallel) or D T (T-way "
                        "tensor parallel); -1 takes the rest of the job's processes")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no_wandb", action="store_true",
                   help="accepted; the port never logs to wandb")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the AdamW moments over the data axis (per-rank "
                        "optimizer memory / data-parallel size; numerics unchanged)")
    p.add_argument("--mu_bf16", action="store_true",
                   help="store the AdamW first moment in bfloat16")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward pass")
    p.add_argument("--multihost", action="store_true",
                   help="join a job of one process a GPU (torch.distributed); the "
                        "coordinator and rank come from --coordinator / --num_processes / "
                        "--process_id or the THERMAL3D_COORDINATOR / _NUM_PROCESSES / "
                        "_PROCESS_ID variables")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 (multi-process only)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="processes in the job, one a GPU (multi-process only)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (multi-process only)")
    return add_preset_flag(p)


def under_torchrun() -> bool:
    """True in a process that torchrun started (its rendezvous variables)."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def parse_args(parser: argparse.ArgumentParser, argv):
    """Parse and refuse what does not apply (parser errors)."""
    args = parser.parse_args(argv)
    refuse_ndev(parser, args, "training runs one process per device; give --mesh_shape "
                              "under torchrun (or --multihost)")
    if not 1 <= len(args.mesh_shape) <= len(MESH_AXES):
        parser.error(f"--mesh_shape takes 1 or 2 sizes (data, model), got {args.mesh_shape}")
    return args


def join_processes(parser: argparse.ArgumentParser, args):
    """Join the job's process group (torchrun, or --multihost) unless one is
    up. Returns (rank, world size, this process's device, whether this call
    initialised the group)."""
    import torch.distributed as dist

    from thermal3d_torch.core.device import resolve_device
    from thermal3d_torch.core.distributed import (initialize_multihost, process_device,
                                                  process_info)

    joined = False
    if (args.multihost or under_torchrun()) and not dist.is_initialized():
        try:
            initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                 device=args.device)
        except ValueError as e:
            parser.error(str(e))
        joined = True
    rank, world = process_info()
    device = process_device() if dist.is_initialized() else resolve_device(args.device)
    return rank, world, device, joined


def main(argv=None):
    import torch.distributed as dist

    parser = build_parser()
    args = parse_args(parser, argv)
    rank, world, device, joined = join_processes(parser, args)
    try:
        return _train(parser, args, rank, world, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(parser: argparse.ArgumentParser, args, rank: int, world: int, device):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, LossConfig, TrainConfig
    from thermal3d_torch.data.freiburg import FreiburgPairDataset
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.logging import MetricLogger
    from thermal3d_torch.train.loop import train_and_evaluate, training_mesh

    import torch.distributed as dist

    say = print if rank == 0 else (lambda *a, **k: None)
    if dist.is_initialized():
        say(f"[thermal3d_torch] process group: {dist.get_backend()}, world {world}, "
            f"mesh_shape {args.mesh_shape}{', zero1' if args.zero1 else ''}")
    model_cfg = apply_preset(DUSTR_224_LINEAR, args.model_preset, args.img_size,
                             args.compute_dtype)
    model_cfg = apply_scan(model_cfg, args.scan_layers)
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
        mesh_shape=tuple(args.mesh_shape), mesh_axes=MESH_AXES[:len(args.mesh_shape)],
        zero1=args.zero1, mu_dtype="bfloat16" if args.mu_bf16 else None)
    try:  # a mesh the job's processes cannot fill is a parser error
        mesh = training_mesh(cfg, device)
    except ValueError as e:
        parser.error(str(e))

    dataset = FreiburgPairDataset(args.dataset_dir, img_size=tuple(args.img_size),
                                  pseudo_gt_dir=args.pseudo_gt_dir, frame_skip=args.frame_skip)
    say(f"Created {len(dataset)} validated thermal pairs")
    if args.debug_loading is not None:
        if rank == 0:
            dataset.debug_loading(args.debug_loading)
        return None

    state, _ = load_pth(args.weights, model_cfg)
    say(f"Loaded {len(state)} tensors from {args.weights}")
    model = trainable_model(model_cfg, device, state)
    logger = MetricLogger(
        run_name=f"DUSt3R_thermal_ft_ep{args.epochs}_bs{args.batch_size}_lr{args.lr}",
        config=vars(args), use_wandb=not args.no_wandb)
    summary = train_and_evaluate(model, dataset, cfg, checkpoint_dir=args.output_model,
                                 logger=logger, resume=args.resume, mesh=mesh)
    say(f"Training done: {summary}")
    logger.finish()
    return summary


if __name__ == "__main__":
    main()
