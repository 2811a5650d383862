"""Shared CLI helpers (counterpart of thermal3d/cli/common.py): model presets,
--scan_layers (apply_scan), the device flag and the --ndev data-parallel mesh
(make_dp_mesh)."""

from __future__ import annotations

import dataclasses

from thermal3d_torch.core.config import DustrModelConfig


def apply_preset(base: DustrModelConfig, preset: str, img_size, compute_dtype: str
                 ) -> DustrModelConfig:
    """'tiny' shrinks the architecture for CPU smoke runs; 'full' keeps it."""
    if preset == "tiny":
        return dataclasses.replace(
            base,
            img_size=tuple(img_size),
            compute_dtype=compute_dtype,
            enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=2,
            head=dataclasses.replace(
                base.head, feature_dim=32, last_dim=16,
                dpt_layer_dims=(8, 16, 24, 32), local_feat_dim=6)
            if base.head.head_type != "linear" else base.head,
        )
    return dataclasses.replace(base, img_size=tuple(img_size), compute_dtype=compute_dtype)


def add_preset_flag(parser):
    parser.add_argument("--model_preset", type=str, default="full",
                        choices=["full", "tiny"],
                        help="'tiny' shrinks the model for smoke tests")
    parser.add_argument("--scan_layers", action="store_true",
                        help="the JAX model's scan layout, an XLA compile layout with "
                             "the unrolled model's outputs: recorded in the config, the "
                             "port runs its unrolled modules")
    parser.add_argument("--ndev", type=int, default=1,
                        help="data-parallel serving over N devices: a model replica on "
                             "each, batches split over a 1-D mesh; batch_size must be a "
                             "multiple of N (cli.infer, evaluate, pseudo_gt)")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (the default) or 'cpu' for the plain PyTorch path")
    return parser


def apply_scan(config: DustrModelConfig, scan_layers: bool) -> DustrModelConfig:
    """--scan_layers: the config with scan_layers set. The port's weights are
    in the torch layout whatever the flag (a JAX scan-layout tree is
    unstacked by convert.from_jax), and its model runs unrolled."""
    return dataclasses.replace(config, scan_layers=True) if scan_layers else config


def refuse_ndev(parser, args, why: str) -> None:
    """parser.error for --ndev > 1 on a CLI that serves on one device."""
    if args.ndev > 1:
        parser.error(f"--ndev > 1 does not apply here: {why}")


def available_devices(device=None) -> list:
    """The devices --ndev may take: this host's CUDA cards, or the CPU (one
    device) when `device` names it."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_dp_mesh(ndev: int, batch_size: int, error, device=None):
    """--ndev for the infer / evaluate / pseudo_gt CLIs: check the batch's
    divisibility and the device count, then the 1-D 'data' mesh over the
    first N devices of available_devices(device). None for ndev <= 1.
    `error` is the parser's .error (exits with usage)."""
    if ndev <= 1:
        return None
    if batch_size % ndev:
        error(f"--batch_size {batch_size} must be a multiple of --ndev {ndev}")
    from thermal3d_torch.core.mesh import make_mesh

    devs = available_devices(device)
    if len(devs) < ndev:
        error(f"--ndev={ndev} but only {len(devs)} devices available")
    return make_mesh((ndev,), ("data",), devices=devs[:ndev])
