"""Shared CLI helpers (counterpart of thermal3d/cli/common.py): model presets,
the device flag, and parser errors for the options the port does not run
yet, each naming its ROADMAP item."""

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
                        help="not ported (ROADMAP Queue 1 item 12): a parser error")
    parser.add_argument("--ndev", type=int, default=1,
                        help="data-parallel devices; only 1 is ported (ROADMAP "
                             "Queue 1 item 11)")
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (the default) or 'cpu' for the plain PyTorch path")
    return parser


def refuse_unported(parser, args, flags) -> None:
    """parser.error for each set flag of `flags` ({dest: ROADMAP item}),
    --scan_layers and --ndev > 1."""
    flags = dict(flags, scan_layers="ROADMAP Queue 1 item 12 (scan layouts)")
    for dest, item in flags.items():
        if getattr(args, dest):
            parser.error(f"--{dest} is not ported to thermal3d_torch yet ({item})")
    if args.ndev > 1:
        parser.error("--ndev > 1 is not ported to thermal3d_torch yet "
                     "(ROADMAP Queue 1 item 11, multi-GPU)")
