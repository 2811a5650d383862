"""Export a self-contained serving artifact — `python -m thermal3d_torch.cli.export`
(counterpart of thermal3d/cli/export.py).

Packages the serving computation (resize → percentile enhance → thermal head
→ model → the five outputs) as torch.export programs, one a batch size, with
the weights stored once, in one .npz (infer/export.py):

    python -m thermal3d_torch.cli.export --weights ckpt.pth --out serving.npz \\
        --batch_sizes 64 1 --platforms native
    # on the serving host:
    from thermal3d_torch.infer.export import ServingArtifact
    art = ServingArtifact.load("serving.npz")
    depth = art.infer(raw_frames)["depth"]

The flags are the JAX CLI's, plus --device (the card unless 'cpu').
"""

from __future__ import annotations

import argparse
import os

from thermal3d_torch.cli.common import add_preset_flag, apply_preset, apply_scan, refuse_ndev


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a serving artifact (torch.export "
                                            "programs + weights)")
    p.add_argument("--weights", type=str, default=None,
                   help=".pth checkpoint (dust3r or ThermalDUSt3R layout) or a "
                        "thermal3d_torch checkpoint directory; random init if omitted")
    p.add_argument("--out", type=str, required=True, help="output .npz path")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[64],
                   help="one exported program per batch size (64 = the H100 serving "
                        "batch of the port's bench sweep; add 1 for latency-sensitive "
                        "endpoints)")
    p.add_argument("--input_hw", type=int, nargs=2, default=None,
                   help="raw frame resolution fed to the program (resized to the "
                        "model's img_size inside); defaults to the model img_size")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated platforms of the portable program (sort "
                        "percentile enhance, plain attention: no op of the port), or "
                        "'native' for the engine's exact program on --device, with the "
                        "kernels K1-K3 as ops (loads only on that device type)")
    p.add_argument("--stereo", action="store_true",
                   help="export the two-view program instead of monocular")
    p.add_argument("--img_size", type=int, nargs=2, default=None)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--params_dtype", type=str, default=None,
                   help="store the weights in this dtype in the artifact (e.g. "
                        "'bfloat16': halves the artifact)")
    p.add_argument("--no_thermal_model", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="quantize the trunk GEMMs to int8 before exporting (gate with "
                        "cli.parity)")
    p.add_argument("--int8_scope", type=str, default="all", choices=["all", "mlp", "fc1"])
    p.add_argument("--model_variant", type=str, default="dustr224_linear",
                   choices=["dustr224_linear", "dustr512_dpt", "mastr512_catmlpdpt"])
    return add_preset_flag(p)


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import (DUSTR_224_LINEAR, DUSTR_512_DPT,
                                             MASTR_512_CATMLPDPT)
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.infer.export import save_serving_artifact
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY

    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_ndev(parser, args, "an artifact holds one device's program")
    base = {"dustr224_linear": DUSTR_224_LINEAR, "dustr512_dpt": DUSTR_512_DPT,
            "mastr512_catmlpdpt": MASTR_512_CATMLPDPT}[args.model_variant]
    if args.img_size is None:
        args.img_size = list(base.img_size)
    config = apply_preset(base, args.model_preset, args.img_size, args.compute_dtype)
    config = apply_scan(config, args.scan_layers)
    state, head_state = (None, None) if args.weights is None else load_pth(args.weights,
                                                                          config)
    engine = InferenceEngine(config, state_dict=state, thermal_head_state=head_state,
                             use_thermal_head=not args.no_thermal_model,
                             params_dtype=args.params_dtype, device=args.device,
                             quantize_int8=args.int8,
                             int8_only=SCOPE_TO_ONLY[args.int8_scope])
    platforms = (None if args.platforms == "native"
                 else tuple(s for s in args.platforms.split(",") if s))
    meta = save_serving_artifact(
        args.out, engine, batch_sizes=args.batch_sizes,
        input_hw=tuple(args.input_hw) if args.input_hw else None,
        platforms=platforms, stereo=args.stereo)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"Exported {args.out} ({size_mb:.1f} MB): batch sizes {meta['batch_sizes']}, "
          f"platforms {meta['platforms']}, input {meta['input_hw']}, "
          f"{meta['num_weights']} weight arrays" + (", int8" if meta["int8"] else ""))
    return meta


if __name__ == "__main__":
    main()
