"""Thermal depth inference — `python -m thermal3d_torch.cli.infer`
(counterpart of thermal3d/cli/infer.py, thermal_dustr_inference.py:297-376).

A directory of thermal PNGs (or one frame) → `{base}_depth.npy` and, unless
--no_vis, the `{base}_depth_vis.png` panel (the model's view of the frame,
depth, confidence) per frame, through InferenceEngine.infer_paths (depth
only with --no_vis); --img_path2 runs one stereo pair; --fire_scene /
--advanced_fire preprocess each frame on the card and serve it alone;
--refine_depth refines every depth map before it is saved; --int8 serves
with the trunk GEMMs in int8 (kernels/quant.py; --int8_scope,
--int8_group_size, --int8_equalize, and --int8_static_acts, which calibrates
static activation scales on the first decodable batch); --ndev N serves the
directory batches over N devices (cli/common.py::make_dp_mesh: a model
replica on each, every batch split over them; the stereo and fire-scene
modes stay on one device, a parser error as in the JAX CLI). The flags are
the JAX CLI's, with its parser errors; --scan_layers is accepted and the
model runs unrolled (cli/common.py::apply_scan).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os

import numpy as np
import torch

from thermal3d_torch.cli.common import (add_preset_flag, apply_preset, apply_scan,
                                        make_dp_mesh)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m thermal3d_torch.cli.infer",
                                description="Thermal DUSt3R depth inference (PyTorch/CUDA)")
    p.add_argument("--weights", type=str, default=None,
                   help=".pth checkpoint (dust3r or ThermalDUSt3R layout); random "
                        "init if omitted")
    p.add_argument("--img_path", type=str, required=True,
                   help="thermal PNG or directory of .png frames")
    p.add_argument("--img_path2", type=str, default=None, help="second view (stereo)")
    p.add_argument("--img_size", type=int, nargs=2, default=None,
                   help="defaults to the model variant's native resolution")
    p.add_argument("--output_dir", type=str, default="inference_results")
    p.add_argument("--batch_size", type=int, default=36,
                   help="frames a batch; the final partial batch is padded")
    p.add_argument("--no_thermal_model", action="store_true",
                   help="skip the ThermalDUSt3R preprocessing head")
    p.add_argument("--fire_scene", action="store_true",
                   help="fire-scene preprocessing (experiment pipeline)")
    p.add_argument("--advanced_fire", action="store_true",
                   help="histogram-peak fire-scene preprocessing (over --fire_scene)")
    p.add_argument("--refine_depth", action="store_true",
                   help="outlier-median + guided + bilateral refinement")
    p.add_argument("--no_vis", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--int8_scope", type=str, default="all", choices=["all", "mlp", "fc1"],
                   help="which trunk GEMMs --int8 quantizes: all, mlp (fc1+fc2) or fc1")
    p.add_argument("--int8_group_size", type=int, default=None,
                   help="int8 weight scales per this many input channels (e.g. 128)")
    p.add_argument("--int8", action="store_true",
                   help="serve with the trunk GEMMs in int8 (opt-in; gate with cli.parity)")
    p.add_argument("--int8_equalize", action="store_true",
                   help="SmoothQuant-style LN-to-GEMM equalization before quantizing")
    p.add_argument("--int8_static_acts", action="store_true",
                   help="static per-GEMM activation scales from one float forward over "
                        "the first decodable batch")
    p.add_argument("--model_variant", type=str, default="dustr224_linear",
                   choices=["dustr224_linear", "dustr512_dpt", "mastr512_catmlpdpt"],
                   help="model family member (checkpoint architecture)")
    p.add_argument("--dpt_f32", action="store_true",
                   help="pin the DPT/catmlpdpt head in float32 (no effect on the linear "
                        "head, which is always float32)")
    return add_preset_flag(p)


def main(argv=None):
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import (DUSTR_224_LINEAR, DUSTR_512_DPT,
                                             MASTR_512_CATMLPDPT)
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY
    from thermal3d_torch.preprocess.io import load_thermal_image, load_thermal_images_batch

    parser = build_parser()
    args = parser.parse_args(argv)
    if (args.int8_equalize or args.int8_static_acts) and not args.int8:
        parser.error("--int8_equalize/--int8_static_acts require --int8")
    if args.int8_static_acts and args.int8_group_size:
        parser.error("--int8_static_acts is incompatible with --int8_group_size")
    if args.ndev > 1 and (args.img_path2 or args.fire_scene or args.advanced_fire):
        # stereo and the fire-scene modes serve one frame a batch
        parser.error("--ndev > 1 supports only the directory-batch monocular path "
                     "(stereo/--fire_scene/--advanced_fire run batch-1 programs)")
    mesh = make_dp_mesh(args.ndev, args.batch_size, parser.error, args.device)
    base = {"dustr224_linear": DUSTR_224_LINEAR, "dustr512_dpt": DUSTR_512_DPT,
            "mastr512_catmlpdpt": MASTR_512_CATMLPDPT}[args.model_variant]
    if args.img_size is None:
        args.img_size = list(base.img_size)  # the variant's native resolution
    config = apply_preset(base, args.model_preset, args.img_size, args.compute_dtype)
    config = apply_scan(config, args.scan_layers)
    if args.dpt_f32:
        config = dataclasses.replace(
            config, head=dataclasses.replace(config.head, dpt_dtype="float32"))
    state, head_state = (None, None) if args.weights is None else load_pth(args.weights,
                                                                          config)
    if os.path.isdir(args.img_path):
        paths = sorted(glob.glob(os.path.join(args.img_path, "*.png")))
    else:
        paths = [args.img_path]
    int8_calibration = None
    if args.int8_static_acts:
        # the first batch, decoded here once more than infer_paths decodes it
        grays, _ = load_thermal_images_batch(paths[:args.batch_size], normalize=True,
                                             out_hw=tuple(args.img_size))
        if not grays:
            parser.error("--int8_static_acts: no decodable frames to calibrate on")
        int8_calibration = np.stack(grays)
    engine = InferenceEngine(config, state_dict=state, thermal_head_state=head_state,
                             use_thermal_head=not args.no_thermal_model, device=args.device,
                             quantize_int8=args.int8, int8_group_size=args.int8_group_size,
                             int8_only=SCOPE_TO_ONLY[args.int8_scope],
                             int8_equalize=args.int8_equalize,
                             int8_calibration=int8_calibration, mesh=mesh)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.img_path2:  # stereo pair mode
        grays = [load_thermal_image(p, normalize=True) for p in (args.img_path, args.img_path2)]
        if any(g is None for g in grays):
            parser.error("--img_path/--img_path2: a frame is missing or does not decode")
        out = engine.infer(grays[0][None], grays[1][None])
        _save_one(args, out, 0, args.img_path, engine)
        return

    if args.fire_scene or args.advanced_fire:
        from thermal3d_torch.preprocess.fire_scene import (advanced_fire_scene_processing,
                                                           preprocess_fire_scene_thermal)
        from thermal3d_torch.preprocess.resize import resize_bilinear_hw

        fn = advanced_fire_scene_processing if args.advanced_fire else \
            preprocess_fire_scene_thermal
        for path in paths:  # one frame at a time, as the reference serves them
            gray = load_thermal_image(path, normalize=True)
            if gray is None:
                continue
            with torch.inference_mode():
                resized = resize_bilinear_hw(torch.from_numpy(gray).to(engine.device),
                                             tuple(args.img_size))
                proc = fn(resized)
            out = engine.infer(proc[None], preprocessed=True)
            _save_one(args, out, 0, path, engine)
        return

    # the confidence is fetched only for the figure
    outputs = ("depth",) if args.no_vis else ("depth", "confidence1")
    out = engine.infer_paths(paths, batch_size=args.batch_size, outputs=outputs)
    # zip against the SURVIVING paths: failed decodes are dropped
    survivors = out.get("paths", [])
    for i, path in enumerate(survivors):
        _save_one(args, out, i, path, engine)
    print(f"Processed {len(survivors)}/{len(paths)} frames -> {args.output_dir}")


def _save_one(args, out, i: int, path: str, engine) -> None:
    """Write frame i's depth (refined with --refine_depth, against the frame
    decoded again and resized to the depth's size) and, unless --no_vis,
    its panel."""
    base = os.path.splitext(os.path.basename(path))[0]
    depth = out["depth"][i]
    if args.refine_depth:
        from thermal3d_torch.preprocess.io import load_thermal_image
        from thermal3d_torch.preprocess.refine import refine_depth
        from thermal3d_torch.preprocess.resize import resize_bilinear_hw

        gray = torch.from_numpy(load_thermal_image(path, normalize=True)).to(engine.device)
        with torch.inference_mode():
            gray = resize_bilinear_hw(gray, depth.shape)
            depth = refine_depth(torch.from_numpy(depth).to(engine.device), gray).cpu().numpy()
    np.save(os.path.join(args.output_dir, f"{base}_depth.npy"), depth)
    if not args.no_vis:
        from thermal3d_torch.viz.panels import visualize_depth_result

        visualize_depth_result(
            _thermal_vis(path, depth, engine.device), depth, out["confidence1"][i],
            save_path=os.path.join(args.output_dir, f"{base}_depth_vis.png"))


def _thermal_vis(path: str, depth: np.ndarray, device) -> np.ndarray:
    """The panel's input tile: the frame as the model sees it, at the
    depth's size (zeros if it does not decode)."""
    from thermal3d_torch.preprocess.io import preprocess_thermal_for_model

    img = preprocess_thermal_for_model(path, depth.shape, device=device)
    return img if img is not None else np.zeros((*depth.shape, 3), np.float32)


if __name__ == "__main__":
    main()
