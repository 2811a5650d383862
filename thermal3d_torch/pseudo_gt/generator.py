"""Pseudo-GT generation with a frozen MASt3R-512 over RGB pairs (counterpart
of thermal3d/pseudo_gt/generator.py).

One step: both views through the shared encoder in one batch, the dual
decoder, the catmlpdpt heads (pts3d/conf only: the generator returns no
descriptors, so the local-feature MLP is not run), then on the device the
intrinsics (median focal fit) and the Umeyama relative pose of each pair.

    gen = PseudoGTGenerator(MASTR_512_CATMLPDPT, params_dtype="bfloat16")
    out = gen.run_pairs(rgb1, rgb2)   # [B,512,512,3] in [0,1] → numpy dict

generate_pseudo_gt runs it over RGB pairs on disk: the port's PNG decoder
(resize to the model size), pipelined batches, the eight-directory npy
writer, and with visualize=True the 2×2 panels of the first 10 pairs.

With `mesh=` (a single-controller core.mesh.Mesh) each batch is split over
the mesh's 'data' positions, a model replica a distinct device, as the
serving engine does (core/mesh.py::run_on_mesh).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import MASTR_512_CATMLPDPT, DustrModelConfig
from thermal3d_torch.core.device import resolve_device, to_device
from thermal3d_torch.core.mesh import mesh_positions, replicate, run_on_mesh
from thermal3d_torch.core.profiling import NEW_REQUEST, annotate
from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage, pipelined_batches
from thermal3d_torch.geometry.calibration import load_thermal_calibration
from thermal3d_torch.geometry.intrinsics import estimate_camera_intrinsics
from thermal3d_torch.geometry.umeyama import extract_relative_pose
from thermal3d_torch.kernels.quant import quantize_for_serving
from thermal3d_torch.models.dustr import calibrate_act_absmax, frozen_model
from thermal3d_torch.native import load_rgb_batch
from thermal3d_torch.preprocess.io import require_png
from thermal3d_torch.viz.panels import visualize_data

OUTPUT_DIRS = ("pointmap1", "pointmap2", "confidence1", "confidence2",
               "depth1", "depth2", "intrinsics", "poses")


class PseudoGTGenerator:
    """Holds the frozen model on one device and turns RGB pair batches into
    the eight pseudo-GT arrays of OUTPUT_DIRS.

    state_dict: torch/dust3r-layout weights (e.g. convert.from_jax); None
    makes seeded random weights (`seed`). params_dtype: 'bfloat16' stores
    the weights in bf16; None keeps float32. calib_file: a thermal
    calibration whose K is kept as `calib_k` (None when the file is missing
    or unreadable, as in the JAX generator); run_pairs still returns the
    estimated intrinsics. device: None means CUDA (raises without it).

    split_programs is accepted for call compatibility with the JAX
    generator: there it compiles the encoder and the rest as two XLA
    programs with the same numerics; eager PyTorch runs them as separate
    launches anyway, so it changes nothing. quantize_int8 / int8_*: int8
    trunk GEMMs as in the serving engine (kernels/quant.py), the calibration
    sample an (rgb1, rgb2) pair batch. mesh: data-parallel generation
    (module docstring); the generator's device is then the mesh's first, and
    a batch must divide into its 'data' size (ValueError).
    """

    def __init__(self, config: DustrModelConfig = MASTR_512_CATMLPDPT,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 batch_size: int = 4, calib_file: Optional[str] = None, seed: int = 0,
                 params_dtype: Optional[str] = None, device=None,
                 split_programs: bool = False, quantize_int8: bool = False,
                 int8_group_size: Optional[int] = None, int8_skip: tuple = (),
                 int8_only: tuple = (), int8_equalize: bool = False,
                 int8_calibration=None, int8_impl: str = "int_mm", mesh=None):
        self.mesh = mesh
        self._positions = mesh_positions(mesh)
        self.device = self._positions[0] if mesh is not None else resolve_device(device)
        self.config = config
        self.batch_size = batch_size
        self.split_programs = split_programs
        self.model = frozen_model(config, self.device, state_dict, seed, params_dtype)
        if quantize_int8:
            quantize_for_serving(
                self.model, None if int8_calibration is None
                else lambda model: calibrate_act_absmax(
                    model, *(to_device(r, self.device) for r in int8_calibration)),
                group_size=int8_group_size, skip=int8_skip, only=int8_only,
                equalize=int8_equalize, impl=int8_impl)
        self._replicas = replicate(self.device, self._positions, (self.model,))

        self.calib_k = None
        if calib_file and os.path.exists(calib_file):
            try:
                self.calib_k, _, _ = load_thermal_calibration(calib_file)
            except (OSError, ValueError, KeyError, TypeError):
                self.calib_k = None  # fall back to estimation, as the reference does

    @staticmethod
    def _geometry(pred1: Dict[str, torch.Tensor], pred2: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        pm1 = pred1["pts3d"].to(torch.float32)
        pm2 = pred2["pts3d_in_other_view"].to(torch.float32)
        d1 = pm1[..., 2]
        d2 = pm2[..., 2]
        out = {"pointmap1": pm1, "pointmap2": pm2,
               "confidence1": pred1["conf"].to(torch.float32),
               "confidence2": pred2["conf"].to(torch.float32),
               "depth1": d1, "depth2": d2}
        with annotate("pgt.geometry", pm1.device):
            out["intrinsics"] = estimate_camera_intrinsics(pm1, d1)
            out["poses"] = extract_relative_pose(pm1, pm2)
        return out

    def run_pairs_async(self, rgb1, rgb2) -> Dict[str, torch.Tensor]:
        """rgb*: [B, H, W, 3] in [0, 1] (numpy, or float32 tensors on the
        generator's device) → the eight pseudo-GT tensors on the device (the
        mesh's first), without waiting for them."""
        if tuple(rgb1.shape) != tuple(rgb2.shape) or rgb1.shape[0] == 0:
            raise ValueError(f"run_pairs: want two equal non-empty [B,H,W,3] batches, "
                             f"got {tuple(rgb1.shape)} and {tuple(rgb2.shape)}")
        with annotate("pgt.request", self.device, request=NEW_REQUEST):
            if self.mesh is None:
                return self._step(self.model, self.device, rgb1, rgb2)
            return run_on_mesh(self._positions, rgb1.shape[0], lambda device, rows: self._step(
                self._replicas[device][0], device, rgb1[rows], rgb2[rows]))

    def _step(self, model, device, rgb1, rgb2) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x1, x2 = to_device(rgb1, device), to_device(rgb2, device)
            pred1, pred2 = model(x1, x2, with_desc=False)
            return self._geometry(pred1, pred2)

    def run_pairs(self, rgb1: np.ndarray, rgb2: np.ndarray) -> Dict[str, np.ndarray]:
        out = self.run_pairs_async(rgb1, rgb2)
        return {k: v.cpu().numpy() for k, v in out.items()}



def decode_rgb_pairs(chunk: List[Dict[str, str]], hw, keys=("rgb_path1", "rgb_path2")):
    """Decode and resize the two RGB frames of each pair of `chunk` →
    (rgb1 [n,H,W,3], rgb2 [n,H,W,3], the n pairs whose frames both decoded)."""
    paths = [pr[k] for pr in chunk for k in keys]
    require_png(*paths)
    rgb, ok = load_rgb_batch(paths, tuple(hw))
    rgb, ok = rgb.reshape(len(chunk), len(keys), *rgb.shape[1:]), ok.reshape(len(chunk), -1)
    keep = ok.all(axis=1)
    return rgb[keep, 0], rgb[keep, -1], [pr for pr, k in zip(chunk, keep) if k]


def pad_batch(x: np.ndarray, size: int) -> np.ndarray:
    """Repeat the last row until x has `size` rows (one static batch shape)."""
    if len(x) >= size:
        return x
    return np.concatenate([x, np.repeat(x[-1:], size - len(x), axis=0)])


def generate_pseudo_gt(pairs: List[Dict[str, str]], output_dir: str,
                       generator: Optional[PseudoGTGenerator] = None,
                       batch_size: int = 4, visualize: bool = False,
                       calib_file: Optional[str] = None,
                       max_pairs: Optional[int] = None) -> int:
    """pairs: entries of data.freiburg.build_rgb_pair_index. Writes, per
    pair, output_dir/{pointmap1,pointmap2,confidence1,confidence2,
    intrinsics,poses}/{b1}_{b2}.npy and depth1/{b1}.npy, depth2/{b2}.npy (b1,
    b2 the two RGB base names); intrinsics are the calibration's K when the
    generator has one. Pipelined as InferenceEngine.infer_paths; short
    batches are padded to the generator's batch. visualize=True also writes
    visualizations/{b1}_{b2}.png (viz.panels.visualize_data: the RGB pair
    over the depth pair) for the first 10 pairs written. Returns the number
    of pairs written."""
    if generator is None:
        generator = PseudoGTGenerator(batch_size=batch_size, calib_file=calib_file)
    for d in OUTPUT_DIRS:
        os.makedirs(os.path.join(output_dir, d), exist_ok=True)
    vis_dir = os.path.join(output_dir, "visualizations")
    if visualize:
        os.makedirs(vis_dir, exist_ok=True)
    if max_pairs is not None:
        pairs = pairs[:max_pairs]
    bs = generator.batch_size
    hw = generator.config.img_size
    stage, fetch = PinnedStage(generator.device), PinnedFetch(generator.device)
    n_written = 0

    def dispatch(decoded):
        rgb1, rgb2, kept = decoded
        if not kept:
            return None
        x = stage.put({"rgb1": pad_batch(rgb1, bs), "rgb2": pad_batch(rgb2, bs)})
        out = generator.run_pairs_async(x["rgb1"], x["rgb2"])
        return fetch.start(out), kept, rgb1, rgb2

    def write(token):
        nonlocal n_written
        started, kept, rgb1, rgb2 = token
        out = fetch.finish(started, len(kept))
        if generator.calib_k is not None:
            out["intrinsics"] = np.tile(generator.calib_k[None], (len(kept), 1, 1)
                                        ).astype(np.float32)
        for j, pr in enumerate(kept):
            b1 = os.path.splitext(os.path.basename(pr["rgb_path1"]))[0]
            b2 = os.path.splitext(os.path.basename(pr["rgb_path2"]))[0]
            names = dict.fromkeys(OUTPUT_DIRS, f"{b1}_{b2}")
            names.update(depth1=b1, depth2=b2)
            for d in OUTPUT_DIRS:
                np.save(os.path.join(output_dir, d, f"{names[d]}.npy"), out[d][j])
            if visualize and n_written < 10:
                visualize_data(rgb1[j], rgb2[j], out["depth1"][j], out["depth2"][j],
                               save_path=os.path.join(vis_dir, f"{b1}_{b2}.png"))
            n_written += 1

    chunks = [pairs[i:i + bs] for i in range(0, len(pairs), bs)]
    pipelined_batches(chunks, lambda c: decode_rgb_pairs(c, hw), dispatch, write)
    return n_written
