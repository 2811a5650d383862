"""Pseudo-GT generation with a frozen MASt3R-512 over RGB pairs (counterpart
of thermal3d/pseudo_gt/generator.py).

One step: both views through the shared encoder in one batch, the dual
decoder, the catmlpdpt heads (pts3d/conf only: the generator returns no
descriptors, so the local-feature MLP is not run), then on the device the
intrinsics (median focal fit) and the Umeyama relative pose of each pair.

    gen = PseudoGTGenerator(MASTR_512_CATMLPDPT, params_dtype="bfloat16")
    out = gen.run_pairs(rgb1, rgb2)   # [B,512,512,3] in [0,1] → numpy dict

The file-driven generate_pseudo_gt (image decode, pipelined batches, the npy
writer) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import MASTR_512_CATMLPDPT, DustrModelConfig
from thermal3d_torch.core.device import resolve_device
from thermal3d_torch.geometry.calibration import load_thermal_calibration
from thermal3d_torch.geometry.intrinsics import estimate_camera_intrinsics
from thermal3d_torch.geometry.umeyama import extract_relative_pose
from thermal3d_torch.models.dustr import frozen_model

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
    launches anyway, so it changes nothing. quantize_int8 / int8_* and mesh
    are not ported and raise NotImplementedError.
    """

    def __init__(self, config: DustrModelConfig = MASTR_512_CATMLPDPT,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 batch_size: int = 4, calib_file: Optional[str] = None, seed: int = 0,
                 params_dtype: Optional[str] = None, device=None,
                 split_programs: bool = False, quantize_int8: bool = False,
                 int8_group_size: Optional[int] = None, int8_skip: tuple = (),
                 int8_only: tuple = (), int8_equalize: bool = False,
                 int8_calibration=None, mesh=None):
        if (quantize_int8 or int8_group_size is not None or int8_skip or int8_only
                or int8_equalize or int8_calibration is not None):
            raise NotImplementedError("int8 pseudo-GT generation is not ported")
        if mesh is not None:
            raise NotImplementedError("mesh (data-parallel) generation is not ported")
        self.device = resolve_device(device)
        self.config = config
        self.batch_size = batch_size
        self.split_programs = split_programs
        self.model = frozen_model(config, self.device, state_dict, seed, params_dtype)

        self.calib_k = None
        if calib_file and os.path.exists(calib_file):
            try:
                self.calib_k, _, _ = load_thermal_calibration(calib_file)
            except (OSError, ValueError, KeyError, TypeError):
                self.calib_k = None  # fall back to estimation, as the reference does

    def _input(self, rgb: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rgb, np.float32)).to(self.device)

    @staticmethod
    def _geometry(pred1: Dict[str, torch.Tensor], pred2: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        pm1 = pred1["pts3d"].to(torch.float32)
        pm2 = pred2["pts3d_in_other_view"].to(torch.float32)
        d1 = pm1[..., 2]
        d2 = pm2[..., 2]
        return {"pointmap1": pm1, "pointmap2": pm2,
                "confidence1": pred1["conf"].to(torch.float32),
                "confidence2": pred2["conf"].to(torch.float32),
                "depth1": d1, "depth2": d2,
                "intrinsics": estimate_camera_intrinsics(pm1, d1),
                "poses": extract_relative_pose(pm1, pm2)}

    def run_pairs_async(self, rgb1: np.ndarray, rgb2: np.ndarray) -> Dict[str, torch.Tensor]:
        """rgb*: [B, H, W, 3] in [0, 1] → the eight pseudo-GT tensors on the
        device, without waiting for them."""
        with torch.inference_mode():
            x1, x2 = self._input(rgb1), self._input(rgb2)
            if x1.shape[0] == 0 or x1.shape != x2.shape:
                raise ValueError(f"run_pairs: want two equal non-empty [B,H,W,3] batches, "
                                 f"got {tuple(x1.shape)} and {tuple(x2.shape)}")
            pred1, pred2 = self.model(x1, x2, with_desc=False)
            return self._geometry(pred1, pred2)

    def run_pairs(self, rgb1: np.ndarray, rgb2: np.ndarray) -> Dict[str, np.ndarray]:
        out = self.run_pairs_async(rgb1, rgb2)
        return {k: v.cpu().numpy() for k, v in out.items()}

