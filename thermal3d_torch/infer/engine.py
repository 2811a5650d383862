"""Batched inference engine (counterpart of thermal3d/infer/engine.py).

The serving path: raw frames [B, h, w] → bilinear resize to the model size →
p2/p98 percentile enhance (kernel K1) → learnable thermal head → DUSt3R
(encoder once in monocular mode, dual decoder, linear heads; attention
through kernels K2/K3) → pointmaps, confidences and depth = pts3d[..., 2].
Everything runs on one device under torch.inference_mode(); the device is
CUDA unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import DUSTR_224_LINEAR, DustrModelConfig
from thermal3d_torch.core.device import resolve_device
from thermal3d_torch.models.dustr import frozen_model
from thermal3d_torch.models.thermal_wrap import ThermalPreprocessHead
from thermal3d_torch.preprocess.enhance import ENHANCE_IMPLS, enhance_thermal_contrast
from thermal3d_torch.preprocess.resize import resize_bilinear_hw


class InferenceEngine:
    """Holds the model on one device and serves batches.

    state_dict: torch/dust3r-layout weights (e.g. convert.from_jax); None
    makes seeded random weights (`seed`). thermal_head_state: {'edge_weight',
    'temp_scale'}; None keeps the init values 0.5 / 1.0. params_dtype:
    'bfloat16' stores every model weight in bf16 (the linear head up-casts the
    rounded weights to f32); None keeps float32. enhance_impl: passed to
    enhance_thermal_contrast ('auto' = K1 on CUDA, sort on CPU).
    """

    def __init__(self, config: DustrModelConfig = DUSTR_224_LINEAR,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 thermal_head_state: Optional[Mapping[str, torch.Tensor]] = None,
                 use_thermal_head: bool = True, params_dtype: Optional[str] = None,
                 device=None, seed: int = 0, enhance_impl: str = "auto",
                 quantize_int8: bool = False, mesh=None):
        if quantize_int8:
            raise NotImplementedError("int8 serving is not ported")
        if mesh is not None:
            raise NotImplementedError("mesh (data-parallel) serving is not ported")
        if enhance_impl not in ENHANCE_IMPLS:
            raise ValueError(f"enhance_impl {enhance_impl!r} not in {ENHANCE_IMPLS}")
        self.device = resolve_device(device)
        self.config = config
        self.enhance_impl = enhance_impl
        self.use_thermal_head = use_thermal_head

        self.model = frozen_model(config, self.device, state_dict, seed, params_dtype)

        self.thermal_head = ThermalPreprocessHead().to(self.device)
        if thermal_head_state is not None:
            self.thermal_head.load_state_dict(thermal_head_state, strict=True)
        self.thermal_head.eval().requires_grad_(False)

    def _input(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32)).to(self.device)

    def preprocess(self, grays: torch.Tensor) -> torch.Tensor:
        """[B, h, w] decoded grayscale (any scale) → enhanced [B, H, W, 3]."""
        resized = resize_bilinear_hw(grays, self.config.img_size)
        return enhance_thermal_contrast(resized, impl=self.enhance_impl)

    def infer(self, img1: np.ndarray, img2: Optional[np.ndarray] = None,
              preprocessed: bool = False) -> Dict[str, np.ndarray]:
        """img*: [B, h, w] raw grayscale or [B, H, W, 3] preprocessed → numpy
        pointmap1/2 [B,H,W,3], confidence1/2 [B,H,W], depth [B,H,W]."""
        out = self.infer_async(img1, img2, preprocessed)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def infer_async(self, img1: np.ndarray, img2: Optional[np.ndarray] = None,
                    preprocessed: bool = False) -> Dict[str, torch.Tensor]:
        """Like infer() but returns device tensors without waiting for them."""
        with torch.inference_mode():
            x1 = self._input(img1)
            x2 = None if img2 is None else self._input(img2)
            if x1.shape[0] == 0:
                raise ValueError("infer: empty batch")
            if not preprocessed:
                x1 = self.preprocess(x1)
                x2 = None if x2 is None else self.preprocess(x2)
            if self.use_thermal_head:
                x1 = self.thermal_head(x1)
                x2 = None if x2 is None else self.thermal_head(x2)
            pred1, pred2 = self.model(x1, x2)
            return {
                "pointmap1": pred1["pts3d"],
                "pointmap2": pred2["pts3d_in_other_view"],
                "confidence1": pred1["conf"],
                "confidence2": pred2["conf"],
                "depth": pred1["pts3d"][..., 2],
            }
