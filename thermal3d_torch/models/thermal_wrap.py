"""Learnable thermal preprocessing head and the ThermalDUSt3R wrapper
(counterpart of thermal3d/models/thermal_wrap.py).

ThermalPreprocessHead: per-image min/max normalisation over (H, W), the
depthwise |Sobel| magnitude (zero padding, computed as separable 3-tap
stencils), then `clip((x + edge_weight·mag) · temp_scale, 0, 1)` with
learnable scalars edge_weight (init 0.5) and temp_scale (init 1.0). Always
float32.

ThermalDUSt3R: the head (`thermal_preprocess`) in front of the model
(`model`), both views through the head. Its state dict is the reference
wrapper's `.pth` layout: `edge_weight` and `temp_scale` at the top,
`model.`-prefixed model keys; the reference's fixed `sobel_x` / `sobel_y`
buffers are accepted and dropped on load, so a wrapper checkpoint loads with
strict=True.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from thermal3d_torch.core.config import DustrModelConfig
from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo

HEAD_KEYS = ("edge_weight", "temp_scale")


def sobel_edge_magnitude(x: torch.Tensor) -> torch.Tensor:
    """Depthwise |Sobel| magnitude. x: [B, H, W, C] → same shape; equals a
    zero-padded conv2d(groups=C) with the fixed Sobel kernels."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # pad W and H by one
    vs = xp[:, :-2] + 2.0 * xp[:, 1:-1] + xp[:, 2:]  # rows smoothed
    vd = xp[:, 2:] - xp[:, :-2]  # rows differenced
    ex = vs[:, :, 2:] - vs[:, :, :-2]
    ey = vd[:, :, :-2] + 2.0 * vd[:, :, 1:-1] + vd[:, :, 2:]
    return torch.sqrt(ex * ex + ey * ey)


class ThermalPreprocessHead(nn.Module):
    def __init__(self, edge_weight: float = 0.5, temp_scale: float = 1.0):
        super().__init__()
        self.edge_weight = nn.Parameter(torch.tensor(edge_weight, dtype=torch.float32))
        self.temp_scale = nn.Parameter(torch.tensor(temp_scale, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C] (C = 1 or 3) in [0, 1] → [B, H, W, 3]."""
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        mn = x.amin(dim=(1, 2), keepdim=True)
        mx = x.amax(dim=(1, 2), keepdim=True)
        x = (x - mn) / (mx - mn + 1e-6)
        mag = sobel_edge_magnitude(x)
        return torch.clamp((x + self.edge_weight * mag) * self.temp_scale, 0.0, 1.0)


class ThermalDUSt3R(nn.Module):
    """ThermalPreprocessHead + AsymmetricCroCo3DStereo; forward(img1, img2)
    on NHWC [B, H, W, C] images in [0, 1] → the model's (pred1, pred2)."""

    def __init__(self, config: DustrModelConfig, edge_weight: float = 0.5,
                 temp_scale: float = 1.0):
        super().__init__()
        self.thermal_preprocess = ThermalPreprocessHead(edge_weight, temp_scale)
        self.model = AsymmetricCroCo3DStereo(config)
        self.register_state_dict_post_hook(_to_wrapper_layout)
        self.register_load_state_dict_pre_hook(_from_wrapper_layout)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        return self.model(self.thermal_preprocess(img1), self.thermal_preprocess(img2))


def _to_wrapper_layout(module, state_dict, prefix, local_metadata) -> None:
    for k in HEAD_KEYS:
        state_dict[prefix + k] = state_dict.pop(f"{prefix}thermal_preprocess.{k}")


def _from_wrapper_layout(module, state_dict, prefix, local_metadata, strict, missing_keys,
                         unexpected_keys, error_msgs) -> None:
    for k in HEAD_KEYS:
        if prefix + k in state_dict:
            state_dict[f"{prefix}thermal_preprocess.{k}"] = state_dict.pop(prefix + k).reshape(())
    for k in ("sobel_x", "sobel_y"):
        state_dict.pop(prefix + k, None)
