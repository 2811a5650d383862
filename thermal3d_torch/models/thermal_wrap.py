"""Learnable thermal preprocessing head (counterpart of
thermal3d/models/thermal_wrap.py, ThermalPreprocessHead).

Per-image min/max normalisation over (H, W), the depthwise |Sobel| magnitude
(zero padding, computed as separable 3-tap stencils), then
`clip((x + edge_weight·mag) · temp_scale, 0, 1)` with learnable scalars
edge_weight (init 0.5) and temp_scale (init 1.0). Always float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
