"""Camera intrinsics from pointmaps (counterpart of
thermal3d/geometry/intrinsics.py), batched on the device.

fx = median over valid pixels (Z > 0) of (u − W/2)/(X/Z), fy likewise with
v and Y; the principal point at the image centre.
"""

from __future__ import annotations

import torch

from thermal3d_torch.core.profiling import annotate


def nanmedian_midpoint(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, ignoring NaN; with an even count the mean
    of the two middle values, (lo + hi) * 0.5, as jnp.nanmedian computes it
    (torch.nanmedian returns the lower one). NaN where nothing is valid."""
    n = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    s = torch.sort(x, dim=-1).values  # NaN sorts last
    lo = torch.gather(s, -1, ((n - 1).clamp(min=0)) // 2)
    hi = torch.gather(s, -1, (n // 2).clamp(max=x.shape[-1] - 1))
    med = (lo + hi) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan"))).squeeze(-1)


def estimate_camera_intrinsics(pointmap: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """pointmap [B, H, W, 3], depth [B, H, W] (float32) → K [B, 3, 3]."""
    b, h, w = depth.shape
    dev = depth.device
    with annotate("geometry.intrinsics", dev):
        v = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
        u = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
        mask = depth > 0
        zs = torch.where(mask, depth, torch.ones_like(depth))
        x_norm = pointmap[..., 0] / zs
        y_norm = pointmap[..., 1] / zs
        nan = torch.full_like(depth, float("nan"))
        fx = nanmedian_midpoint(torch.where(mask, (u - w / 2) / x_norm, nan).reshape(b, -1))
        fy = nanmedian_midpoint(torch.where(mask, (v - h / 2) / y_norm, nan).reshape(b, -1))
        k = torch.zeros((b, 3, 3), dtype=torch.float32, device=dev)
        k[:, 0, 0] = fx
        k[:, 1, 1] = fy
        k[:, 0, 2] = w / 2
        k[:, 1, 2] = h / 2
        k[:, 2, 2] = 1.0
        return k
