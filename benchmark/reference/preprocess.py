"""The serving path's preprocessing, as the program's contract states it.

raw frames [B, h, w] (any scale) → bilinear resize to the model size
(jax.image.resize's 'bilinear' without antialiasing: a triangle kernel at
half-pixel sample positions, renormalised at the edges) → per-image p2/p98
contrast stretch, where each percentile is the smallest value v on the
65535-step grid of the min/max-normalised image with count(q <= v) >= the
percentile's rank (the order statistic the engine's K1 selects, not an
interpolated quantile) → three channels → the learnable thermal head
(per-channel min/max normalisation, |Sobel| edges added with edge_weight,
times temp_scale, clipped to [0, 1]).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GRID = 65535.0


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """float32 [n_in, n_out]: out[j] = sum_i in[i] * m[i, j]."""
    f32 = np.float32
    inv_scale = f32(n_in / n_out)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(sample[None, :]
                                              - np.arange(n_in, dtype=f32)[:, None]))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(total > f32(1000.0 * np.finfo(f32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize(frames: torch.Tensor, out_hw) -> torch.Tensor:
    """[B, h, w] → [B, H, W] in float32."""
    h, w = frames.shape[-2:]
    x = frames.to(torch.float32)
    if h != out_hw[0]:
        x = torch.einsum("byx,yh->bhx", x, torch.from_numpy(resize_matrix(h, out_hw[0])).to(x))
    if w != out_hw[1]:
        x = x @ torch.from_numpy(resize_matrix(w, out_hw[1])).to(x)
    return x


def grid_percentile(q: torch.Tensor, frac: float) -> torch.Tensor:
    """q [B, N] grid indices → per image the smallest v with
    count(q <= v) >= frac/100 * N (the rank rounded to float32), / 65535."""
    n = q.shape[1]
    target = float(np.float32(frac / 100.0 * n))
    counts = torch.zeros(q.shape[0], int(GRID) + 1, dtype=torch.float64, device=q.device)
    counts.scatter_add_(1, q.to(torch.int64), torch.ones_like(q, dtype=torch.float64))
    below = torch.cumsum(counts, dim=1) >= target
    v = torch.argmax(below.to(torch.int8), dim=1).to(torch.float32)
    return v / GRID


def percentile_stretch(gray: torch.Tensor, lo: float = 2.0, hi: float = 98.0) -> torch.Tensor:
    """[B, H, W] → [B, H, W] in [0, 1]."""
    b, h, w = gray.shape
    x = gray.reshape(b, h * w).to(torch.float32)
    mn, mx = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
    span = mx - mn
    x = torch.where(span > 0, (x - mn) / torch.where(span > 0, span, 1.0), 0.0)
    q = torch.clamp(torch.floor(x * GRID), 0.0, GRID)
    p_lo, p_hi = grid_percentile(q, lo)[:, None], grid_percentile(q, hi)[:, None]
    out = torch.clamp((x - p_lo) / torch.clamp(p_hi - p_lo, min=1e-12), 0.0, 1.0)
    return out.reshape(b, h, w)


def thermal_head(x: torch.Tensor, edge_weight: float, temp_scale: float) -> torch.Tensor:
    """[B, H, W, C] in [0, 1] → [B, H, W, C]."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = x.amax(dim=(1, 2), keepdim=True)
    x = (x - mn) / (mx - mn + 1e-6)
    c = x.shape[-1]
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=x.device)
    kernels = torch.stack([kx, kx.t()])[:, None].repeat(c, 1, 1, 1)  # [2C, 1, 3, 3]
    g = F.conv2d(x.permute(0, 3, 1, 2), kernels, padding=1, groups=c)
    gx, gy = g[:, 0::2], g[:, 1::2]
    mag = torch.sqrt(gx * gx + gy * gy).permute(0, 2, 3, 1)
    return torch.clamp((x + edge_weight * mag) * temp_scale, 0.0, 1.0)


def serving_input(frames: torch.Tensor, img_size, edge_weight: float,
                  temp_scale: float) -> torch.Tensor:
    """Raw frames [B, h, w] → the model's input [B, H, W, 3]."""
    stretched = percentile_stretch(resize(frames, img_size))
    x = stretched[..., None].expand(*stretched.shape, 3)
    return thermal_head(x, edge_weight, temp_scale)
