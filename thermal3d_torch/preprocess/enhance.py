"""Thermal contrast enhancement (counterpart of thermal3d/preprocess/enhance.py).

grayscale → clip to the per-image (p2, p98) percentiles → rescale to [0, 1]
→ repeat to 3 channels. Two percentile paths, as in JAX:
  * 'sort': the exact linear-interpolation quantile (np.percentile's), with
    the zero-span guard that maps a flat frame to 0;
  * K1 (kernels/image_ops.py): one order statistic per percentile, found by a
    binary search on a 65535-step grid after a per-image min/max
    normalisation (the rescale is affine-invariant, so it changes nothing).
impl='auto' takes K1 for CUDA tensors and 'sort' elsewhere; 'plain' forces
K1's plain PyTorch version; 'sort' forces the sort path.
"""

from __future__ import annotations

import torch

from thermal3d_torch.core.config import FREIBURG_RAW_MAX, FREIBURG_RAW_MIN
from thermal3d_torch.kernels.image_ops import percentile_enhance, percentile_enhance_plain

LUMA = (0.299, 0.587, 0.114)
ENHANCE_IMPLS = ("auto", "plain", "sort")


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] → [..., H, W] luma grayscale (C = 1 or 3); other
    shapes pass through."""
    if img.dim() >= 3 and img.shape[-1] == 3:
        return torch.tensordot(img, torch.tensor(LUMA, dtype=img.dtype, device=img.device),
                               dims=([-1], [0]))
    if img.dim() >= 3 and img.shape[-1] == 1:
        return img[..., 0]
    return img


def _percentile_rescale_grid(gray: torch.Tensor, lo: float, hi: float,
                             plain: bool) -> torch.Tensor:
    batch_shape = gray.shape[:-2]
    h, w = gray.shape[-2:]
    x = gray.reshape(-1, h, w).to(torch.float32)
    g_min = x.amin(dim=(1, 2), keepdim=True)
    g_max = x.amax(dim=(1, 2), keepdim=True)
    span = g_max - g_min
    x = torch.where(span > 0, (x - g_min) / torch.where(span > 0, span, 1.0), 0.0)
    enhance = percentile_enhance_plain if plain else percentile_enhance
    out = enhance(x.contiguous(), lo, hi)
    return out.reshape(*batch_shape, h, w).to(gray.dtype)


def quantile_linear(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch.quantile(x, q, dim=-1, interpolation='linear') for a 1-D q, as
    ATen computes it (sort, ranks q·(n − 1), a row with a NaN at rank n − 1,
    lerp of the values at the floor and the ceiling of the rank), bit for
    bit, without torch.quantile's data-dependent check of q, which a trace
    (torch.export) cannot take. Returns [len(q), ...]."""
    values = x.sort(dim=-1).values
    n = values.shape[-1]
    ranks, has_nan = torch.broadcast_tensors(q * (n - 1), values.isnan().any(-1, keepdim=True))
    ranks = ranks.masked_fill(has_nan, n - 1)
    below = ranks.to(torch.long)
    above = ranks.ceil().to(torch.long)
    out = torch.lerp(values.gather(-1, below), values.gather(-1, above), ranks - below)
    return out.movedim(-1, 0)


def percentile_rescale(gray: torch.Tensor, lo: float = 2.0, hi: float = 98.0,
                       impl: str = "auto") -> torch.Tensor:
    """Clip each image [..., H, W] to its (lo, hi) percentiles, rescale to [0, 1]."""
    if impl not in ENHANCE_IMPLS:
        raise ValueError(f"enhance impl {impl!r} not in {ENHANCE_IMPLS}")
    if impl == "auto" and gray.device.type == "cuda":
        return _percentile_rescale_grid(gray, lo, hi, plain=False)
    if impl == "plain":
        return _percentile_rescale_grid(gray, lo, hi, plain=True)
    flat = gray.reshape(*gray.shape[:-2], -1)
    q = torch.tensor([lo / 100.0, hi / 100.0], dtype=flat.dtype, device=flat.device)
    p = quantile_linear(flat, q)
    p_lo = p[0][..., None, None]
    p_hi = p[1][..., None, None]
    span = p_hi - p_lo  # a flat frame maps to 0, not NaN
    scaled = torch.where(span > 0, (gray - p_lo) / torch.where(span > 0, span, 1.0), 0.0)
    return torch.clamp(scaled, 0.0, 1.0)


def enhance_thermal_contrast(img: torch.Tensor, lo: float = 2.0, hi: float = 98.0,
                             impl: str = "auto") -> torch.Tensor:
    """img: [H, W], [H, W, C] or [B, H, W, C] (or a [B, H, W] batch of gray
    frames) → 3-channel enhanced images of the same leading rank."""
    gray = rgb_to_gray(img) if img.dim() >= 3 else img
    enhanced = percentile_rescale(gray, lo, hi, impl=impl)
    return enhanced.unsqueeze(-1).expand(*enhanced.shape, 3)


def enhance_thermal_fixed_range(img: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """Freiburg fixed-range normalisation (utils/preprocessing.py:32-73):
    [0, 1] values of a uint16 frame (normalized=True, scaled by 65535) or raw
    counts are clipped to [21800, 25000] and rescaled to [0, 1]. A trailing
    channel axis (ndim >= 3) is reduced to luma and repeated back to its
    channel count."""
    had_channels = img.dim() >= 3
    gray = rgb_to_gray(img) if had_channels else img
    raw = gray * 65535.0 if normalized else gray
    raw = torch.clamp(raw, float(FREIBURG_RAW_MIN), float(FREIBURG_RAW_MAX))
    span = torch.full_like(raw, float(FREIBURG_RAW_MAX - FREIBURG_RAW_MIN))
    out = (raw - FREIBURG_RAW_MIN) / span  # a tensor divisor: IEEE division on CUDA too
    if had_channels:
        out = out.unsqueeze(-1).expand(*out.shape, img.shape[-1])
    return out
