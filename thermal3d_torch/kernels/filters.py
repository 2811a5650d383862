"""Image filters: CLAHE, Sobel, Canny, bilateral and guided filters, and the
outlier-median depth cleaning (counterpart of thermal3d/kernels/filters.py).

The reference writes these as jnp stencils that XLA fuses; none is a Pallas
kernel, so here they are plain PyTorch on the caller's device, one image a
call, with the reference's borders and arithmetic step for step: `reflect`
(reflect-101) padding for Sobel, the bilateral filter and the box filter,
zero padding for Canny's non-maximum suppression and the outlier window,
edge padding for the CLAHE tiles; round half to even; Canny's fixed 32
max-pool steps of hysteresis; NaN-ignoring mean and standard deviation.
Every division by a constant divides by a device tensor: torch's CUDA
division by a Python scalar multiplies by the reciprocal, which rounds
differently from the reference's IEEE division.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c in IEEE arithmetic on every device (see the module docstring)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _pad2d(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """Pad the two leading axes of [H, W] or [H, W, C] by r on each side;
    'reflect' is numpy's reflect (the edge is not repeated)."""
    if x.dim() == 2:
        return F.pad(x[None, None], (r, r, r, r), mode=mode)[0, 0]
    return F.pad(x.permute(2, 0, 1)[None], (r, r, r, r), mode=mode)[0].permute(1, 2, 0)


# ---------------------------------------------------------------------------
# CLAHE (cv2.createCLAHE on the 8-bit quantisation)
# ---------------------------------------------------------------------------

def clahe(gray01: torch.Tensor, clip_limit: float = 3.0, grid: Tuple[int, int] = (8, 8)
          ) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of a [H, W] image in
    [0, 1]: per-tile 256-bin histograms of round(x·255), clipped with the
    excess spread evenly, CDF lookup tables, bilinear interpolation between
    the four nearest tile centres. Tiles are ceil(H/gh) × ceil(W/gw), the
    image edge-padded to fill them. Returns float32 in [0, 1]."""
    h, w = gray01.shape
    gh, gw = grid
    th, tw = -(-h // gh), -(-w // gw)
    dev = gray01.device
    img8 = torch.clamp(torch.round(gray01 * 255.0), 0, 255).to(torch.int64)
    padded = F.pad(img8.to(torch.float32)[None, None], (0, gw * tw - w, 0, gh * th - h),
                   mode="replicate")[0, 0].to(torch.int64)
    tiles = padded.reshape(gh, th, gw, tw).permute(0, 2, 1, 3).reshape(gh * gw, th * tw)
    hist = torch.zeros((gh * gw, 256), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles, dtype=torch.float32))

    tile_area = float(th * tw)
    clip = max(1.0, clip_limit * tile_area / 256.0)
    excess = torch.clamp(hist - clip, min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / 256.0  # a power of two: exact
    lut = torch.round(torch.cumsum(hist, dim=-1) * (255.0 / tile_area)).reshape(gh, gw, 256)

    ty = _div(torch.arange(h, dtype=torch.float32, device=dev), float(th)) - 0.5
    tx = _div(torch.arange(w, dtype=torch.float32, device=dev), float(tw)) - 0.5
    ty0 = torch.clamp(torch.floor(ty), 0, gh - 1).to(torch.int64)
    tx0 = torch.clamp(torch.floor(tx), 0, gw - 1).to(torch.int64)
    ty1 = torch.clamp(ty0 + 1, 0, gh - 1)
    tx1 = torch.clamp(tx0 + 1, 0, gw - 1)
    wy = torch.clamp(ty - ty0, 0.0, 1.0)[:, None]
    wx = torch.clamp(tx - tx0, 0.0, 1.0)[None, :]

    def gather(tyi, txi):
        return lut[tyi[:, None], txi[None, :], img8]

    v00, v01 = gather(ty0, tx0), gather(ty0, tx1)
    v10, v11 = gather(ty1, tx0), gather(ty1, tx1)
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return _div(out, 255.0)


# ---------------------------------------------------------------------------
# Sobel and Canny (cv2.Sobel ksize 3, cv2.Canny with the L1 gradient norm)
# ---------------------------------------------------------------------------

def sobel_xy(gray: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3×3 Sobel gx, gy of [H, W] with reflect-101 borders."""
    h, w = gray.shape
    p = _pad2d(gray, 1, "reflect")

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    gy = (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)) - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    return gx, gy


def sobel_magnitude_normalized(gray: torch.Tensor) -> torch.Tensor:
    """sqrt(gx² + gy²) min-max rescaled to [0, 1]."""
    gx, gy = sobel_xy(gray)
    mag = torch.sqrt(gx * gx + gy * gy)
    return (mag - mag.min()) / (mag.max() - mag.min() + 1e-6)


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m with the sign of m (jnp.remainder: fmod, then + m where the
    signs differ)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def canny_edges(gray01: torch.Tensor, low: float = 50.0, high: float = 150.0,
                hysteresis_iters: int = 32) -> torch.Tensor:
    """Canny edge map of a [H, W] image in [0, 1], thresholds in 8-bit
    units: L1 gradient norm, non-maximum suppression in four direction
    sectors, then `hysteresis_iters` 3×3 max-pool growth steps of the strong
    edges into weak pixels. Returns {0, 1} float32."""
    gx, gy = sobel_xy(gray01 * 255.0)
    mag = torch.abs(gx) + torch.abs(gy)
    deg = _remainder(torch.rad2deg(torch.atan2(gy, gx)), 180.0)
    sector = torch.where((deg < 22.5) | (deg >= 157.5), 0,
                         torch.where(deg < 67.5, 1, torch.where(deg < 112.5, 2, 3)))
    h, w = mag.shape
    p = _pad2d(mag, 1, "constant")

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    neigh = ((sh(0, 1), sh(0, -1)), (sh(1, 1), sh(-1, -1)),
             (sh(1, 0), sh(-1, 0)), (sh(1, -1), sh(-1, 1)))
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for s, (n1, n2) in enumerate(neigh):
        keep = torch.where(sector == s, (mag >= n1) & (mag >= n2), keep)
    nms = torch.where(keep, mag, 0.0)
    strong = nms >= high
    weak = nms >= low
    edges = strong
    for _ in range(hysteresis_iters):
        grown = F.max_pool2d(edges.to(torch.float32)[None, None], 3, stride=1, padding=1)[0, 0] > 0
        edges = (grown & weak) | strong
    return edges.to(torch.float32)


# ---------------------------------------------------------------------------
# Bilateral filter (cv2.bilateralFilter, float path)
# ---------------------------------------------------------------------------

def bilateral_filter(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """Edge-preserving smoothing of [H, W] or [H, W, C]: a circular window of
    radius d//2, a spatial Gaussian and a range Gaussian on the L1 colour
    distance across channels, reflect-101 borders; sigmas in the input's
    units. Taps accumulate in the reference's order."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    r = d // 2
    p = _pad2d(img, r, "reflect")
    inv_2sc2 = -0.5 / (sigma_color * sigma_color)
    inv_2ss2 = -0.5 / (sigma_space * sigma_space)
    num = torch.zeros_like(img)
    den = torch.zeros((h, w, 1), dtype=img.dtype, device=img.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            dist2 = dy * dy + dx * dx
            if dist2 > r * r:
                continue  # circular window
            shifted = p[r + dy:r + dy + h, r + dx:r + dx + w, :]
            cdist = torch.abs(shifted - img).sum(dim=-1, keepdim=True)
            wgt = torch.exp(cdist * cdist * inv_2sc2 + dist2 * inv_2ss2)
            num = num + wgt * shifted
            den = den + wgt
    out = num / den
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Guided filter (He et al.; cv2.ximgproc.guidedFilter(radius, eps))
# ---------------------------------------------------------------------------

def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over (2r+1)² windows of [H, W] by an integral image of the
    reflect-padded input. The reference sums in the input's float32, where
    the integral image cancels catastrophically and the result depends on
    the order of the sums (XLA's, torch's CPU and CUDA scans differ by up to
    3× the float32 error itself); here a float32 input is summed in float64
    and the mean rounded back once, so every device gives the same bits and
    the result stays within the reference's own float32 error of it."""
    k = 2 * r + 1
    h, w = x.shape
    acc = torch.float64 if x.dtype == torch.float32 else x.dtype
    ii = torch.cumsum(torch.cumsum(_pad2d(x, r, "reflect").to(acc), dim=0), dim=1)
    ii = F.pad(ii, (1, 0, 1, 0))
    s = (ii[k:k + h, k:k + w] - ii[0:h, k:k + w]
         - ii[k:k + h, 0:w] + ii[0:h, 0:w])
    return _div(s, float(k * k)).to(x.dtype)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, radius: int = 8,
                  eps: float = 1e-4) -> torch.Tensor:
    """Gray-guide guided filter of [H, W] `src` by [H, W] `guide`."""
    mean_i = _box_filter(guide, radius)
    mean_p = _box_filter(src, radius)
    corr_ip = _box_filter(guide * src, radius)
    corr_ii = _box_filter(guide * guide, radius)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return _box_filter(a, radius) * guide + _box_filter(b, radius)


# ---------------------------------------------------------------------------
# Outlier removal with a local masked median
# ---------------------------------------------------------------------------

def nanmean(x: torch.Tensor) -> torch.Tensor:
    """Mean of the non-NaN elements (jnp.nanmean: their sum over their count)."""
    valid = ~torch.isnan(x)
    return torch.where(valid, x, 0.0).sum() / valid.sum().to(x.dtype)


def nanstd(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation of the non-NaN elements (jnp.nanstd,
    ddof 0); NaN when every element is NaN. torch has no nanstd."""
    valid = ~torch.isnan(x)
    count = valid.sum()
    centered = torch.where(valid, x - nanmean(x), 0.0)
    var = (centered * centered).sum()
    var = torch.where(count > 0, var, torch.nan) / torch.clamp(count, min=1).to(x.dtype)
    return torch.sqrt(var)


def remove_depth_outliers(depth: torch.Tensor, kernel_size: int = 5,
                          n_sigma: float = 3.0) -> torch.Tensor:
    """Replace each pixel more than n_sigma standard deviations from the
    mean by the median of its non-outlier neighbours in a kernel_size²
    window clipped at the borders (an even count takes the mean of the two
    middle values, as np.median); the global mean where none is valid."""
    h, w = depth.shape
    mean = nanmean(depth)
    std = nanstd(depth)
    outlier = torch.abs(depth - mean) > n_sigma * std
    r = kernel_size // 2
    pd = _pad2d(depth, r, "constant")
    pv = F.pad(~outlier, (r, r, r, r), value=False)
    vals, valid = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            vals.append(pd[r + dy:r + dy + h, r + dx:r + dx + w])
            valid.append(pv[r + dy:r + dy + h, r + dx:r + dx + w])
    vals = torch.stack(vals, dim=-1)
    valid = torch.stack(valid, dim=-1)
    srt = torch.sort(torch.where(valid, vals, torch.inf), dim=-1).values
    n = valid.sum(dim=-1)
    k2 = vals.shape[-1]
    idx_hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, k2 - 1)
    idx_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, k2 - 1)
    med = 0.5 * (torch.gather(srt, -1, idx_lo[..., None])[..., 0]
                 + torch.gather(srt, -1, idx_hi[..., None])[..., 0])
    med = torch.where(n > 0, med, mean)
    return torch.where(outlier, med, depth)
