"""Matmul bilinear resize (counterpart of thermal3d/preprocess/resize.py):
`resize_bilinear_hw` on [..., H, W] and `resize_bilinear_hwc` on [..., H, W, C].

Bilinear resampling is linear and separable, so resizing each spatial axis is
a product with a fixed [n_in, n_out] matrix. The half-pixel matrix is derived
here in numpy from the convention jax.image.resize(method='bilinear',
antialias=False) uses (a triangle kernel at sample positions
(i + 0.5)·n_in/n_out − 0.5, weights renormalised where the kernel leaves the
image, zero outside [−0.5, n_in − 0.5]); the tests hold it against the JAX
matrix. align_corners=True samples linspace(0, n_in − 1, n_out).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def axis_matrix(n_in: int, n_out: int, align_corners: bool = False) -> Optional[np.ndarray]:
    """Read-only float32 [n_in, n_out] resampling matrix; None when n_in == n_out."""
    if n_in == n_out:
        return None
    if align_corners:
        pos = np.linspace(0.0, n_in - 1.0, n_out)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (pos - lo).astype(np.float32)
        m = np.zeros((n_in, n_out), np.float32)
        cols = np.arange(n_out)
        m[lo, cols] += 1.0 - frac
        m[hi, cols] += frac
    else:
        # float32 throughout, rounding where jax.image.resize rounds: the
        # inverse scale is taken in double, then rounded to float32
        f32 = np.float32
        inv_scale = f32(1.0 / (n_out / n_in))
        sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
        w = np.maximum(f32(0.0), f32(1.0) - np.abs(sample[None, :]
                                                  - np.arange(n_in, dtype=f32)[:, None]))
        total = w.sum(axis=0, keepdims=True, dtype=f32)
        w = np.where(total > f32(1000.0 * np.finfo(f32).eps),
                     w / np.where(total != 0, total, f32(1.0)), f32(0.0))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        m = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=None)
def _device_matrix(n_in: int, n_out: int, align_corners: bool, device: str):
    m = axis_matrix(n_in, n_out, align_corners)
    return None if m is None else torch.tensor(m, device=device)


def resize_bilinear_hw(x: torch.Tensor, out_hw: Tuple[int, int],
                       align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two axes in float32: [..., H, W] → [..., H', W']."""
    h, w = x.shape[-2:]
    mh = _device_matrix(h, out_hw[0], align_corners, str(x.device))
    mw = _device_matrix(w, out_hw[1], align_corners, str(x.device))
    y = x.to(torch.float32)
    if mh is not None:
        y = torch.einsum("...yx,yh->...hx", y, mh)
    if mw is not None:
        y = torch.matmul(y, mw)
    return y.to(x.dtype)


def resize_bilinear_hwc(x: torch.Tensor, out_hw: Tuple[int, int],
                        align_corners: bool = False) -> torch.Tensor:
    """Resize the two axes before a trailing channel axis in float32:
    [..., H, W, C] → [..., H', W', C], cast back to x's dtype (the DPT
    head's upsamples use align_corners=True)."""
    h, w = x.shape[-3:-1]
    mh = _device_matrix(h, out_hw[0], align_corners, str(x.device))
    mw = _device_matrix(w, out_hw[1], align_corners, str(x.device))
    y = x.to(torch.float32)
    if mh is not None:
        y = torch.einsum("...yxc,yh->...hxc", y, mh)
    if mw is not None:
        y = torch.einsum("...hxc,xw->...hwc", y, mw)
    return y.to(x.dtype)
