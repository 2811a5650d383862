"""Umeyama/Kabsch rigid alignment and relative pose (counterpart of
thermal3d/geometry/umeyama.py), batched over [B] on the device.

The weighted closed form: weighted means, the 3×3 covariance, and its
Kabsch rotation with the signed singular values (kernels/umeyama3x3.py: a
hand-written CUDA kernel on the card, its plain PyTorch sweeps on the CPU;
U and V come out as rotations, so the sign fix is in the third singular
value). Nothing is read back to the host, so a pseudo-GT step is dispatched
without waiting for the device. Invalid points are zeroed before they enter
the products (0·NaN would be NaN). Fewer than 10 valid points, or a
covariance of rank < 2 by the float32 eps test, give the identity pose.
"""

from __future__ import annotations

import numpy as np
import torch

from thermal3d_torch.core.profiling import annotate
from thermal3d_torch.kernels.umeyama3x3 import kabsch3x3


class GeometryException(Exception):
    """Geometry-related errors (degenerate covariance, shape mismatch)."""


def umeyama_core(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, with_scale: bool):
    """Weighted Umeyama. x, y: [B, 3, N]; w: [B, N] nonnegative weights.
    Returns (r [B,3,3], t [B,3], c [B], rank_ok [B] bool)."""
    wn = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    mean_x = torch.einsum("bdn,bn->bd", x, wn)
    mean_y = torch.einsum("bdn,bn->bd", y, wn)
    xc = x - mean_x[..., None]
    yc = y - mean_y[..., None]
    sigma_x = torch.einsum("bdn,bn->b", xc * xc, wn)
    cov = torch.einsum("bdn,ben->bde", yc * wn[:, None, :], xc)
    r, ds, rank_ok = kabsch3x3(cov.contiguous())
    if with_scale:
        c = (1.0 / torch.clamp(sigma_x, min=1e-12)) * ds.sum(dim=-1)
    else:
        c = torch.ones_like(sigma_x)
    t = mean_y - c[:, None] * torch.einsum("bde,be->bd", r, mean_x)
    return r, t, c, rank_ok


def umeyama_alignment(x, y, with_scale: bool = False):
    """Host API (scripts/pseudo_gt.py's umeyama_alignment): x, y [3, N] →
    (r [3,3], t [3], c), in float32; raises GeometryException on a shape
    mismatch or a degenerate covariance rank."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.shape != y.shape:
        raise GeometryException("Data matrices must have the same shape")
    xt = torch.from_numpy(x.astype(np.float32))[None]
    yt = torch.from_numpy(y.astype(np.float32))[None]
    r, t, c, rank_ok = umeyama_core(xt, yt, torch.ones(xt.shape[::2]), with_scale)
    if not bool(rank_ok[0]):
        raise GeometryException("Degenerate covariance rank, Umeyama alignment is not possible")
    return r[0].numpy(), t[0].numpy(), float(c[0])


def extract_relative_pose(pointmap1: torch.Tensor, pointmap2: torch.Tensor) -> torch.Tensor:
    """Relative pose between [B, H, W, 3] pointmaps → [B, 4, 4] transforms
    taking view-1 points to view-2 points. Valid: both Z > 0 and every
    coordinate finite."""
    b = pointmap1.shape[0]
    with annotate("geometry.pose", pointmap1.device):
        mask = (pointmap1[..., 2] > 0) & (pointmap2[..., 2] > 0)
        mask &= torch.isfinite(pointmap1).all(-1) & torch.isfinite(pointmap2).all(-1)
        p1 = torch.where(mask[..., None], pointmap1, torch.zeros_like(pointmap1))
        p2 = torch.where(mask[..., None], pointmap2, torch.zeros_like(pointmap2))
        w = mask.reshape(b, -1).to(torch.float32)
        x = p1.reshape(b, -1, 3).transpose(1, 2)  # source
        y = p2.reshape(b, -1, 3).transpose(1, 2)  # target
        r, t, _, rank_ok = umeyama_core(x, y, w, with_scale=False)
        ok = rank_ok & (w.sum(dim=-1) >= 10)
        eye = torch.eye(4, dtype=torch.float32, device=pointmap1.device).expand(b, 4, 4)
        transform = eye.clone()
        transform[:, :3, :3] = r
        transform[:, :3, 3] = t
        return torch.where(ok[:, None, None], transform, eye)
