"""The pseudo-GT path's geometry, in float64 (or a lower `dtype` for the
geometry stage's control).

Intrinsics: fx = the median over pixels with Z > 0 of (u - W/2) / (X/Z),
NaN values left out, fy likewise with v and Y (an even count takes the mean
of the two middle values), principal point at the image centre. Relative pose: the Kabsch /
Umeyama rotation and translation (no scale) taking view 1's points to view
2's, over the pixels where both Z > 0 and every coordinate is finite, with
the identity where fewer than 10 points are valid or the covariance has rank
below 2.
"""

from __future__ import annotations

import torch


def focal_values(pointmap: torch.Tensor, dtype=torch.float64):
    """One image's pointmap [H, W, 3] → the values whose medians are fx and
    fy: (u - W/2) / (X/Z) and (v - H/2) / (Y/Z) over the pixels with Z > 0,
    NaN (0/0 on the principal axes) left out, computed in `dtype`."""
    pm = pointmap.to(dtype)
    h, w, _ = pm.shape
    v = torch.arange(h, dtype=dtype, device=pm.device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=dtype, device=pm.device)[None, :].expand(h, w)
    z = pm[..., 2]
    ok = z > 0
    fx = ((u - w / 2) / (pm[..., 0] / z))[ok]
    fy = ((v - h / 2) / (pm[..., 1] / z))[ok]
    return fx[~torch.isnan(fx)], fy[~torch.isnan(fy)]


def _median(values: torch.Tensor) -> torch.Tensor:
    """The median (the mean of the two middle values of an even count); NaN
    of no values."""
    if values.numel() == 0:
        return torch.tensor(float("nan"), dtype=torch.float64, device=values.device)
    s = torch.sort(values).values
    n = s.numel()
    return ((s[(n - 1) // 2] + s[n // 2]) * 0.5).double()


def intrinsics(pointmap: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """pointmap [B, H, W, 3] → K [B, 3, 3] (float64), computed in `dtype`."""
    b, h, w, _ = pointmap.shape
    k = torch.zeros(b, 3, 3, dtype=torch.float64, device=pointmap.device)
    for i in range(b):
        fx, fy = focal_values(pointmap[i], dtype)
        k[i, 0, 0], k[i, 1, 1] = _median(fx), _median(fy)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = w / 2, h / 2, 1.0
    return k


def _valid_points(p1: torch.Tensor, p2: torch.Tensor):
    """One pair's [H, W, 3] pointmaps → the points [N, 3] of each where both
    Z > 0 and every coordinate is finite."""
    x, y = p1.reshape(-1, 3), p2.reshape(-1, 3)
    ok = (x[:, 2] > 0) & (y[:, 2] > 0) & torch.isfinite(x).all(1) & torch.isfinite(y).all(1)
    return x[ok], y[ok]


def _cross_covariance(x: torch.Tensor, y: torch.Tensor):
    mx, my = x.mean(0), y.mean(0)
    return mx, my, (y - my).t() @ (x - mx) / x.shape[0]


def relative_pose(pointmap1: torch.Tensor, pointmap2: torch.Tensor,
                  dtype=torch.float64) -> torch.Tensor:
    """[B, H, W, 3] pointmaps → [B, 4, 4] transforms (float64), computed in
    `dtype` (the SVD of the 3x3 covariance in at least float32)."""
    p1, p2 = pointmap1.to(dtype), pointmap2.to(dtype)
    out = torch.eye(4, dtype=torch.float64, device=p1.device).repeat(p1.shape[0], 1, 1)
    for i in range(p1.shape[0]):
        x, y = _valid_points(p1[i], p2[i])
        if x.shape[0] < 10:
            continue
        mx, my, cov = _cross_covariance(x, y)
        svd_dtype = torch.promote_types(dtype, torch.float32)
        u, d, vt = (m.double() for m in torch.linalg.svd(cov.to(svd_dtype)))
        if int((d > torch.finfo(torch.float32).eps).sum()) < 2:
            continue
        s = torch.ones(3, dtype=torch.float64, device=p1.device)
        if torch.linalg.det(u) * torch.linalg.det(vt) < 0:
            s[2] = -1.0
        r = u @ torch.diag(s) @ vt
        out[i, :3, :3] = r
        out[i, :3, 3] = (my - r.to(dtype) @ mx).double()
    return out


def pose_gap(poses: torch.Tensor, pointmap1: torch.Tensor,
             pointmap2: torch.Tensor) -> torch.Tensor:
    """Per pair: how far a pose [4, 4] is from the conditions of the Umeyama
    optimum on these points, in float64: R orthonormal with det +1, R^T C
    symmetric (C the cross-covariance; at the optimum R^T C = V S D V^T),
    and t = mean(y) - R mean(x). The asymmetry is taken over the product of
    the two clouds' root-mean-square spreads (the bound on |C| and the scale
    of its rounding: nearly uncorrelated clouds have a small C, whose float32
    rounding turns R), the translation over the points' root-mean-square
    norm. A rotation that rounding turns within the plane of two nearly
    equal singular values still meets them (it is as good a fit), one off
    the optimum does not. Where the reference finds no pose (fewer than 10
    points, rank below 2), the gap to the identity."""
    p1, p2 = pointmap1.double(), pointmap2.double()
    eye = torch.eye(4, dtype=torch.float64, device=p1.device)
    out = []
    for i in range(p1.shape[0]):
        pose = poses[i].double()
        x, y = _valid_points(p1[i], p2[i])
        if x.shape[0] < 10:
            out.append((pose - eye).abs().max())
            continue
        mx, my, cov = _cross_covariance(x, y)
        if int((torch.linalg.svdvals(cov) > torch.finfo(torch.float32).eps).sum()) < 2:
            out.append((pose - eye).abs().max())
            continue
        r, t = pose[:3, :3], pose[:3, 3]
        a = r.t() @ cov
        spread = ((x - mx).square().sum(1).mean() * (y - my).square().sum(1).mean()).sqrt()
        gaps = torch.stack([
            (a - a.t()).norm() / spread.clamp(min=1e-300),
            (r.t() @ r - eye[:3, :3]).norm(),
            (torch.linalg.det(r) - 1.0).abs(),
            (t - (my - r @ mx)).norm() / y.square().sum(1).mean().sqrt().clamp(min=1e-300)])
        out.append(gaps.max())
    return torch.stack(out)
