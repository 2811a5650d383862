"""Training losses (counterpart of thermal3d/losses/losses.py):
confidence-weighted pointmap regression plus the thermal-aware edge,
smoothness and detail terms.

The reference's numerical quirks that move the optimum are kept:
  * v1's edge and smoothness terms are the same expression;
  * asymmetric gradient clamps 0.4 (view 1) and 0.5 (view 2);
  * the confidence clamp [1e-5, 10];
  * multi-scale weights 1.0 and 0.7/scale;
  * v2's zero-padded finite differences against v1's unpadded slices.

Every function takes a batch along any leading axes: pointmaps
[..., H, W, 3], confidences [..., H, W], thermal images [..., H, W] gray or
[..., H, W, 3] (luma-grayed), and returns per-sample losses [...] (and
per-sample components): the JAX functions' per-sample results, computed with
tensor ops over the leading axes instead of a vmap. `batched_enhanced_loss`
takes the batch mean of them, as the JAX one takes the mean over its vmap.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from thermal3d_torch.core.config import LossConfig
from thermal3d_torch.preprocess.enhance import rgb_to_gray

_MAP = (-2, -1)  # the two spatial axes of a [..., H, W] map


def confidence_weighted_regression_loss(
    pred_pts1: torch.Tensor, pred_pts2: torch.Tensor,
    gt_pts1: torch.Tensor, gt_pts2: torch.Tensor,
    confidences1: Optional[torch.Tensor] = None,
    confidences2: Optional[torch.Tensor] = None,
    alpha: float = 0.2,
) -> torch.Tensor:
    """DUSt3R objective: mean(conf·L1 − α·log conf) per view, summed."""
    loss1 = (pred_pts1 - gt_pts1).abs().mean(dim=-1)  # [..., H, W]
    loss2 = (pred_pts2 - gt_pts2).abs().mean(dim=-1)
    if confidences1 is None:
        confidences1 = torch.ones_like(loss1)
    if confidences2 is None:
        confidences2 = torch.ones_like(loss2)
    c1 = confidences1.clamp(1e-5, 10.0)
    c2 = confidences2.clamp(1e-5, 10.0)
    w1 = (c1 * loss1 - alpha * torch.log(c1)).mean(dim=_MAP)
    w2 = (c2 * loss2 - alpha * torch.log(c2)).mean(dim=_MAP)
    return w1 + w2


def _gray(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A thermal image of the pointmap's rank ([..., H, W, 3]) is luma-grayed;
    one rank lower it is gray already."""
    return rgb_to_gray(img) if img.dim() == pts.dim() else img


def thermal_aware_loss(
    pred_pts1, pred_pts2, gt_pts1, gt_pts2,
    confidences1=None, confidences2=None,
    thermal_img1=None, thermal_img2=None,
    alpha: float = 0.2, edge_weight: float = 0.5, smoothness_weight: float = 0.3,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """v1 loss. Its edge and smoothness terms are one expression in the
    reference, and stay so here."""
    basic = confidence_weighted_regression_loss(
        pred_pts1, pred_pts2, gt_pts1, gt_pts2, confidences1, confidences2, alpha)
    edge = torch.zeros_like(basic)
    if thermal_img1 is not None and thermal_img2 is not None:
        edge = 0.0
        for img, pts in ((thermal_img1, pred_pts1), (thermal_img2, pred_pts2)):
            tg, d = _gray(img, pts), pts[..., 2]
            gtx = (tg[..., :, 1:] - tg[..., :, :-1]).abs()
            gty = (tg[..., 1:, :] - tg[..., :-1, :]).abs()
            gdx = (d[..., :, 1:] - d[..., :, :-1]).abs()
            gdy = (d[..., 1:, :] - d[..., :-1, :]).abs()
            edge = (edge + (gdx * torch.exp(-gtx * 10)).mean(dim=_MAP)
                    + (gdy * torch.exp(-gty * 10)).mean(dim=_MAP))
    smooth = edge  # the duplicated expression
    total = basic + edge_weight * edge + smoothness_weight * smooth
    return total, {"basic_loss": basic, "edge_loss": edge, "smoothness_loss": smooth}


def _grad_xy_padded(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """|forward difference| of [..., H, W], zero in the last column / row."""
    gx = F.pad((t[..., :, 1:] - t[..., :, :-1]).abs(), (0, 1))
    gy = F.pad((t[..., 1:, :] - t[..., :-1, :]).abs(), (0, 0, 0, 1))
    return gx, gy


def _avg_pool2(t: torch.Tensor, s: int) -> torch.Tensor:
    """F.avg_pool2d(kernel=s, stride=s) on [..., H, W] (floor sizes)."""
    h, w = t.shape[-2:]
    hh, ww = h // s, w // s
    t = t[..., :hh * s, :ww * s]
    return t.reshape(*t.shape[:-2], hh, s, ww, s).mean(dim=(-3, -1))


def _huber_mean(diff: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(diff < delta, 0.5 * diff * diff,
                       delta * (diff - 0.5 * delta)).mean(dim=_MAP)


def enhanced_thermal_aware_loss(
    pred_pts1, pred_pts2, gt_pts1, gt_pts2,
    confidences1=None, confidences2=None,
    thermal_img1=None, thermal_img2=None,
    alpha: float = 0.2, edge_weight: float = 0.5, smoothness_weight: float = 0.3,
    detail_weight: float = 0.3, multi_scale: bool = True,
    cfg: Optional[LossConfig] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """v2 loss, the one training uses."""
    if cfg is None:
        cfg = LossConfig()
    basic = confidence_weighted_regression_loss(
        pred_pts1, pred_pts2, gt_pts1, gt_pts2, confidences1, confidences2, alpha)
    edge = torch.zeros_like(basic)
    smooth = torch.zeros_like(basic)
    detail = torch.zeros_like(basic)
    if thermal_img1 is not None and thermal_img2 is not None:
        views = ((_gray(thermal_img1, pred_pts1), pred_pts1[..., 2], gt_pts1[..., 2],
                  cfg.grad_clamp_view1),
                 (_gray(thermal_img2, pred_pts2), pred_pts2[..., 2], gt_pts2[..., 2],
                  cfg.grad_clamp_view2))
        for scale in (cfg.scales if multi_scale else (1,)):
            terms = []  # (edge, smoothness, detail) of each view
            for tg, d, g, clamp in views:
                if scale > 1:
                    tg, d, g = (_avg_pool2(t, scale) for t in (tg, d, g))
                gtx, gty = _grad_xy_padded(tg)
                gdx, gdy = _grad_xy_padded(d)
                ggx, ggy = _grad_xy_padded(g)
                eps = cfg.grad_norm_eps
                ntx = gtx / (gtx.mean(dim=_MAP, keepdim=True) + eps)
                nty = gty / (gty.mean(dim=_MAP, keepdim=True) + eps)
                tf = cfg.thermal_factor
                ew = (torch.exp(-ntx.clamp(0, clamp) * tf)
                      * torch.exp(-nty.clamp(0, clamp) * tf))
                se = (gdx * (1 - ew)).mean(dim=_MAP) + (gdy * (1 - ew)).mean(dim=_MAP)
                ss = (gdx ** 2 * ew).mean(dim=_MAP) + (gdy ** 2 * ew).mean(dim=_MAP)
                sd = (_huber_mean((gdx - ggx).abs(), cfg.huber_delta)
                      + _huber_mean((gdy - ggy).abs(), cfg.huber_delta))
                terms.append((se, ss, sd))
            sw = 1.0 if scale == 1 else 0.7 / scale
            (se1, ss1, sd1), (se2, ss2, sd2) = terms
            edge = edge + sw * (se1 + se2)
            smooth = smooth + sw * (ss1 + ss2)
            detail = detail + sw * (sd1 + sd2)
    total = basic + edge_weight * edge + smoothness_weight * smooth + detail_weight * detail
    return total, {"basic_loss": basic, "edge_loss": edge, "smoothness_loss": smooth,
                   "detail_loss": detail}


def batched_enhanced_loss(
    pred_pts1, pred_pts2, gt_pts1, gt_pts2,
    confidences1, confidences2, thermal1, thermal2,
    alpha: float = 0.2, edge_weight: float = 0.5, smoothness_weight: float = 0.3,
    detail_weight: float = 0.3, multi_scale: bool = True,
):
    """Whole-batch v2 loss: per-sample losses over the leading axis, then
    their mean (and the mean of each component)."""
    losses, comps = enhanced_thermal_aware_loss(
        pred_pts1, pred_pts2, gt_pts1, gt_pts2, confidences1, confidences2,
        thermal1, thermal2, alpha=alpha, edge_weight=edge_weight,
        smoothness_weight=smoothness_weight, detail_weight=detail_weight,
        multi_scale=multi_scale)
    return losses.mean(), {k: v.mean() for k, v in comps.items()}
