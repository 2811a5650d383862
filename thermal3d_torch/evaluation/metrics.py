"""Depth evaluation metrics (counterpart of thermal3d/evaluation/metrics.py),
computed on the device in float32.

Valid mask gt > 0 and finite (or a given mask); optional median scaling
(pred ·= median(gt) / median(pred) over the mask, each median the mean of
the two middle values for an even count, as jnp.nanmedian takes it); then
AbsRel, SqRel, RMSE, RMSE-log and the δ < 1.25 / 1.25² / 1.25³ accuracies
as masked means. With an empty mask the error metrics are NaN and the
accuracies 0. Every function takes a batch: the metrics reduce over the
last two axes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from thermal3d_torch.core.device import resolve_device
from thermal3d_torch.geometry.intrinsics import nanmedian_midpoint

METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "acc_1", "acc_2", "acc_3")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, 0.0).sum(dim=(-2, -1)) / n.clamp(min=1)


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    flat = torch.where(mask, x, float("nan")).flatten(-2)
    return nanmedian_midpoint(flat)


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  median_scaling: bool = True) -> Dict[str, torch.Tensor]:
    """pred, gt: [..., H, W] on one device → dict of [...] float32 tensors."""
    pred = pred.to(torch.float32)
    gt = gt.to(torch.float32)
    mask = (gt > 0) & torch.isfinite(gt) if mask is None else mask.to(torch.bool)
    n = mask.sum(dim=(-2, -1))
    safe = n > 0
    if median_scaling:
        scale = _masked_median(gt, mask) / _masked_median(pred, mask)
        pred = pred * scale[..., None, None]
    # guard the divisions on masked-out pixels
    gt_s = torch.where(mask, gt, 1.0)
    pred_s = torch.where(mask, pred, 1.0)
    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    diff = gt_s - pred_s
    out = {
        "abs_rel": _masked_mean(diff.abs() / gt_s, mask, n),
        "sq_rel": _masked_mean(diff ** 2 / gt_s, mask, n),
        "rmse": torch.sqrt(_masked_mean(diff ** 2, mask, n)),
        "rmse_log": torch.sqrt(_masked_mean((torch.log(gt_s) - torch.log(pred_s)) ** 2,
                                            mask, n)),
        "acc_1": _masked_mean((thresh < 1.25).to(torch.float32), mask, n),
        "acc_2": _masked_mean((thresh < 1.25 ** 2).to(torch.float32), mask, n),
        "acc_3": _masked_mean((thresh < 1.25 ** 3).to(torch.float32), mask, n),
    }
    for k in METRICS:
        empty = float("nan") if k[:3] != "acc" else 0.0
        out[k] = torch.where(safe, out[k], empty)
    return out


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device)


def compute_depth_metrics(pred_depth, gt_depth, mask=None, median_scaling: bool = True,
                          device=None) -> Dict[str, float]:
    """One [H, W] pair (numpy or tensors) → python floats. device: None means
    CUDA (raises without it)."""
    dev = resolve_device(device)
    with torch.inference_mode():
        out = depth_metrics(_tensor(pred_depth, dev), _tensor(gt_depth, dev),
                            None if mask is None else _tensor(mask, dev), median_scaling)
        return {k: float(v) for k, v in out.items()}


def batched_depth_metrics(pred_depth, gt_depth, median_scaling: bool = True,
                          device=None) -> Dict[str, np.ndarray]:
    """[B, H, W] pairs → dict of float32 [B] numpy arrays, one launch sequence
    for the whole batch."""
    dev = resolve_device(device)
    with torch.inference_mode():
        out = depth_metrics(_tensor(pred_depth, dev), _tensor(gt_depth, dev),
                            median_scaling=median_scaling)
        return {k: v.cpu().numpy() for k, v in out.items()}
