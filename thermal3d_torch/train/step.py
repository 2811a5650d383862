"""Train and eval steps (counterpart of thermal3d/train/step.py).

One batched step, on the model's device:
  * the raw thermal frames are percentile-enhanced on the device (K1 on the
    card, two launches a step, no gradient);
  * the pseudo-GT pointmaps (512² in the Freiburg layout) are resized to the
    prediction's resolution inside the step (bilinear, half-pixel);
  * the confidence is the model's own, floored at 1e-5;
  * the loss is the enhanced thermal-aware v2 loss or the plain
    confidence-weighted L1, per sample and then the batch mean;
  * the gradients of the float32 master weights go through the clip and
    AdamW of train/state.py.
The metrics stay on the device: the loop fetches them once per log window.

On a process mesh (core/mesh.py) each rank computes the loss of its own
rows (its 'data' position's slice of the global batch); after the backward
the gradients are averaged over 'data' (core.collectives.all_reduce_buckets_:
flat buckets, one all_reduce each). The per-sample-mean loss makes the
average of the ranks' means the global batch's mean, and the loss metrics
are averaged the same way, so every rank reports the global batch's values.
Tensor parallelism runs inside the model's layers (models/layers.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from thermal3d_torch.core import collectives
from thermal3d_torch.core.config import TrainConfig
from thermal3d_torch.core.mesh import Mesh
from thermal3d_torch.core.device import exact_float32_convs
from thermal3d_torch.losses.losses import (confidence_weighted_regression_loss,
                                           enhanced_thermal_aware_loss)
from thermal3d_torch.models.dustr import head_dtype
from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast, rgb_to_gray
from thermal3d_torch.preprocess.resize import resize_bilinear_hwc
from thermal3d_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _resize_gt_to(pred_hw: Tuple[int, int], gt: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of batched GT pointmaps [B,Hg,Wg,3] to pred_hw."""
    if tuple(gt.shape[1:3]) == tuple(pred_hw):
        return gt
    return resize_bilinear_hwc(gt, pred_hw)


def _prepare_views(batch: Batch, enhance_impl: str = "auto") -> Batch:
    """Percentile enhancement of the raw thermal frames on the device."""
    out = dict(batch)
    with torch.no_grad():
        for i in (1, 2):
            out[f"thermal{i}_enh"] = enhance_thermal_contrast(
                rgb_to_gray(batch[f"thermal{i}"]), impl=enhance_impl)
    return out


def _batch_loss(pred1, pred2, batch: Batch, pred_hw, cfg: TrainConfig):
    gt1 = _resize_gt_to(pred_hw, batch["pointmap1"])
    gt2 = _resize_gt_to(pred_hw, batch["pointmap2"])
    conf1 = pred1["conf"].clamp(min=1e-5)
    conf2 = pred2["conf"].clamp(min=1e-5)
    lc = cfg.loss
    if cfg.use_enhanced_loss:
        losses, comps = enhanced_thermal_aware_loss(
            pred1["pts3d"], pred2["pts3d_in_other_view"], gt1, gt2, conf1, conf2,
            rgb_to_gray(batch["thermal1_enh"]), rgb_to_gray(batch["thermal2_enh"]),
            alpha=lc.alpha, edge_weight=lc.edge_weight,
            smoothness_weight=lc.smoothness_weight, detail_weight=lc.detail_weight,
            multi_scale=lc.multi_scale, cfg=lc)
        return losses.mean(), {k: v.mean() for k, v in comps.items()}
    loss = confidence_weighted_regression_loss(
        pred1["pts3d"], pred2["pts3d_in_other_view"], gt1, gt2, conf1, conf2,
        lc.alpha).mean()
    return loss, {"basic_loss": loss}


def make_train_step(model: torch.nn.Module, cfg: TrainConfig,
                    enhance_impl: str = "auto", mesh: Optional[Mesh] = None) -> Callable:
    """(state, batch) → (state, metrics). batch: tensors on the model's
    device, thermal1/2 [B,H,W,3] raw counts, pointmap1/2 [B,Hg,Wg,3] (on a
    process mesh, this rank's rows). metrics (device tensors): loss,
    grad_norm (before the clip), the loss components, and
    sample_pred_depth / sample_gt_depth of sample 0. A model whose trunk or
    DPT heads compute in float32 takes its gradient with TF32 off (the
    forward's convs turn it off themselves)."""
    f32 = torch.float32 in (model.config.dtype, head_dtype(model.config))
    dtype = torch.float32 if f32 else model.config.dtype
    data_group = mesh.group("data") if mesh is not None else None
    n_data = collectives.group_size(data_group)

    def train_step(state: TrainState, batch: Batch):
        batch = _prepare_views(batch, enhance_impl)
        with exact_float32_convs(dtype):
            pred1, pred2 = model(batch["thermal1_enh"], batch["thermal2_enh"])
            pred_hw = tuple(pred1["pts3d"].shape[1:3])
            loss, comps = _batch_loss(pred1, pred2, batch, pred_hw, cfg)
            grads = list(torch.autograd.grad(loss, state.params))
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics["loss"] = loss.detach()
        if n_data > 1:  # the global batch's mean gradient and metrics
            collectives.all_reduce_buckets_(grads, data_group, scale=1.0 / n_data)
            keys = list(metrics)
            means = torch.stack([metrics[k].to(torch.float32) for k in keys])
            collectives.all_reduce_(means, data_group).div_(n_data)
            metrics = dict(zip(keys, means.unbind()))
        metrics["sample_pred_depth"] = pred1["pts3d"][0, :, :, 2].detach()
        metrics["sample_gt_depth"] = _resize_gt_to(pred_hw, batch["pointmap1"])[0, :, :, 2]
        metrics["grad_norm"] = state.tx.grad_norm(grads)
        state.apply_gradients(grads)
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, cfg: TrainConfig,
                   enhance_impl: str = "auto") -> Callable:
    """(model or TrainState, batch) → per-sample validation losses [B]: the
    plain L1 (mean1 + mean2) / 2 of each sample, so the caller can average
    over the real (non-padded) samples only. On a process mesh: this rank's
    rows' losses (every rank of a 'model' group must call it together)."""
    del model, cfg  # the net comes with each call; the signature is JAX's

    def eval_step(model_or_state, batch: Batch) -> torch.Tensor:
        net = model_or_state.model if isinstance(model_or_state, TrainState) else model_or_state
        with torch.no_grad(), exact_float32_convs(net.config.dtype):
            batch = _prepare_views(batch, enhance_impl)
            pred1, pred2 = net(batch["thermal1_enh"], batch["thermal2_enh"])
            pred_hw = tuple(pred1["pts3d"].shape[1:3])
            gt1 = _resize_gt_to(pred_hw, batch["pointmap1"])
            gt2 = _resize_gt_to(pred_hw, batch["pointmap2"])
            l1 = (pred1["pts3d"] - gt1).abs().mean(dim=(1, 2, 3))
            l2 = (pred2["pts3d_in_other_view"] - gt2).abs().mean(dim=(1, 2, 3))
            return (l1 + l2) / 2

    return eval_step
