"""Test-set evaluation driver (counterpart of thermal3d/evaluation/evaluator.py,
utils/evaluate_depth_metrics.py:199-401).

The filename heuristics are the reference's, unchanged (timestamp
extraction, the trailing-'0' RGB/IR suffix repair, the glob fallback, the
fuzzy scan); inference runs through InferenceEngine.infer_paths (depth
only); the metrics of all frames are one batched call on the engine's
device; the per-image `_metrics.txt`, `_comparison.png` (viz/panels.py) and
`metrics_summary.txt` layouts are the reference's. `evaluate_thermal_depth`
is the model-level evaluator over a dataset's samples.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from thermal3d_torch.evaluation.metrics import METRICS, batched_depth_metrics, compute_depth_metrics
from thermal3d_torch.infer.engine import InferenceEngine
from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast, rgb_to_gray
from thermal3d_torch.viz.panels import save_comparison_panel


def find_matching_depth_file(thermal_path: str, depth_dir: str) -> Optional[str]:
    """evaluate_depth_metrics.py:199-245."""
    thermal_name = os.path.splitext(os.path.basename(thermal_path))[0]
    parts = thermal_name.split("_")
    if len(parts) < 3:
        return None
    timestamp = "_".join(parts[2:-1])
    rgb_numeric = parts[-2] + "0"  # IR stamps drop a trailing 0 vs RGB
    rgb_basename = f"fl_ir_aligned_{timestamp}_{rgb_numeric}_rgb"

    direct = os.path.join(depth_dir, f"{rgb_basename}_depth.npy")
    if os.path.exists(direct):
        return direct
    matches = glob.glob(os.path.join(depth_dir, f"*{timestamp}*_depth.npy"))
    if matches:
        return sorted(matches)[0]
    for filename in sorted(os.listdir(depth_dir)):
        if not filename.endswith("_depth.npy"):
            continue
        fparts = filename.split("_")
        if len(fparts) < 3:
            continue
        file_timestamp = "_".join(fparts[2:4])
        if timestamp in file_timestamp or file_timestamp in timestamp:
            return os.path.join(depth_dir, filename)
    return None


def _resize_nearest(img: np.ndarray, hw) -> np.ndarray:
    """Nearest-neighbour resize with cv2's INTER_NEAREST rule (the
    reference's, eval:320-323): destination index i reads source index
    min(floor(i · (1 / (dst / src))), src − 1), in float64. Not half-pixel:
    jax.image.resize's 'nearest' centres differ."""
    (sh, sw), (dh, dw) = img.shape[:2], hw

    def index(src: int, dst: int) -> np.ndarray:
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64),
                          src - 1)

    return img[index(sh, dh)[:, None], index(sw, dw)[None, :]]


def evaluate_test_set(engine: InferenceEngine, thermal_paths: List[str],
                      pseudo_gt_depth_dir: str, output_dir: Optional[str] = None,
                      save_visualizations: bool = True,
                      batch_size: int = 16) -> Dict[str, float]:
    """Batched monocular evaluation against pseudo-GT depths: per-image
    metrics files, comparison panels (save_visualizations) and
    metrics_summary.txt when output_dir is given. Returns the averaged
    metrics."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    matched = [(t, find_matching_depth_file(t, pseudo_gt_depth_dir)) for t in thermal_paths]
    matched = [(t, d) for t, d in matched if d is not None]
    if not matched:
        return {}

    results = engine.infer_paths([t for t, _ in matched], batch_size=batch_size,
                                 outputs=("depth",))
    if not results:
        return {}
    pred_depths = results["depth"]
    # re-pair via the surviving paths: decode failures are dropped inside
    # infer_paths, so zipping `matched` would shift every row after a bad file
    gt_by_thermal = dict(matched)
    matched = [(t, gt_by_thermal[t]) for t in results["paths"]]

    gts = []
    for (_, gt_path), pred in zip(matched, pred_depths):
        gt = np.load(gt_path)
        gts.append(gt if gt.shape == pred.shape else _resize_nearest(gt, pred.shape))
    batched = batched_depth_metrics(pred_depths, np.stack(gts), median_scaling=True,
                                    device=engine.device)
    all_metrics = [{k: float(v[i]) for k, v in batched.items()} for i in range(len(gts))]
    if output_dir:
        for (thermal_path, _), m, pred, gt in zip(matched, all_metrics, pred_depths, gts):
            base = os.path.splitext(os.path.basename(thermal_path))[0]
            with open(os.path.join(output_dir, f"{base}_metrics.txt"), "w") as f:
                f.write(f"RMSE: {m['rmse']:.4f}\n")
                f.write(f"Acc[<1.25]: {m['acc_1']:.4f}\n")
                f.write(f"Acc[<1.25^2]: {m['acc_2']:.4f}\n")
            if save_visualizations:
                save_comparison_panel(thermal_path, pred, gt, m["rmse"],
                                      os.path.join(output_dir, f"{base}_comparison.png"))

    avg = {
        "n_images": len(all_metrics),
        "rmse": float(np.mean([m["rmse"] for m in all_metrics if np.isfinite(m["rmse"])])),
        "acc_1": float(np.mean([m["acc_1"] for m in all_metrics])),
        "acc_2": float(np.mean([m["acc_2"] for m in all_metrics])),
        "abs_rel": float(np.mean([m["abs_rel"] for m in all_metrics
                                  if np.isfinite(m["abs_rel"])])),
    }
    if output_dir:
        with open(os.path.join(output_dir, "metrics_summary.txt"), "w") as f:
            f.write(f"Number of images evaluated: {avg['n_images']}\n")
            f.write(f"Average RMSE: {avg['rmse']:.4f}\n")
            f.write(f"Average Acc[<1.25]: {avg['acc_1']:.4f}\n")
            f.write(f"Average Acc[<1.25^2]: {avg['acc_2']:.4f}\n")
    return avg


def evaluate_thermal_depth(engine: InferenceEngine, dataset, indices=None,
                           batch_size: int = 8) -> Dict[str, float]:
    """Model-level evaluator (the reference's utils/metrics.py:72-137): for
    each sample with GT (depth1, else pointmap1's z), enhance thermal1 on the
    engine's device, run the engine monocular on it (preprocessed), resize
    the GT to the prediction (nearest) and take the median-scaled metrics;
    each metric averages its finite values over the evaluated samples.
    batch_size is the JAX signature's and changes nothing (one sample a
    call, as there)."""
    del batch_size
    sums = {k: 0.0 for k in METRICS}
    count = 0
    for i in (indices if indices is not None else range(len(dataset))):
        sample = dataset[i]
        if sample is None or "depth1" not in sample and "pointmap1" not in sample:
            continue
        gt_depth = sample.get("depth1")
        if gt_depth is None:
            gt_depth = sample["pointmap1"][..., 2]
        thermal = torch.as_tensor(sample["thermal1"], dtype=torch.float32).to(engine.device)
        with torch.inference_mode():
            enhanced = enhance_thermal_contrast(rgb_to_gray(thermal), impl=engine.enhance_impl)
        pred = engine.infer(enhanced[None], preprocessed=True)["depth"][0]
        if gt_depth.shape != pred.shape:
            gt_depth = _resize_nearest(gt_depth, pred.shape)
        m = compute_depth_metrics(pred, gt_depth, median_scaling=True, device=engine.device)
        for k in METRICS:
            if np.isfinite(m[k]):
                sums[k] += m[k]
        count += 1
    return {k: (v / count if count else float("nan")) for k, v in sums.items()}
