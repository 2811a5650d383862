"""Parity harness (counterpart of thermal3d/evaluation/parity.py): this
port's depth outputs against reference outputs for the same frames
(BASELINE.md: "AbsRel within 1% of the PyTorch reference").

* compare_depth_dirs: ours/*.npy against theirs/*.npy matched by file name:
  per-frame max|Δ|, relative error, bit-equality and median-scaled AbsRel.
* compare_engine_to_golden: run an InferenceEngine on the thermal frames
  recorded in a golden pseudo_gt_test_set-style directory and report the
  depth metrics against the golden depths (evaluate_test_set).

The AbsRel goes through the port's metrics (evaluation/metrics.py) on
`device` (None: the card); the rest is float64 numpy, as in the JAX module.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from thermal3d_torch.evaluation.metrics import compute_depth_metrics


def compare_depth_arrays(ours: np.ndarray, theirs: np.ndarray, device=None) -> Dict[str, float]:
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    denom = np.maximum(np.abs(theirs), 1e-6)
    abs_rel = compute_depth_metrics(ours, theirs, median_scaling=True, device=device)["abs_rel"]
    return {
        "max_abs_diff": float(np.max(np.abs(ours - theirs))),
        "mean_abs_diff": float(np.mean(np.abs(ours - theirs))),
        "max_rel_diff": float(np.max(np.abs(ours - theirs) / denom)),
        "abs_rel_vs_reference": float(abs_rel),
        "bit_equal": bool(np.array_equal(ours.astype(np.float32), theirs.astype(np.float32))),
    }


def compare_depth_dirs(ours_dir: str, theirs_dir: str, pattern: str = "*_depth.npy",
                       report_path: Optional[str] = None, device=None) -> Dict:
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(theirs_dir, pattern)))
    per_frame = {}
    for name in names:
        ours_p = os.path.join(ours_dir, name)
        if not os.path.exists(ours_p):
            per_frame[name] = {"missing": True}
            continue
        per_frame[name] = compare_depth_arrays(np.load(ours_p),
                                               np.load(os.path.join(theirs_dir, name)), device)
    valid = [v for v in per_frame.values() if not v.get("missing")]
    summary = {
        "n_frames": len(names),
        "n_compared": len(valid),
        "n_missing": len(names) - len(valid),
        "mean_abs_rel": float(np.mean([v["abs_rel_vs_reference"] for v in valid]))
        if valid else float("nan"),
        "worst_max_rel_diff": float(max((v["max_rel_diff"] for v in valid),
                                        default=float("nan"))),
        "all_bit_equal": all(v["bit_equal"] for v in valid) if valid else False,
        # the BASELINE.json target: AbsRel (after median scaling) within 1%
        "within_1pct_abs_rel": bool(valid) and all(
            v["abs_rel_vs_reference"] <= 0.01 for v in valid),
    }
    report = {"summary": summary, "per_frame": per_frame}
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def compare_engine_to_golden(engine, golden_depth_dir: str,
                             thermal_root_remap: Optional[Dict[str, str]] = None,
                             max_frames: Optional[int] = None, batch_size: int = 16) -> Dict:
    """Run the engine on the thermal frames recorded in the *_thermal_path.txt
    files of a golden test-set directory; evaluate against the golden depths."""
    from thermal3d_torch.evaluation.evaluator import evaluate_test_set

    txts = sorted(glob.glob(os.path.join(golden_depth_dir, "*_thermal_path.txt")))
    thermal_paths: List[str] = []
    for t in txts[: max_frames or len(txts)]:
        with open(t) as f:
            p = f.read().strip()
        for old, new in (thermal_root_remap or {}).items():
            p = p.replace(old, new)
        if os.path.exists(p):
            thermal_paths.append(p)
    if not thermal_paths:
        return {"error": "no thermal frames resolvable", "n_txt": len(txts)}
    return evaluate_test_set(engine, thermal_paths, golden_depth_dir, output_dir=None,
                             save_visualizations=False, batch_size=batch_size)
