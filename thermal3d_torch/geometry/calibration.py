"""Thermal camera calibration loaders (counterpart of
thermal3d/geometry/calibration.py): JSON ({intrinsic: [fx, fy, cx, cy],
rotation, translation}, the calibrations/t_calib.json layout) and
Kalibr-style YAML stereo (left/right intrinsics + T_cn_cnm1). Host-side.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np


def _k_from_fxfycxcy(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def load_thermal_calibration(calib_path: str
                             ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """JSON → (K, R, t); YAML → (K_left, K_right, T_right_left), the last two
    None without a right camera. Raises ValueError for another suffix."""
    if calib_path.endswith(".json"):
        with open(calib_path) as f:
            calib = json.load(f)
        fx, fy, cx, cy = calib["intrinsic"]
        return (_k_from_fxfycxcy(fx, fy, cx, cy), np.array(calib["rotation"]),
                np.array(calib["translation"]))
    if calib_path.endswith(".yaml"):
        import yaml

        with open(calib_path) as f:
            calib = yaml.safe_load(f)
        k_left = _k_from_fxfycxcy(*calib["left"]["intrinsics"])
        if "right" in calib:
            k_right = _k_from_fxfycxcy(*calib["right"]["intrinsics"])
            return k_left, k_right, np.array(calib["right"]["T_cn_cnm1"])
        return k_left, None, None
    raise ValueError(f"Unsupported calibration file format: {calib_path}")
