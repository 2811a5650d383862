"""Depth-map refinement (counterpart of thermal3d/preprocess/refine.py,
thermal_dustr_inference_for_experiment.py:284-377): 3σ outliers replaced by a
masked 5×5 local median, a guided filter steered by the thermal gray, then a
bilateral filter on the depth values; plain PyTorch on the depth's device.
"""

from __future__ import annotations

import torch

from thermal3d_torch.kernels.filters import bilateral_filter, guided_filter, remove_depth_outliers
from thermal3d_torch.preprocess.enhance import rgb_to_gray


def refine_depth(depth: torch.Tensor, thermal: torch.Tensor,
                 use_guided_filter: bool = True) -> torch.Tensor:
    """depth: [H, W]; thermal: [H, W] or [H, W, C] in [0, 1] on the same
    device. guidedFilter(radius 8, eps 1e-4), then bilateralFilter(d 5,
    σ_colour 50, σ_space 50)."""
    gray = rgb_to_gray(thermal) if thermal.dim() == 3 else thermal
    refined = remove_depth_outliers(depth, kernel_size=5, n_sigma=3.0)
    if use_guided_filter:
        refined = guided_filter(gray.to(torch.float32), refined.to(torch.float32),
                                radius=8, eps=1e-4)
    return bilateral_filter(refined, d=5, sigma_color=50.0, sigma_space=50.0)
