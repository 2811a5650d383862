"""Fire-scene thermal preprocessing (counterpart of
thermal3d/preprocess/fire_scene.py, thermal_dustr_inference_for_experiment.py:62-282).

Both variants turn one [H, W] (or [H, W, C]) frame in [0, 1] into the [H, W, 3]
image the model sees, with the filters of kernels/filters.py on the frame's
device. The noise they add to the fire pixels is JAX's: `jax.random.uniform`
under `jax.random.key(0)`, reproduced bit for bit by core/threefry.py, so
that a frame gives the reference's model input. The advanced variant's
histogram-peak analysis runs on the host, as in the reference: it decides
how many temperature regions there are.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from thermal3d_torch.core.threefry import uniform_f32
from thermal3d_torch.kernels.filters import (bilateral_filter, canny_edges, clahe,
                                             sobel_magnitude_normalized)
from thermal3d_torch.preprocess.enhance import rgb_to_gray


Key = Tuple[int, int]


def _noise(shape, key: Optional[Key], device) -> torch.Tensor:
    """jax.random.uniform(key, shape) on `device`; key None is key(0)."""
    return torch.from_numpy(np.array(uniform_f32(tuple(shape), key or (0, 0)))).to(device)


def percentile_linear(flat: torch.Tensor, percents) -> torch.Tensor:
    """jnp.percentile(flat, percents) with linear interpolation, in its
    float32 arithmetic: q = p / 100, position q·(n − 1), then
    low·(1 − w) + high·w of the sorted values (torch.quantile interpolates
    with lerp, which rounds differently)."""
    srt = torch.sort(flat).values
    n = srt.numel()
    q = torch.tensor(percents, dtype=torch.float32, device=flat.device)
    pos = q / torch.full_like(q, 100.0) * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    low = torch.clamp(low, 0, n - 1).to(torch.int64)
    high = torch.clamp(high, 0, n - 1).to(torch.int64)
    return srt[low] * w_low + srt[high] * w_high


def preprocess_fire_scene_thermal(img: torch.Tensor, key: Optional[Key] = None,
                                  fire_threshold: float = 0.7) -> torch.Tensor:
    """Fire-as-foreground encoding (…for_experiment.py:62-154): 5/95
    percentile normalisation, fire mask (norm > fire_threshold), an
    inverted, contrast-boosted CLAHE(3.0, 8×8) base, fire pixels coloured
    (0.8, 0.3, 0.1) plus noise·0.1, Canny(50, 150) edges blended in at 0.3
    on fire and 0.15 elsewhere. img: [H, W] or [H, W, C] in [0, 1];
    key: the threefry key pair of the noise (jax.random.key(s) is (0, s)
    for s < 2**32), None for key(0) as in the reference.
    Returns [H, W, 3] float32."""
    gray = rgb_to_gray(img) if img.dim() == 3 else img
    gray = gray.to(torch.float32)
    p = percentile_linear(gray.reshape(-1), (5.0, 95.0))
    norm = (torch.clamp(gray, p[0], p[1]) - p[0]) / (p[1] - p[0] + 1e-6)

    fire = (norm > fire_threshold)[..., None]
    base = clahe(torch.clamp((1.0 - norm) * 1.2, 0.0, 1.0), clip_limit=3.0, grid=(8, 8))
    fire_color = torch.tensor([0.8, 0.3, 0.1], dtype=base.dtype, device=base.device)
    result = torch.where(fire, fire_color, base[..., None])
    noise = _noise(gray.shape, key, gray.device) * 0.1
    result = torch.where(fire, result + noise[..., None], result)

    edges = canny_edges(norm, low=50.0, high=150.0)
    ew = torch.where(fire, 0.3, 0.15)
    result = result * (1.0 - ew) + edges[..., None] * ew
    return torch.clamp(result, 0.0, 1.0)


def _find_histogram_peaks(hist: np.ndarray, height: float, distance: int) -> np.ndarray:
    """scipy.signal.find_peaks(height, distance) as the reference restates
    it: strict local maxima at least `height`, thinned greedily from the
    highest so that kept peaks are at least `distance` apart."""
    n = len(hist)
    cand = [i for i in range(1, n - 1) if hist[i] > hist[i - 1] and hist[i] > hist[i + 1]
            and hist[i] >= height]
    cand.sort(key=lambda i: -hist[i])
    kept: list[int] = []
    for i in cand:
        if all(abs(i - j) >= distance for j in kept):
            kept.append(i)
    return np.array(sorted(kept), dtype=np.int64)


def fire_thresholds(gray: np.ndarray) -> np.ndarray:
    """The advanced variant's temperature thresholds, on the host: the
    midpoints between neighbouring peaks (bin left edges) of the 100-bin
    histogram over [0, 1], peaks at least 30% of the highest bin and 10
    bins apart; [0.7] when fewer than two peaks."""
    hist, bins = np.histogram(gray.ravel(), bins=100, range=(0, 1))
    peaks = _find_histogram_peaks(hist.astype(np.float64), height=hist.max() * 0.3, distance=10)
    peak_values = np.sort(bins[peaks])
    if len(peak_values) < 2:
        return np.array([0.7], dtype=np.float32)
    return np.array([(peak_values[i] + peak_values[i + 1]) / 2
                     for i in range(len(peak_values) - 1)], dtype=np.float32)


def advanced_fire_scene_processing(img: torch.Tensor, key: Optional[Key] = None
                                   ) -> torch.Tensor:
    """Structure-preserving fire-scene preprocessing (…for_experiment.py:156-282):
    CLAHE(2.5) of the inverted frame, the hottest region (above the last
    histogram threshold) darkened (0.5, 0.3, 0.2) with noise·0.15, the max of
    Canny(30, 150) and the normalised Sobel magnitude blended in at 0.4 on
    the hottest region and 0.2 elsewhere, then a bilateral filter (d 9,
    σ_colour 75/255, σ_space 75). img: [H, W] or [H, W, C] in [0, 1] (a
    tensor or a numpy array, on the device it should run on); key as in
    preprocess_fire_scene_thermal. Returns [H, W, 3] float32."""
    img = torch.as_tensor(img, dtype=torch.float32)
    gray = rgb_to_gray(img) if img.dim() == 3 else img
    thresholds = fire_thresholds(gray.cpu().numpy())

    base = clahe(1.0 - gray, clip_limit=2.5, grid=(8, 8))
    combined_edges = torch.maximum(canny_edges(gray, low=30.0, high=150.0),
                                   sobel_magnitude_normalized(gray))
    result = base[..., None].expand(*base.shape, 3)
    hottest = (gray > torch.tensor(thresholds[-1], device=gray.device))[..., None]
    scale = torch.tensor([0.5, 0.3, 0.2], dtype=base.dtype, device=base.device)
    result = torch.where(hottest, base[..., None] * scale, result)
    noise = _noise(gray.shape, key, gray.device) * 0.15
    result = torch.where(hottest, result + noise[..., None], result)

    es = torch.where(hottest, 0.4, 0.2)
    result = result * (1.0 - es) + combined_edges[..., None] * es
    result = bilateral_filter(result, d=9, sigma_color=75.0 / 255.0, sigma_space=75.0)
    return torch.clamp(result, 0.0, 1.0)
