"""The entry points' figures (counterpart of the parts of thermal3d/viz/panels.py
that cli.infer, cli.evaluate, cli.ais_investigate and the pseudo-GT writers
call), drawn as arrays on the host and written by viz/png.py.

The reference draws with matplotlib, which the card's machine does not have.
Each figure here holds the reference figure's tiles in its arrangement, each
tile the data at its own resolution through the same colormap and limits
(viz/colormaps.py is bit-equal to matplotlib's mapping), with a colorbar
strip (vmax at the top) right of each tile that has one in the reference.
Not carried over: the figure's text and frame (titles, ticks, labels, the
"Image not available" note, whose tile stays blank) and matplotlib's
resampling of a tile to the figure's pixel grid. Tiles sit on a white
ground, top-aligned, GAP pixels apart.

A function given save_path writes the PNG and returns None; without it, it
returns the figure as uint8 [H, W, 3].
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from thermal3d_torch.viz.colormaps import autoscale, colormap_rgb
from thermal3d_torch.viz.png import write_png

GAP = 8  # white pixels between tiles
BAR_GAP = 4  # between a tile and its colorbar
BAR_WIDTH = 12
WHITE = 255


def _to_hwc(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    return img


def _depth_limits(*depths):
    vmin = min(float(np.min(d)) for d in depths)
    vmax = max(float(np.max(d)) for d in depths)
    if vmin == vmax:
        vmin, vmax = vmin - 0.1, vmax + 0.1
    return vmin, vmax


def rgb_tile(img) -> np.ndarray:
    """A float RGB (or gray) image in [0, 1] as matplotlib shows it:
    clipped, then (x · 255) truncated to uint8; [H, W, 3]."""
    img = np.clip(_to_hwc(img), 0, 1)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return (img * 255).astype(np.uint8)


def colorbar(name: str, height: int, vmin, vmax) -> np.ndarray:
    """A vertical strip of colormap `name` from vmax (top) to vmin."""
    values = np.linspace(float(vmax), float(vmin), max(height, 1))
    strip = colormap_rgb(values, name, float(vmin), float(vmax))
    return np.repeat(strip[:, None, :], BAR_WIDTH, axis=1)


def mapped(data, name: str, vmin=None, vmax=None, bar: bool = False) -> List[np.ndarray]:
    """A tile of `data` through colormap `name` (autoscaled where a limit is
    None), followed by its colorbar when `bar`."""
    data = np.asarray(data)
    if vmin is None or vmax is None:
        lo, hi = autoscale(data)
        vmin = lo if vmin is None else vmin
        vmax = hi if vmax is None else vmax
    tile = colormap_rgb(data, name, vmin, vmax)
    if not bar:
        return [tile]
    return [tile, np.full((tile.shape[0], BAR_GAP, 3), WHITE, np.uint8),
            colorbar(name, tile.shape[0], vmin, vmax)]


def _row(groups: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
    """Groups of parts side by side, GAP apart, top-aligned on white."""
    parts: List[np.ndarray] = []
    for i, group in enumerate(groups):
        if i:
            parts.append(np.full((1, GAP, 3), WHITE, np.uint8))
        parts.extend(group)
    h = max(p.shape[0] for p in parts)
    out = np.full((h, sum(p.shape[1] for p in parts), 3), WHITE, np.uint8)
    x = 0
    for p in parts:
        out[:p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1]
    return out


def _grid(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Rows one above the other, GAP apart, left-aligned on white."""
    w = max(r.shape[1] for r in rows)
    h = sum(r.shape[0] for r in rows) + GAP * (len(rows) - 1)
    out = np.full((h, w, 3), WHITE, np.uint8)
    y = 0
    for r in rows:
        out[y:y + r.shape[0], :r.shape[1]] = r
        y += r.shape[0] + GAP
    return out


def _finish(figure: np.ndarray, save_path: Optional[str]):
    if save_path:
        write_png(save_path, figure)
        return None
    return figure


def visualize_depth_result(thermal_img, depth, confidence=None,
                           save_path: Optional[str] = None):
    """Inference result: input | depth (plasma, colorbar) | confidence
    (viridis, colorbar) when given (thermal_dustr_inference.py:162-294)."""
    groups = [[rgb_tile(thermal_img)], mapped(depth, "plasma", bar=True)]
    if confidence is not None:
        groups.append(mapped(confidence, "viridis", bar=True))
    return _finish(_row(groups), save_path)


def thermal_file_tile(path: str) -> Optional[np.ndarray]:
    """What cv2.imread(path) shows of a PNG: 8-bit samples as they are,
    16-bit ones >> 8, gray repeated to RGB; None when it does not decode."""
    from thermal3d_torch import native

    decoded = native.decode_png(path) if path.lower().endswith(".png") else None
    if decoded is None:
        return None
    img, depth = decoded
    img = img.astype(np.uint16)
    if depth == 16:
        img = img >> 8
    img = img.astype(np.uint8)
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def save_comparison_panel(thermal_path: str, pred_depth, gt_depth, rmse: float,
                          save_path: str):
    """thermal | predicted | GT, both depths in plasma, each autoscaled, no
    colorbars (evaluate_depth_metrics.py:329-365). The RMSE is only in the
    reference's title."""
    del rmse
    pred = mapped(pred_depth, "plasma")
    thermal = thermal_file_tile(thermal_path)
    if thermal is None:
        thermal = np.full_like(pred[0], WHITE)
    return _finish(_row([[thermal], pred, mapped(gt_depth, "plasma")]), save_path)


def visualize_data(rgb1, rgb2, depth1, depth2, save_path: Optional[str] = None):
    """Pseudo-GT 2×2: the RGB pair over the depth pair, both depths in
    plasma on shared limits, each with a colorbar (pseudo_gt.py:345-377)."""
    vmin, vmax = _depth_limits(depth1, depth2)
    top = _row([[rgb_tile(rgb1)], [rgb_tile(rgb2)]])
    bottom = _row([mapped(depth1, "plasma", vmin, vmax, bar=True),
                   mapped(depth2, "plasma", vmin, vmax, bar=True)])
    return _finish(_grid([top, bottom]), save_path)


def save_depth_vis(depth, save_path: str) -> None:
    """The test set's preview: depth in plasma with a colorbar
    (thermal3d/pseudo_gt/test_set.py:64-76)."""
    _finish(_row([mapped(depth, "plasma", bar=True)]), save_path)


def stage_strip(thermal, depths: dict, save_path: Optional[str] = None):
    """cli.ais_investigate's row for one frame: the thermal frame in gray,
    then each stage's depth in viridis on a shared 0..vmax scale (vmax the
    largest depth of any stage), each with a colorbar."""
    vmax = max(np.nanmax(d) for d in depths.values())
    groups = [mapped(thermal, "gray")]
    groups += [mapped(d, "viridis", 0.0, vmax, bar=True) for d in depths.values()]
    return _finish(_row(groups), save_path)
