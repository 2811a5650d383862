"""The figures of thermal3d/viz/panels.py (the entry points' panels, the IR
displays and the 3-D point-cloud and pair panels), drawn as arrays on the
host and written by viz/png.py.

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
returns the figure as uint8 [H, W, 3] (the IR helpers that return an array
in the reference return that array either way). The 3-D panels project
their points as the reference's 3-D axes do at their default view
(viz/view3d.py) and draw them as pixels, the cameras' axes as lines. Files
are read by the port's PNG decoder, and resized by resize_bilinear_hw, where
the reference uses cv2.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from thermal3d_torch.core.config import FREIBURG_RAW_MIN, FREIBURG_VIZ_MAX
from thermal3d_torch.viz.colormaps import autoscale, colormap_float, colormap_rgb
from thermal3d_torch.viz.png import write_png
from thermal3d_torch.viz.view3d import View, limits

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


# ---------------------------------------------------------------------------
# IR displays (thermal3d/viz/panels.py:149-275)
# ---------------------------------------------------------------------------

def read_ir(path: str) -> np.ndarray:
    """A thermal PNG's samples as they are ([H, W], uint16 or uint8; a
    multi-channel frame averaged, as the native loader does), what
    cv2.imread(path, IMREAD_ANYDEPTH) gives the reference. Raises
    FileNotFoundError when it does not decode."""
    from thermal3d_torch import native

    decoded = native.decode_png(path) if path.lower().endswith(".png") else None
    if decoded is None:
        raise FileNotFoundError(f"could not read IR image: {path}")
    samples, depth = decoded
    img = samples[..., 0] if samples.shape[-1] == 1 else samples.mean(axis=-1)
    return img.astype(np.uint16 if depth == 16 else np.uint8)


def visualize_ir(thermal_raw, save_path: Optional[str] = None):
    """Raw IR display: jet over the fixed 21800..23700 window, with a
    colorbar (visualize.py:577-596)."""
    return _finish(_row([mapped(np.asarray(thermal_raw), "jet", FREIBURG_RAW_MIN,
                                FREIBURG_VIZ_MAX, bar=True)]), save_path)


def remove_black_borders(img: np.ndarray, threshold: float = 100.0) -> np.ndarray:
    """Crop an IR frame to the bounding box of the pixels above `threshold`
    (dead sensor borders read ~0 raw counts; visualize.py:250-264); the input
    unchanged when none is above it."""
    img = np.asarray(img)
    non_black = img > threshold
    rows, cols = np.any(non_black, axis=1), np.any(non_black, axis=0)
    if not rows.any() or not cols.any():
        return img
    r, c = np.where(rows)[0], np.where(cols)[0]
    return img[r[0]:r[-1] + 1, c[0]:c[-1] + 1]


def colorize_ir(ir, min_val: float = FREIBURG_RAW_MIN,
                max_val: float = FREIBURG_VIZ_MAX) -> np.ndarray:
    """IR raw counts (an array, or a PNG's path) → jet RGB uint8 over the
    fixed display window (visualize.py:347-378)."""
    if isinstance(ir, str):
        ir = read_ir(ir)
    t = np.clip((np.asarray(ir, np.float32) - min_val) / max(max_val - min_val, 1e-6), 0, 1)
    return (colormap_float(t, "jet") * 255).astype(np.uint8)


def visualize_ir_standalone(ir, min_val: float = FREIBURG_RAW_MIN,
                            max_val: float = FREIBURG_VIZ_MAX,
                            save_path: Optional[str] = None) -> np.ndarray:
    """The colorized IR, and with save_path the panel original (gray,
    autoscaled) | colorized (visualize.py:347-378). Returns the colorized
    RGB uint8 array."""
    if isinstance(ir, str):
        ir = read_ir(ir)
    ir = np.asarray(ir)
    colored = colorize_ir(ir, min_val, max_val)
    if save_path:
        _finish(_row([mapped(ir, "gray"), [colored]]), save_path)
    return colored


def visualize_enhanced_thermal(thermal_path: str, img_size=(224, 224),
                               min_val: Optional[float] = None,
                               max_val: Optional[float] = None, cmap: str = "jet",
                               save_path: Optional[str] = None, device=None) -> np.ndarray:
    """The model's view of a thermal frame beside its raw jet display
    (visualize.py:236-345): read → crop the black borders → scale to [0, 1]
    (/65535 for 16-bit) → resize to (img_size[1], img_size[0]) rows ×
    columns (cv2.resize's (width, height) order, as the reference passes it)
    → the engine's enhance_thermal_contrast on `device` (the card unless
    'cpu': K1 there) → luma → the 2/98-percentile display window → `cmap`.
    Returns the enhanced [H, W, 3] float32 array (the model input)."""
    import torch

    from thermal3d_torch.core.device import resolve_device
    from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast
    from thermal3d_torch.preprocess.resize import resize_bilinear_hw

    raw = read_ir(thermal_path)
    cropped = remove_black_borders(raw)
    scale = 65535.0 if cropped.dtype == np.uint16 else 255.0
    img = torch.from_numpy(cropped.astype(np.float32) / scale).to(resolve_device(device))
    img = resize_bilinear_hw(img, (int(img_size[1]), int(img_size[0])))
    enhanced = enhance_thermal_contrast(img[..., None].expand(*img.shape, 3))
    enhanced = enhanced.contiguous().cpu().numpy()
    viz = 0.299 * enhanced[..., 0] + 0.587 * enhanced[..., 1] + 0.114 * enhanced[..., 2]
    if min_val is None or max_val is None:
        min_val, max_val = np.percentile(viz, (2, 98))
    viz = np.clip((viz - min_val) / (max_val - min_val + 1e-6), 0, 1)
    if save_path:
        _finish(_row([[colorize_ir(raw)], mapped(viz, cmap)]), save_path)
    return enhanced


def overlay_rgb_thermal(rgb: np.ndarray, thermal: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """RGB / thermal blend (visualize.py:608-618): the thermal frame
    min/max-normalised through jet, mixed with the RGB frame by alpha.
    Returns [H, W, 3] float."""
    rgb = np.clip(_to_hwc(rgb), 0, 1)
    t = np.asarray(thermal, dtype=np.float32)
    if t.ndim == 3:
        t = t.mean(axis=-1)
    t = (t - t.min()) / (t.max() - t.min() + 1e-6)
    return (1 - alpha) * rgb + alpha * colormap_float(t, "jet")


# ---------------------------------------------------------------------------
# 3-D panels (thermal3d/viz/panels.py:277-459)
# ---------------------------------------------------------------------------

RED, BLACK = (255, 0, 0), (0, 0, 0)
TILE_BAR_HEIGHT = 288  # a 3-D tile's colorbar: shrink=0.6 of the 480-pixel tile
AXIS_COLORS = ((255, 0, 0), (0, 128, 0), (0, 0, 255))  # matplotlib's 'r', 'g', 'b'


def valid_points(pointmap, subsample: int = 1) -> np.ndarray:
    """The finite points of an [H, W, 3] pointmap with z > 0, every
    `subsample`-th row and column, as [N, 3]."""
    pts = np.asarray(pointmap)[::subsample, ::subsample].reshape(-1, 3)
    return pts[np.isfinite(pts).all(axis=1) & (pts[:, 2] > 0)]


def camera_segments(pose2=None, size: float = 0.1):
    """plot_cameras' lines (visualize.py:420-460) as (p0, p1, colour, dash):
    camera 1's x, y, z axes at the origin, and with pose2 (4×4, camera 2
    in camera 1's frame) camera 2's axes at its translation and a dashed
    black line between the two."""
    origin = np.zeros(3)
    segs = [(origin, vec, c, None) for vec, c in zip(np.eye(3) * size, AXIS_COLORS)]
    if pose2 is not None:
        pose2 = np.asarray(pose2)
        rot, t = pose2[:3, :3], pose2[:3, 3]
        segs += [(t, t + rot @ (np.eye(3)[k] * size), c, None)
                 for k, c in zip(range(3), AXIS_COLORS)]
        segs.append((origin, t, BLACK, (6.0, 4.0)))
    return segs


def depth_colors(pts: np.ndarray, name: str) -> np.ndarray:
    """The points' z through colormap `name`, min..max (a flat set maps to
    the first entry)."""
    depths = pts[:, 2]
    cmin, cmax = (depths.min(), depths.max()) if len(depths) else (0.0, 1.0)
    denom = (cmax - cmin) if cmax > cmin else 1.0
    return colormap_rgb((depths - cmin) / denom, name, 0.0, 1.0)


def plot_cameras(view: View, segments) -> None:
    """Draw camera_segments' lines into a 3-D view."""
    for p0, p1, color, dash in segments:
        view.line(p0, p1, color, dash=dash)


def _cloud_tile(clouds, segments=()) -> np.ndarray:
    """A 3-D tile of [(points, colours)] and camera lines; the limits hold
    every point and line end."""
    ends = [np.array([p0, p1]) for p0, p1, _, _ in segments]
    sets = [pts for pts, _ in clouds if len(pts)] + ends
    view = View(limits(*sets) if sets else ((0, 1), (0, 1), (0, 1)))
    for pts, colors in clouds:
        view.scatter(pts, colors)
    plot_cameras(view, segments)
    return view.image


def plot_point_cloud(pointmap, color_img=None, pose=None, subsample: int = 4,
                     save_path: Optional[str] = None):
    """A pointmap's 3-D scatter (visualize.py:396-461): coloured by color_img
    or by depth through plasma with a colorbar, and with a pose both
    cameras' axes at a size of 0.15 × the median depth."""
    pts = valid_points(pointmap, subsample)
    if color_img is not None:
        sub = np.clip(_to_hwc(color_img), 0, 1)[::subsample, ::subsample].reshape(-1, 3)
        full = np.asarray(pointmap)[::subsample, ::subsample].reshape(-1, 3)
        keep = np.isfinite(full).all(axis=1) & (full[:, 2] > 0)
        colors = (sub[keep] * 255).astype(np.uint8)
    else:
        colors = colormap_rgb(pts[:, 2], "plasma") if len(pts) else np.zeros((0, 3), np.uint8)
    segments = ()
    if pose is not None:
        size = float(np.percentile(pts[:, 2], 50)) * 0.15 if len(pts) else 1.0
        segments = camera_segments(np.asarray(pose), size)
    groups = [[_cloud_tile([(pts, colors)], segments)]]
    if color_img is None and len(pts):
        lo, hi = autoscale(pts[:, 2])
        groups[0] += [np.full((TILE_BAR_HEIGHT, BAR_GAP, 3), WHITE, np.uint8),
                      colorbar("plasma", TILE_BAR_HEIGHT, lo, hi)]
    return _finish(_row(groups), save_path)


def _pair_rows(rgb1, depth1, rgb2, depth2):
    """The 2×3 pair panels' first two columns: RGB | depth (plasma, a
    colorbar) for each view."""
    return [[[rgb_tile(rgb)], mapped(np.asarray(d), "plasma", bar=True)]
            for rgb, d in ((rgb1, depth1), (rgb2, depth2))]


def visualize_pair_full(rgb1, depth1, pointmap1, rgb2, depth2, pointmap2, pose=None,
                        intrinsics=None, title: str = "Pair Visualization",
                        camera_size: float = 100.0, save_path: Optional[str] = None):
    """The full pair panel (visualize.py:463-541): RGB 1 | depth 1 | one 3-D
    view of both pointmaps (view 1 by depth through viridis, view 2 red)
    with both cameras' axes and their link; RGB 2 | depth 2 below. Prints
    the intrinsics and the pose as the reference does; the title is text,
    not drawn."""
    del title
    if intrinsics is not None:
        print("Intrinsics:\n", np.asarray(intrinsics))
    if pose is not None:
        print("Relative Pose:\n", np.asarray(pose))
    p1, p2 = valid_points(pointmap1), valid_points(pointmap2)
    cloud = _cloud_tile([(p1, depth_colors(p1, "viridis")), (p2, RED)],
                        camera_segments(pose, camera_size))
    top, bottom = _pair_rows(rgb1, depth1, rgb2, depth2)
    return _finish(_grid([_row(top + [[cloud]]), _row(bottom)]), save_path)


def visualize_pair_merged_full(rgb1, depth1, pointmap1, rgb2, depth2, pointmap2,
                               title: str = "Pair Visualization",
                               save_path: Optional[str] = None):
    """The merged pair panel (visualize.py:725-818): a row a view, RGB |
    depth | its own pointmap in 3-D by depth through viridis."""
    del title
    rows = []
    for row, pm in zip(_pair_rows(rgb1, depth1, rgb2, depth2), (pointmap1, pointmap2)):
        pts = valid_points(pm)
        rows.append(_row(row + [[_cloud_tile([(pts, depth_colors(pts, "viridis"))])]]))
    return _finish(_grid(rows), save_path)


def visualize_pair_from_dir(pseudo_gt_dir: str, pair_name: str, rgb1=None, rgb2=None,
                            merged: bool = False, save_path: Optional[str] = None):
    """The pair panels from the pseudo-GT writer's directories
    (pseudo_gt.py:519-592): pointmap1/2, poses and intrinsics npys by pair
    name (a pointmap file may carry a prefix before the name); the depths
    are the pointmaps' z; without RGB frames each view shows its depth in
    gray."""
    def load(sub, name):
        p = os.path.join(pseudo_gt_dir, sub, name + ".npy")
        if not os.path.exists(p):
            hits = sorted(glob.glob(os.path.join(pseudo_gt_dir, sub, f"*{name}.npy")))
            if not hits:
                raise FileNotFoundError(p)
            p = hits[0]
        return np.load(p)

    pm1, pm2 = load("pointmap1", pair_name), load("pointmap2", pair_name)
    d1, d2 = pm1[..., 2], pm2[..., 2]
    pose, intr = load("poses", pair_name), load("intrinsics", pair_name)

    def gray(d):
        span = float(np.ptp(d)) + 1e-6
        return np.repeat(((d - d.min()) / span)[..., None], 3, -1)

    rgb1 = gray(d1) if rgb1 is None else rgb1
    rgb2 = gray(d2) if rgb2 is None else rgb2
    if merged:
        return visualize_pair_merged_full(rgb1, d1, pm1, rgb2, d2, pm2, title=pair_name,
                                          save_path=save_path)
    return visualize_pair_full(rgb1, d1, pm1, rgb2, d2, pm2, pose=pose, intrinsics=intr,
                               title=pair_name, save_path=save_path)
