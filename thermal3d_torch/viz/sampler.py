"""Dataset sampling and pair displays (counterpart of thermal3d/viz/sampler.py,
utils/visualize.py:463-818), drawn as viz/panels.py draws (tiles on white,
no text):

  visualize_pair:        a thermal pair, and its enhanced versions
  visualize_pair_merged: a pair over its depths (plasma, shared limits)
  sample_dataset:        a grid of random dataset samples
  visualize_dataset:     RGB | IR (jet) | overlay panels across drive folders
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from thermal3d_torch.viz.panels import (WHITE, _depth_limits, _finish, _grid, _row,
                                        _to_hwc, colorize_ir, mapped, overlay_rgb_thermal,
                                        read_ir, rgb_tile, thermal_file_tile)


def _image_tile(img) -> list:
    """imshow of an image: RGB as it is (clipped), a 2-D one in gray,
    autoscaled."""
    arr = _to_hwc(img)
    return [rgb_tile(arr)] if arr.ndim == 3 else mapped(arr, "gray")


def visualize_pair(thermal1, thermal2, enhanced1=None, enhanced2=None,
                   save_path: Optional[str] = None):
    panels = [thermal1, thermal2] + ([] if enhanced1 is None else [enhanced1, enhanced2])
    return _finish(_row([_image_tile(p) for p in panels]), save_path)


def visualize_pair_merged(thermal1, thermal2, depth1=None, depth2=None, pose=None,
                          save_path: Optional[str] = None):
    """The pair, and under it their depths in plasma on shared limits. The
    reference puts ‖t‖ of `pose` in its title (text, not drawn)."""
    del pose
    rows = [_row([_image_tile(thermal1), _image_tile(thermal2)])]
    if depth1 is not None:
        vmin, vmax = _depth_limits(depth1, depth2)
        rows.append(_row([mapped(np.asarray(d), "plasma", vmin, vmax) for d in (depth1, depth2)]))
    return _finish(_grid(rows), save_path)


def sample_dataset(dataset, n: int = 4, seed: int = 0, save_path: Optional[str] = None):
    """A row for each of n random samples (numpy's default_rng(seed), as the
    reference draws them): thermal1 | thermal2, each min/max-normalised,
    and the GT depth (pointmap1's z, plasma) when the sample has one."""
    rng = np.random.default_rng(seed)
    idxs = rng.choice(len(dataset), size=min(n, len(dataset)), replace=False)
    rows = []
    for idx in idxs:
        s = dataset[int(idx)]
        if s is None:
            continue
        groups = []
        for key in ("thermal1", "thermal2"):
            t = _to_hwc(s[key])
            groups.append([rgb_tile((t - t.min()) / (t.max() - t.min() + 1e-6))])
        if "pointmap1" in s:
            groups.append(mapped(np.asarray(s["pointmap1"])[..., 2], "plasma"))
        rows.append(_row(groups))
    if not rows:
        rows = [np.full((1, 1, 3), WHITE, np.uint8)]
    return _finish(_grid(rows), save_path)


def find_drive_folders(base_path: str):
    """(sequence, drive, path) triples under <base>/train/<seq>/<NN>
    (visualize.py:543-557)."""
    train_dir = os.path.join(base_path, "train")
    if not os.path.isdir(train_dir):
        return []
    out = []
    for seq in sorted(os.listdir(train_dir)):
        seq_path = os.path.join(train_dir, seq)
        if not os.path.isdir(seq_path):
            continue
        for sub in sorted(os.listdir(seq_path)):
            drive = os.path.join(seq_path, sub)
            if os.path.isdir(drive):
                out.append((seq, sub, drive))
    return out


def load_images_from_drive(drive_path: str):
    """A drive's RGB and IR frame lists, with the reference's fallbacks:
    *rgb* / *ir*, then *color* / *thermal*, then recursive
    (visualize.py:559-596)."""
    def pair(rgb_pat, ir_pat, recursive=False):
        kw = {"recursive": True} if recursive else {}
        return (sorted(glob.glob(os.path.join(drive_path, rgb_pat), **kw)),
                sorted(glob.glob(os.path.join(drive_path, ir_pat), **kw)))

    for args in (("*rgb*.png", "*ir*.png"), ("*color*.png", "*thermal*.png")):
        rgb, ir = pair(*args)
        if rgb or ir:
            return rgb, ir
    return pair("**/*rgb*.png", "**/*ir*.png", recursive=True)


def visualize_dataset(dataset_path: str, num_samples: int = 5,
                      output_dir: str = "freiburg_samples") -> int:
    """RGB | IR (jet) | overlay panels across the drive folders, at most 3 a
    drive, each sequence at least once (visualize.py:620-694), written as
    `{seq}_{drive}_sample_{i}.png`. Returns the number written."""
    drives = find_drive_folders(dataset_path)
    if not drives:
        print(f"No drive folders found in {dataset_path}")
        return 0
    os.makedirs(output_dir, exist_ok=True)
    seen, count = set(), 0
    for seq, sub, drive in drives:
        if count >= num_samples and seq in seen:
            continue
        seen.add(seq)
        rgb_files, ir_files = load_images_from_drive(drive)
        if not rgb_files or not ir_files:
            continue
        for i in range(min(3, len(rgb_files), len(ir_files))):
            if count >= num_samples:
                break
            rgb = thermal_file_tile(rgb_files[i])
            if rgb is None:
                raise FileNotFoundError(f"could not read RGB image: {rgb_files[i]}")
            ir_raw = read_ir(ir_files[i])
            overlay = overlay_rgb_thermal(rgb.astype(np.float32) / 255.0,
                                          ir_raw.astype(np.float32))
            _finish(_row([[rgb], [colorize_ir(ir_raw)], [rgb_tile(overlay)]]),
                    os.path.join(output_dir, f"{seq}_{sub}_sample_{i}.png"))
            count += 1
    return count
