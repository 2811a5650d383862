"""Freiburg Thermal dataset indexing (the index half of
thermal3d/data/freiburg.py; the datasets come with the training slice).

The reference's directory walk and path rules, unchanged:
train/<seq>/<drive>/fl_ir_aligned/*.png, the fl_ir_aligned → fl_rgb
substitution, temporal pairs with frame_skip, the pseudo-GT glob matching,
and eager validation that drops incomplete pairs up front.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence


def _list_dirs(path: str) -> List[str]:
    return sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))


def day_night_filter(sequences: Sequence[str], day_only: bool = False,
                     night_only: bool = False) -> List[str]:
    """'day'/'night' substring filtering (freiburg_dataset.py:178-183)."""
    if day_only:
        return [s for s in sequences if "day" in s]
    if night_only:
        return [s for s in sequences if "night" in s]
    return list(sequences)


def build_pair_index(root_dir: str, sequences: Optional[Sequence[str]] = None,
                     frame_skip: int = 1) -> List[Dict[str, str]]:
    """Thermal temporal-pair index (dataset_loader.py:36-93)."""
    train_dir = os.path.join(root_dir, "train")
    if sequences is None:
        sequences = _list_dirs(train_dir)
    pairs = []
    for seq_name in sequences:
        seq_dir = os.path.join(train_dir, seq_name)
        if not os.path.isdir(seq_dir):
            continue
        for drive in _list_dirs(seq_dir):
            thermal_dir = os.path.join(seq_dir, drive, "fl_ir_aligned")
            if not os.path.isdir(thermal_dir):
                continue
            thermal_files = sorted(glob.glob(os.path.join(thermal_dir, "*.png")))
            for i in range(len(thermal_files) - frame_skip):
                t1, t2 = thermal_files[i], thermal_files[i + frame_skip]
                r1 = t1.replace("fl_ir_aligned", "fl_rgb").replace("fl_ir_aligned_", "fl_rgb_")
                r2 = t2.replace("fl_ir_aligned", "fl_rgb").replace("fl_ir_aligned_", "fl_rgb_")
                if os.path.exists(r1) and os.path.exists(r2):
                    pairs.append({
                        "thermal1": t1, "thermal2": t2, "rgb1": r1, "rgb2": r2,
                        "sequence": seq_name, "drive": drive,
                    })
    return pairs


def build_rgb_thermal_index(root_dir: str, sequences: Optional[Sequence[str]] = None
                            ) -> List[Dict[str, str]]:
    """Per-frame RGB↔thermal matching (freiburg_dataset.py:37-96): match by
    index when counts agree, else by leading-token filename key."""
    train_dir = os.path.join(root_dir, "train")
    if sequences is None:
        sequences = _list_dirs(train_dir)
    pairs = []
    for seq_name in sequences:
        seq_dir = os.path.join(train_dir, seq_name)
        if not os.path.isdir(seq_dir):
            continue
        for drive in _list_dirs(seq_dir):
            drive_path = os.path.join(seq_dir, drive)
            rgb_files = sorted(glob.glob(os.path.join(drive_path, "fl_rgb", "*.png")))
            thermal_files = sorted(glob.glob(os.path.join(drive_path, "fl_ir_aligned", "*.png")))
            if not rgb_files or not thermal_files:
                for subdir in _list_dirs(drive_path):
                    sp = os.path.join(drive_path, subdir)
                    rgb_files.extend(sorted(glob.glob(os.path.join(sp, "*rgb*.png"))))
                    thermal_files.extend(sorted(glob.glob(os.path.join(sp, "*ir*.png"))))
            if len(rgb_files) == len(thermal_files):
                for r, t in zip(rgb_files, thermal_files):
                    pairs.append({"rgb": r, "thermal": t, "sequence": seq_name, "drive": drive})
            else:
                rb = {os.path.splitext(os.path.basename(f))[0].split("_")[0]: f for f in rgb_files}
                tb = {os.path.splitext(os.path.basename(f))[0].split("_")[0]: f
                      for f in thermal_files}
                for key in sorted(set(rb) & set(tb)):
                    pairs.append({"rgb": rb[key], "thermal": tb[key],
                                  "sequence": seq_name, "drive": drive})
    return pairs


def build_rgb_pair_index(root_dir: str, sequences: Optional[Sequence[str]] = None,
                         frame_skip: int = 5) -> List[Dict[str, str]]:
    """RGB temporal pairs for pseudo-GT generation (pseudo_gt.py:379-470),
    including the sequence auto-discovery heuristics and the requirement that
    corresponding thermal frames exist."""
    train_dir = os.path.join(root_dir, "train")
    if not os.path.isdir(train_dir):
        train_dir = root_dir
    if sequences is None:
        sequences = []
        for item in sorted(os.listdir(train_dir)):
            item_path = os.path.join(train_dir, item)
            if os.path.isdir(item_path) and (
                "seq" in item.lower()
                or os.path.exists(os.path.join(item_path, "fl_rgb"))
                or any("rgb" in f.lower() for f in os.listdir(item_path)
                       if os.path.isfile(os.path.join(item_path, f)))
            ):
                sequences.append(item)
    pairs = []
    for seq_name in sequences:
        seq_dir = os.path.join(train_dir, seq_name)
        if not os.path.isdir(seq_dir):
            continue
        for drive in _list_dirs(seq_dir):
            drive_path = os.path.join(seq_dir, drive)
            rgb_dir = os.path.join(drive_path, "fl_rgb")
            if os.path.isdir(rgb_dir):
                rgb_files = sorted(glob.glob(os.path.join(rgb_dir, "*.png")))
            else:
                rgb_files = []
                for subdir in _list_dirs(drive_path):
                    rgb_files.extend(
                        sorted(glob.glob(os.path.join(drive_path, subdir, "*rgb*.png"))))
            for i in range(len(rgb_files) - frame_skip):
                r1, r2 = rgb_files[i], rgb_files[i + frame_skip]
                t1 = r1.replace("fl_rgb", "fl_ir_aligned").replace("rgb", "ir")
                t2 = r2.replace("fl_rgb", "fl_ir_aligned").replace("rgb", "ir")
                if os.path.exists(t1) and os.path.exists(t2):
                    pairs.append({
                        "rgb_path1": r1, "rgb_path2": r2,
                        "thermal_path1": t1, "thermal_path2": t2,
                        "sequence": seq_name, "drive": drive,
                        "frame_idx1": i, "frame_idx2": i + frame_skip,
                    })
    return pairs


def match_pseudo_gt(pair: Dict[str, str], pseudo_gt_dir: str) -> Optional[Dict[str, str]]:
    """Flexible pseudo-GT file matching (dataset_loader.py:143-201):
    glob pointmap1/{rgb1_base}_*.npy, derive pair name and second base name,
    resolve pointmap2/confidence{1,2}/depth{1,2}/poses paths."""
    base1 = os.path.splitext(os.path.basename(pair["rgb1"]))[0]
    matches = glob.glob(os.path.join(pseudo_gt_dir, "pointmap1", f"{base1}_*.npy"))
    if not matches:
        return None
    pointmap1_path = sorted(matches)[0]
    pair_name = os.path.splitext(os.path.basename(pointmap1_path))[0]
    second_idx = pair_name.find("_", pair_name.find(base1) + len(base1))
    second_base = pair_name[second_idx + 1:]

    def p(sub, name):
        path = os.path.join(pseudo_gt_dir, sub, f"{name}.npy")
        return path if os.path.exists(path) else None

    return {
        "pointmap1": pointmap1_path,
        "pointmap2": p("pointmap2", pair_name),
        "confidence1": p("confidence1", pair_name),
        "confidence2": p("confidence2", pair_name),
        "depth1": p("depth1", base1),
        "depth2": p("depth2", second_base),
        "pose": p("poses", pair_name),
    }


def validate_pair_index(pairs: List[Dict[str, str]], pseudo_gt_dir: Optional[str] = None,
                        require_pointmaps: bool = True) -> List[Dict]:
    """Eagerly resolve pseudo-GT paths and drop incomplete pairs — the
    static-shape replacement for runtime None-skipping (SURVEY.md §5)."""
    valid = []
    for pair in pairs:
        entry = dict(pair)
        if pseudo_gt_dir:
            gt = match_pseudo_gt(pair, pseudo_gt_dir)
            if gt is None or (require_pointmaps and
                              (gt["pointmap1"] is None or gt["pointmap2"] is None)):
                continue
            entry["gt"] = gt
        valid.append(entry)
    return valid
