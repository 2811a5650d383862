"""Dataset exploration (counterpart of thermal3d/data/exploration.py,
utils/dataset_exploration.py:9-64): directory census, file-extension counts,
and the directories that look like RGB or thermal image directories."""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict


def explore_dataset(root_dir: str, max_depth: int = 4) -> Dict:
    """Walk the tree to `max_depth` and report the number of directories,
    the file-extension counts, and the directories holding PNGs whose name
    says RGB ('rgb') or thermal ('ir', 'thermal')."""
    ext_counts: Counter = Counter()
    rgb_dirs, thermal_dirs = [], []
    n_dirs = 0
    root_depth = root_dir.rstrip(os.sep).count(os.sep)
    for dirpath, dirnames, filenames in os.walk(root_dir):
        depth = dirpath.count(os.sep) - root_depth
        if depth > max_depth:
            dirnames[:] = []
            continue
        n_dirs += 1
        for f in filenames:
            ext_counts[os.path.splitext(f)[1].lower()] += 1
        base = os.path.basename(dirpath).lower()
        has_png = any(f.endswith(".png") for f in filenames)
        if has_png and "rgb" in base:
            rgb_dirs.append(dirpath)
        elif has_png and ("ir" in base or "thermal" in base):
            thermal_dirs.append(dirpath)
    return {
        "n_dirs": n_dirs,
        "extension_counts": dict(ext_counts),
        "rgb_dirs": sorted(rgb_dirs),
        "thermal_dirs": sorted(thermal_dirs),
    }
