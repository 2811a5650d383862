"""Freiburg Thermal dataset indexing and sample loading (counterpart of
thermal3d/data/freiburg.py).

The reference's directory walk and path rules, unchanged:
train/<seq>/<drive>/fl_ir_aligned/*.png, the fl_ir_aligned → fl_rgb
substitution, temporal pairs with frame_skip, the pseudo-GT glob matching,
and eager validation that drops incomplete pairs up front.

Samples are float32 numpy; the frames ship as resized raw counts and the
percentile enhancement runs on the device inside the train step. The port
has one decoder (thermal3d_torch.native), which decodes and resizes in one
call: `FreiburgPairDataset.get_batch` is bit-equal to the JAX one (same
decoder arithmetic), and `__getitem__`, where the JAX dataset resizes
full-size frames with cv2, differs from it by the two resizes' rounding
(held to 1e-3 relative of the raw counts in the tests).
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from thermal3d_torch.native import load_rgb_batch
from thermal3d_torch.preprocess.io import decode_thermal_batch, require_png


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


class FreiburgRGBThermalDataset:
    """Per-frame RGB + thermal dataset: RGB↔thermal matched per frame, with
    the FLAT pseudo-GT layout (depth/, intrinsics/, poses/ by the frame's
    base name) attached when use_pseudo_gt."""

    def __init__(self, root_dir: str, sequences=None, img_size=(224, 224),
                 use_pseudo_gt: bool = False, pseudo_gt_dir: Optional[str] = None):
        self.img_size = tuple(img_size)
        self.pseudo_gt_dir = pseudo_gt_dir if use_pseudo_gt else None
        self.pairs = build_rgb_thermal_index(root_dir, sequences)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        pair = self.pairs[idx]
        require_png(pair["rgb"], pair["thermal"])
        rgb, ok_rgb = load_rgb_batch([pair["rgb"]], self.img_size)
        thermal, ok_t = decode_thermal_batch([pair["thermal"]], self.img_size)
        if not (ok_rgb[0] and ok_t[0]):
            return None
        sample: Dict[str, np.ndarray] = {
            "rgb": rgb[0].astype(np.float32),
            "thermal": np.repeat(thermal[0][..., None], 3, axis=-1).astype(np.float32),
        }
        if self.pseudo_gt_dir:
            base = os.path.splitext(os.path.basename(pair["rgb"]))[0]
            for sub, key in (("depth", "depth"), ("intrinsics", "intrinsics"),
                             ("poses", "pose")):
                p = os.path.join(self.pseudo_gt_dir, sub, f"{base}.npy")
                if os.path.exists(p):
                    sample[key] = np.load(p).astype(np.float32)
        return sample


def create_freiburg_dataloaders(root_dir: str, batch_size: int = 8, img_size=(224, 224),
                                split: float = 0.8, pseudo_gt_dir: Optional[str] = None,
                                day_only: bool = False, night_only: bool = False,
                                seed: int = 0):
    """Loader factory: day/night filter, random 0.8 split, a shuffled train
    loader and an ordered val loader that keeps its last partial batch."""
    from thermal3d_torch.data.pipeline import BatchLoader, split_index

    train_dir = os.path.join(root_dir, "train")
    sequences = day_night_filter(_list_dirs(train_dir), day_only, night_only)
    dataset = FreiburgRGBThermalDataset(
        root_dir, sequences=sequences, img_size=img_size,
        use_pseudo_gt=pseudo_gt_dir is not None, pseudo_gt_dir=pseudo_gt_dir)
    train_idx, val_idx = split_index(len(dataset), 1.0 - split, seed)
    train_loader = BatchLoader(dataset, train_idx, batch_size, shuffle=True, seed=seed)
    val_loader = BatchLoader(dataset, val_idx, batch_size, shuffle=False, drop_last=False)
    return train_loader, val_loader


class FreiburgPairDataset:
    """Thermal pairs with pseudo-GT, numpy samples (all float32):
      thermal1/2     [H, W, 3]  raw-count frames resized (the step enhances)
      pointmap1/2    [Hg, Wg, 3]
      confidence1/2  [Hg, Wg]   (ones when absent)
      pose           [4, 4]     (identity when absent)
    """

    def __init__(self, root_dir: str, sequences=None, img_size=(224, 224),
                 use_pseudo_gt: bool = True, pseudo_gt_dir: Optional[str] = None,
                 frame_skip: int = 1, gt_size: Optional[Tuple[int, int]] = None):
        self.img_size = tuple(img_size)
        self.gt_size = gt_size
        pairs = build_pair_index(root_dir, sequences, frame_skip)
        self.pairs = validate_pair_index(
            pairs, pseudo_gt_dir if use_pseudo_gt else None,
            require_pointmaps=use_pseudo_gt and pseudo_gt_dir is not None)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        samples = self.get_batch([idx])
        return samples[0] if samples else None

    def _attach_gt(self, sample: Dict[str, np.ndarray], pair: Dict) -> None:
        gt = pair.get("gt")
        if not gt:
            return
        pm1 = np.load(gt["pointmap1"]).astype(np.float32)
        sample["pointmap1"] = pm1
        sample["pointmap2"] = np.load(gt["pointmap2"]).astype(np.float32)
        for key in ("confidence1", "confidence2"):
            sample[key] = (np.load(gt[key]).astype(np.float32) if gt.get(key)
                           else np.ones(pm1.shape[:2], dtype=np.float32))
        sample["pose"] = (np.load(gt["pose"]).astype(np.float32) if gt.get("pose")
                          else np.eye(4, dtype=np.float32))

    def debug_loading(self, idx: int = 0) -> Dict:
        """Print which files sample `idx` resolves to, whether each exists,
        and the loaded shapes; return the same as a dict."""
        if not self.pairs:
            print("debug_loading: index is EMPTY (0 validated pairs) — check "
                  "root_dir layout (train/<seq>/<drive>/fl_ir_aligned/*.png) "
                  "and pseudo_gt_dir contents")
            return {"pairs": 0}
        idx = int(idx) % len(self.pairs)
        pair = self.pairs[idx]
        info: Dict = {"idx": idx}
        print(f"Loading sample {idx} of {len(self.pairs)}:")
        for key in ("thermal1", "thermal2", "rgb1", "rgb2"):
            path = pair.get(key)
            if path:
                exists = os.path.exists(path)
                info[key] = {"path": path, "exists": exists}
                print(f"  {key}: {path}  [exists: {exists}]")
        for key, path in (pair.get("gt") or {}).items():
            exists = bool(path) and os.path.exists(path)
            info[f"gt.{key}"] = {"path": path, "exists": exists}
            print(f"  gt.{key}: {path}  [exists: {exists}]")
        sample = self[idx]
        if sample is None:
            print("  -> sample FAILED to load (decode error)")
            info["loaded"] = None
        else:
            shapes = {k: tuple(v.shape) for k, v in sample.items()}
            info["loaded"] = shapes
            print("  -> loaded OK: " + ", ".join(f"{k}{s}" for k, s in shapes.items()))
        return info

    def get_batch(self, idxs) -> List[Dict[str, np.ndarray]]:
        """One decode + resize call for all 2B thermal frames of the batch,
        then the pseudo-GT npy loads on threads. A sample whose frames do not
        both decode is dropped."""
        pairs = [self.pairs[i] for i in idxs]
        paths = [p["thermal1"] for p in pairs] + [p["thermal2"] for p in pairs]
        frames, ok = decode_thermal_batch(paths, self.img_size, normalize=False)
        b = len(pairs)
        samples: List[Dict[str, np.ndarray]] = []
        kept: List[int] = []
        for i in range(b):
            if ok[i] and ok[b + i]:
                samples.append({"thermal1": np.repeat(frames[i][..., None], 3, axis=-1),
                                "thermal2": np.repeat(frames[b + i][..., None], 3, axis=-1)})
                kept.append(i)
        if kept:
            with ThreadPoolExecutor(max_workers=min(8, len(kept))) as ex:
                list(ex.map(lambda si: self._attach_gt(samples[si[0]], pairs[si[1]]),
                            enumerate(kept)))
        return samples
