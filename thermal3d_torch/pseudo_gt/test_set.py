"""Test-set pseudo-GT generation (counterpart of thermal3d/pseudo_gt/test_set.py,
scripts/test_pseudo_gt.py:26-171).

Runs MASt3R monocular (view, view) on test RGB frames at the model size and
writes, per frame, under <output>/depth/:
  {name}_depth.npy           float32 depth of view 1
  {name}_thermal_path.txt    path of the corresponding thermal frame
  {name}_depth_vis.png       plasma preview with a colorbar (viz/panels.py)
— the layout of the reference's pseudo_gt_test_set/{day,night}/depth/ fixtures.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage, pipelined_batches
from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator, decode_rgb_pairs, pad_batch
from thermal3d_torch.viz.panels import save_depth_vis


def generate_test_set_pseudo_gt(frames: List[Dict[str, str]], output_dir: str,
                                generator: Optional[PseudoGTGenerator] = None,
                                max_frames: Optional[int] = None) -> int:
    """frames: [{'rgb': path, 'thermal': path}]. Returns frames written.
    Batches are pipelined as in generate_pseudo_gt, and only depth1 is
    fetched."""
    if generator is None:
        generator = PseudoGTGenerator()
    depth_dir = os.path.join(output_dir, "depth")
    os.makedirs(depth_dir, exist_ok=True)
    if max_frames is not None:
        frames = frames[:max_frames]
    bs = generator.batch_size
    hw = generator.config.img_size
    stage, fetch = PinnedStage(generator.device), PinnedFetch(generator.device)
    n = 0

    def dispatch(decoded):
        rgb, _, kept = decoded
        if not kept:
            return None
        stack = stage.put({"rgb": pad_batch(rgb, bs)})["rgb"]
        out = generator.run_pairs_async(stack, stack)  # monocular
        return fetch.start({"depth1": out["depth1"]}), kept

    def write(token):
        nonlocal n
        started, kept = token
        depth = fetch.finish(started, len(kept))["depth1"]
        for j, fr in enumerate(kept):
            name = os.path.splitext(os.path.basename(fr["rgb"]))[0]
            np.save(os.path.join(depth_dir, f"{name}_depth.npy"), depth[j])
            with open(os.path.join(depth_dir, f"{name}_thermal_path.txt"), "w") as f:
                f.write(fr.get("thermal", ""))
            save_depth_vis(depth[j], os.path.join(depth_dir, f"{name}_depth_vis.png"))
            n += 1

    chunks = [frames[i:i + bs] for i in range(0, len(frames), bs)]
    pipelined_batches(chunks, lambda c: decode_rgb_pairs(c, hw, keys=("rgb",)), dispatch, write)
    return n
