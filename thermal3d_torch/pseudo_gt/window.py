"""Pseudo-GT of whole windows of a drive with a frozen VGGT-1B: each window of
N consecutive RGB frames goes through the model in one pass, whose global
blocks attend over the whole window, to every frame's depth, world points
(in the window's first camera), their confidences and its camera.

    gen = WindowGenerator(VGGT_1B, params_dtype="bfloat16")
    out = gen.run_window(frames)   # [N, 518, 518, 3] in [0, 1] → numpy dict

Nothing in a window reads a result back to the host, so with the frames
already on the device (data.pipeline.PinnedStage) run_window_async returns
once the window's work is queued. generate_window_pseudo_gt runs it over
the RGB frames of each drive on disk: the port's PNG decoder (resize to the
model size), pipelined windows, and one npy file an output and frame.
"""

from __future__ import annotations

import os
from itertools import groupby
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import VGGT_1B, VGGTConfig
from thermal3d_torch.core.device import resolve_device, to_device
from thermal3d_torch.core.profiling import NEW_REQUEST, annotate
from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage, pipelined_batches
from thermal3d_torch.models.vggt import frozen_vggt
from thermal3d_torch.native import load_rgb_batch
from thermal3d_torch.preprocess.io import require_png

OUTPUTS = ("depth", "depth_conf", "world_points", "world_points_conf", "pose_enc")


class WindowGenerator:
    """Holds the frozen model on one device and turns windows of frames into
    the arrays of OUTPUTS.

    state_dict: the published checkpoint's weights without the track head's;
    None makes seeded random weights (`seed`). frames: the window length of
    generate_window_pseudo_gt (a window of any length runs). params_dtype:
    'bfloat16' stores the weights in bf16; None keeps float32. device: None
    means CUDA (raises without it)."""

    def __init__(self, config: VGGTConfig = VGGT_1B,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, frames: int = 24,
                 params_dtype: Optional[str] = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.config = config
        self.frames = frames
        self.model = frozen_vggt(config, self.device, state_dict, seed, params_dtype)

    def run_window_async(self, frames) -> Dict[str, torch.Tensor]:
        """frames: [N, H, W, 3] in [0, 1] (numpy, or a float32 tensor on the
        generator's device) → {depth [N, H, W], depth_conf, world_points
        [N, H, W, 3], world_points_conf, pose_enc [N, 9]} on the device,
        float32, without waiting for them."""
        size = self.config.img_size
        if len(frames.shape) != 4 or frames.shape[0] == 0 or \
                tuple(frames.shape[1:]) != (size, size, 3):
            raise ValueError(f"run_window: want a non-empty [N, {size}, {size}, 3] window, "
                             f"got {tuple(frames.shape)}")
        with annotate("vggt.request", request=NEW_REQUEST):
            with torch.inference_mode():
                return self.model(to_device(frames, self.device))

    def run_window(self, frames) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.run_window_async(frames).items()}


def frame_windows(frames: List[Dict[str, str]], window: int) -> List[List[Dict[str, str]]]:
    """The frames of each drive (entries of data.freiburg.build_rgb_thermal_index,
    in order) cut into windows of `window` consecutive frames; a drive's
    last window may be shorter. A window never spans two drives."""
    out = []
    for _, drive in groupby(frames, key=lambda f: (f.get("sequence"), f.get("drive"))):
        drive = list(drive)
        out += [drive[i:i + window] for i in range(0, len(drive), window)]
    return out


def generate_window_pseudo_gt(frames: List[Dict[str, str]], output_dir: str,
                              generator: Optional[WindowGenerator] = None,
                              max_frames: Optional[int] = None) -> int:
    """frames: entries of data.freiburg.build_rgb_thermal_index. Writes, per
    frame, output_dir/{depth,depth_conf,world_points,world_points_conf,
    pose_enc}/{name}.npy (name: the RGB file's base name). A drive's frames
    run in windows of generator.frames (its last window may be shorter: it
    runs at its own length, as padding would change what the global blocks
    see), and a frame that fails to decode is left out of its window.
    Pipelined as generate_pseudo_gt. Returns the number of frames written."""
    if generator is None:
        generator = WindowGenerator()
    for d in OUTPUTS:
        os.makedirs(os.path.join(output_dir, d), exist_ok=True)
    if max_frames is not None:
        frames = frames[:max_frames]
    size = generator.config.img_size
    stage, fetch = PinnedStage(generator.device), PinnedFetch(generator.device)
    n_written = 0

    def decode(window):
        paths = [f["rgb"] for f in window]
        require_png(*paths)
        rgb, ok = load_rgb_batch(paths, (size, size))
        return rgb[ok], [f for f, k in zip(window, ok) if k]

    def dispatch(decoded):
        rgb, kept = decoded
        if not kept:
            return None
        x = stage.put({"frames": rgb})["frames"]
        return fetch.start(generator.run_window_async(x)), kept

    def write(token):
        nonlocal n_written
        started, kept = token
        out = fetch.finish(started, len(kept))
        for j, fr in enumerate(kept):
            name = os.path.splitext(os.path.basename(fr["rgb"]))[0]
            for d in OUTPUTS:
                np.save(os.path.join(output_dir, d, f"{name}.npy"), out[d][j])
            n_written += 1

    pipelined_batches(frame_windows(frames, generator.frames), decode, dispatch, write)
    return n_written
