"""Window pseudo-GT through WindowGenerator: a drive's RGB stream labelled in
windows of consecutive frames.

A request is one window, [frames, size, size, 3] float32 in [0, 1]. It
enters by PinnedStage.put, runs through WindowGenerator.run_window_async
(the DINOv2 patch trunk, the frame and global blocks, both DPT heads and the
camera head), and every output (depth, world points, their confidences,
the cameras) leaves by PinnedFetch into numpy.

The check runs the configuration's family's float32 reference over each
sampled window whole and compares depth, world points and the pose
encoding with it; the confidences are read, not compared.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.compare import Gaps
from benchmark.inputs import generator, smooth
from benchmark.modules import family

UNITS = "frames"
# the traffic's parameters cut to a few small requests, for the CPU tests
TINY = dict(frames=3, size=56, max_shift=2, pool=3, warmup_requests=2, trace_requests=2,
            checked_requests=2, scene_cells=[3, 3])
ROOT = Path(__file__).resolve().parents[2]
COMPARED = ("depth", "world_points", "pose_enc")


def units(traffic) -> int:
    return traffic["frames"]


def make_pool(traffic, seed: int, device) -> np.ndarray:
    """[pool, frames, size, size, 3] float32 in [0, 1]: each window the crops
    of one smooth colour scene, each frame's crop shifted from the last by
    up to `max_shift` pixels each way (as consecutive frames of a drive
    are), plus noise."""
    gen = generator(traffic, seed, device)
    pool, frames, size, shift = (traffic["pool"], traffic["frames"], traffic["size"],
                                 traffic["max_shift"])
    span = size + shift * (frames - 1)
    out = np.empty((pool, frames, size, size, 3), np.float32)
    for i in range(pool):
        scene = smooth(1, 3, traffic["scene_cells"], (span, span), gen, device)[0]
        steps = torch.randint(0, shift + 1, (frames - 1, 2), generator=gen, device=device)
        offsets = torch.cat([steps.new_zeros(1, 2), steps.cumsum(0)]).tolist()
        crops = torch.stack([scene[:, dy:dy + size, dx:dx + size] for dy, dx in offsets])
        noise = traffic["noise"] * torch.randn(crops.shape, generator=gen, device=device)
        out[i] = (crops + noise).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
    return out


def request(pool, index: int):
    return pool[index]


def vggt_config(cfg):
    """The configuration file in the program's terms."""
    from thermal3d_torch.core.config import VGGTConfig

    return VGGTConfig(
        img_size=cfg["img_size"], patch_size=cfg["patch_size"], embed_dim=cfg["embed_dim"],
        num_heads=cfg["num_heads"], mlp_ratio=float(cfg["mlp_ratio"]),
        patch_depth=cfg["patch_depth"], num_register_tokens=cfg["num_register_tokens"],
        depth=cfg["depth"], rope_base=float(cfg["rope_freq"]),
        dpt_features=cfg["dpt_features"], dpt_out_channels=tuple(cfg["dpt_out_channels"]),
        dpt_layers=tuple(cfg["dpt_layers"]),
        camera_trunk_depth=cfg["camera_trunk_depth"],
        camera_num_heads=cfg["camera_num_heads"],
        camera_iterations=cfg["camera_iterations"], compute_dtype=cfg["dtype"])


class Program:
    """The window generator with its pinned staging and fetch."""

    def __init__(self, cfg, traffic, weights, device, variant=None):
        from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage
        from thermal3d_torch.pseudo_gt.window import WindowGenerator

        self.generator = WindowGenerator(vggt_config(cfg), state_dict=weights,
                                         frames=traffic["frames"], params_dtype=cfg["dtype"],
                                         device=device)
        device = self.generator.device
        self.stage, self.fetch = PinnedStage(device), PinnedFetch(device)
        self.out, self.rows = None, traffic["frames"]

    def submit(self, window):
        x = self.stage.put({"frames": window})["frames"]
        return self.fetch.start(self.generator.run_window_async(x))

    def finish(self, token):
        """The request's outputs, copied into numpy arrays the client reuses
        (fresh arrays a request would fault their pages in anew each time)."""
        if self.out is None:
            self.out = self.fetch.empty_like(token, self.rows)
        return self.fetch.finish(token, into=self.out)


def check(cfg, traffic, params, samples, pool, device, variant=None):
    """samples: [(pool index, the window's fetched outputs)] → readings.
    Control: variant 'fp8' puts the reference with its products' operands in
    float8 (e4m3) in the place of the program's outputs."""
    forward = family(ROOT, cfg).forward
    gaps = Gaps()
    for index, out in samples:
        frames = torch.from_numpy(pool[index]).to(device)
        got = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
        if variant == "fp8":
            got = forward(params, cfg, frames, gemm_dtype=torch.float8_e4m3fn)
        ref = forward(params, cfg, frames)
        for name in COMPARED:
            gaps.add(name, got[name], ref[name])
        # conf = 1 + exp(c) never falls below 1: read above that floor
        for name in ("depth_conf", "world_points_conf"):
            gaps.add(name, got[name] - 1.0, ref[name] - 1.0)
        del got, ref
    return gaps.readings()
