"""Pseudo-GT labelling through PseudoGTGenerator, as generate_pseudo_gt runs it
without its npy writes.

A request is one step of RGB pairs, two [pairs, size, size, 3] batches in
[0, 1]. They enter by PinnedStage.put, run through
PseudoGTGenerator.run_pairs_async (encoder on both views, dual decoder,
catmlpdpt heads without the local-feature MLP, intrinsics and Umeyama poses
on the device), and all eight outputs leave by PinnedFetch into numpy.

The check runs the float32 reference over each sampled step's pairs and
compares the pointmaps, confidences and depths with it. The geometry is
checked as a stage of its own (`geometry_err`: the worst of the intrinsics'
and the poses' gaps), in float64 on the program's own fetched pointmaps: on
random weights the median focal length and the Umeyama pose of the whole
chain amplify the bfloat16 trunk's rounding into gaps that say nothing of
the geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import generator, smooth
from benchmark.compare import Gaps, nan_max

UNITS = "pairs"
# the traffic's parameters cut to a few small requests, for the CPU tests
TINY = dict(pairs=2, size=64, max_shift=4, pool=3, warmup_requests=2, trace_requests=4,
            checked_requests=2, scene_cells=[3, 3])


def units(traffic) -> int:
    return traffic["pairs"]


def make_pool(traffic, seed: int, device):
    """Two [pool, pairs, size, size, 3] float32 arrays in [0, 1]: view 1 a
    crop of a smooth colour scene with noise, view 2 the same scene's crop
    shifted by up to `max_shift` pixels each way, as consecutive frames are."""
    gen = generator(traffic, seed, device)
    pool, pairs, size, shift = (traffic["pool"], traffic["pairs"], traffic["size"],
                                traffic["max_shift"])
    view1 = np.empty((pool, pairs, size, size, 3), np.float32)
    view2 = np.empty_like(view1)
    for i in range(pool):
        scene = smooth(pairs, 3, traffic["scene_cells"], (size + shift, size + shift), gen,
                       device)
        scene = (scene + traffic["noise"] * torch.randn(scene.shape, generator=gen,
                                                        device=device)).clamp(0.0, 1.0)
        offsets = torch.randint(0, shift + 1, (pairs, 2), generator=gen, device=device).tolist()
        view1[i] = scene[:, :, :size, :size].permute(0, 2, 3, 1).cpu().numpy()
        view2[i] = torch.stack([scene[j, :, dy:dy + size, dx:dx + size]
                                for j, (dy, dx) in enumerate(offsets)]
                               ).permute(0, 2, 3, 1).cpu().numpy()
    return view1, view2


def request(pool, index: int):
    return pool[0][index], pool[1][index]


class Program:
    """The generator with its pinned staging and fetch. variant 'int8' runs
    the trunk GEMMs in int8 (the generator's own lower-precision path)."""

    def __init__(self, cfg, traffic, weights, device, variant=None):
        from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage
        from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator
        from benchmark.program import model_config

        self.generator = PseudoGTGenerator(
            model_config(cfg), state_dict=weights, batch_size=traffic["pairs"],
            params_dtype=cfg["dtype"], device=device, quantize_int8=variant == "int8")
        device = self.generator.device
        self.stage, self.fetch = PinnedStage(device), PinnedFetch(device)
        self.out, self.rows = None, traffic["pairs"]

    def submit(self, pair):
        x = self.stage.put({"rgb1": pair[0], "rgb2": pair[1]})
        return self.fetch.start(self.generator.run_pairs_async(x["rgb1"], x["rgb2"]))

    def finish(self, token):
        """The request's outputs, copied into numpy arrays the client reuses
        (fresh arrays a request would fault their pages in anew each time)."""
        if self.out is None:
            self.out = self.fetch.empty_like(token, self.rows)
        return self.fetch.finish(token, into=self.out)


def focal_gap(k: torch.Tensor, pointmap: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Per image: the distance from the program's fx (and fy) to the nearest
    midpoint of two of the float64 values around the middle of those whose
    median it is, over the larger of |f| and the values' interquartile
    range. A median of random-weight pointmaps can sit where the values are
    sparse, where float32's rounding may swap the middle values for their
    neighbours; a sound median still lies on such a midpoint to float32's
    rounding."""
    from benchmark.reference.geometry import focal_values

    out = []
    for i in range(k.shape[0]):
        worst = 0.0
        for axis, values in enumerate(focal_values(pointmap[i])):
            f = k[i, axis, axis]
            if values.numel() == 0 or torch.isnan(f):
                gap = 0.0 if values.numel() == 0 and torch.isnan(f) else float("inf")
            else:
                s = torch.sort(values).values
                n = s.numel()
                m = (n - 1) // 2
                near = s[max(0, m - window):m + window + 2]
                mids = (near[:, None] + near[None, :]) * 0.5
                spread = (s[(3 * n) // 4] - s[n // 4]).abs()
                scale = torch.maximum(f.abs(), spread).clamp(min=1e-30)
                gap = float((mids - f).abs().min() / scale)
            worst = nan_max(worst, gap)
        out.append(worst)
    return torch.tensor(out, dtype=torch.float64, device=k.device)


def check(cfg, traffic, params, samples, pool, device, variant=None, block: int = 4):
    """samples: [(pool index, the step's fetched outputs)] → readings.
    Controls: variant 'fp8' puts the reference with its products' operands
    in float8 (e4m3) in the place of the program's pointmaps, confidences
    and depths; 'geometry_bf16' puts the reference geometry in bfloat16, on
    the program's pointmaps, in the place of its intrinsics and poses."""
    from benchmark.reference.geometry import intrinsics, pose_gap, relative_pose
    from benchmark.reference.model import forward

    gaps = Gaps()
    worst = {"geometry_err": 0.0}

    def note(name, values):
        worst[name] = nan_max(worst[name], float(values.max()))

    for index, out in samples:
        for b in range(0, traffic["pairs"], block):
            rows = slice(b, b + block)
            x1 = torch.from_numpy(pool[0][index][rows]).to(device)
            x2 = torch.from_numpy(pool[1][index][rows]).to(device)
            got = {k: torch.from_numpy(v[rows]).to(device) for k, v in out.items()}
            model_out = got
            if variant == "fp8":
                q1, q2 = forward(params, cfg, x1, x2, gemm_dtype=torch.float8_e4m3fn)
                model_out = {"pointmap1": q1["pts3d"], "pointmap2": q2["pts3d_in_other_view"],
                             "confidence1": q1["conf"], "confidence2": q2["conf"],
                             "depth1": q1["pts3d"][..., 2],
                             "depth2": q2["pts3d_in_other_view"][..., 2]}
            p1, p2 = forward(params, cfg, x1, x2)
            ref = {"pointmap1": p1["pts3d"], "pointmap2": p2["pts3d_in_other_view"],
                   "confidence1": p1["conf"], "confidence2": p2["conf"]}
            for view in ("1", "2"):
                gaps.add("pointmap", model_out["pointmap" + view], ref["pointmap" + view])
                gaps.add("depth", model_out["depth" + view], ref["pointmap" + view][..., 2])
                # conf = 1 + exp(c) never falls below 1: compared above that
                # floor, which would dilute the gaps of unconfident pixels
                gaps.add("confidence", model_out["confidence" + view] - 1.0,
                         ref["confidence" + view] - 1.0)
            del p1, p2, ref, model_out
            # the geometry stage, on the program's own fetched pointmaps
            pm1, pm2 = got["pointmap1"], got["pointmap2"]
            if variant == "geometry_bf16":
                got["intrinsics"] = intrinsics(pm1, torch.bfloat16)
                got["poses"] = relative_pose(pm1, pm2, torch.bfloat16)
            note("geometry_err", torch.maximum(focal_gap(got["intrinsics"].double(), pm1),
                                               pose_gap(got["poses"], pm1, pm2)))
    return {**gaps.readings(), **worst}
