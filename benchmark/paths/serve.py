"""Chunk serving through InferenceEngine, as a user's upload client runs it.

A request is one chunk of raw 16-bit thermal frames [frames, height, width]
(uint16 counts). It enters the program by PinnedStage.put, runs through
InferenceEngine.infer_async (resize, K1, thermal head, encoder, dual
decoder, linear head), and its outputs (the traffic's "outputs", as
infer_paths(outputs=...) fetches them) leave by PinnedFetch into numpy.

The check runs the float32 reference over each sampled request's own frames
and compares the depth that reached numpy with it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.compare import Gaps
from benchmark.inputs import generator, smooth

UNITS = "frames"
# the traffic's parameters cut to a few small requests, for the CPU tests
TINY = dict(frames=4, height=40, width=48, pool=3, warmup_requests=2, trace_requests=4,
            checked_requests=2, scene_cells=[3, 4])


def units(traffic) -> int:
    return traffic["frames"]


def make_pool(traffic, seed: int, device) -> np.ndarray:
    """[pool, frames, height, width] uint16 raw thermal frames, as the sensor
    writes them: counts in [counts[0], counts[1]], a smooth scene plus
    Gaussian sensor noise of `noise_counts`, rounded."""
    gen = generator(traffic, seed, device)
    shape = (traffic["pool"], traffic["frames"], traffic["height"], traffic["width"])
    lo, hi = traffic["counts"]
    out = np.empty(shape, np.uint16)
    for i in range(shape[0]):
        scene = smooth(shape[1], 1, traffic["scene_cells"], shape[2:], gen, device)[:, 0]
        noise = torch.randn(scene.shape, generator=gen, device=device)
        counts = lo + (hi - lo) * scene + traffic["noise_counts"] * noise
        out[i] = counts.round().clamp(lo, hi).to(torch.int32).cpu().numpy()
    return out


def request(pool, index: int):
    return pool[index]


class Program:
    """The engine with its pinned staging and fetch. variant 'int8' serves
    the trunk GEMMs in int8 (the engine's own lower-precision path)."""

    def __init__(self, cfg, traffic, weights, device, variant=None):
        from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage
        from thermal3d_torch.infer.engine import InferenceEngine
        from benchmark.program import model_config
        from benchmark.weights import thermal_head_state

        # on the CPU (the tests) K1's plain version, not the engine's sort path
        self.engine = InferenceEngine(
            model_config(cfg), state_dict=weights,
            thermal_head_state=thermal_head_state(cfg, device), params_dtype=cfg["dtype"],
            device=device, quantize_int8=variant == "int8",
            enhance_impl="auto" if torch.device(device).type == "cuda" else "plain")
        self.stage, self.fetch = PinnedStage(self.engine.device), PinnedFetch(self.engine.device)
        self.keys = tuple(traffic["outputs"])
        self.out, self.rows = None, traffic["frames"]

    def submit(self, frames: np.ndarray):
        x = self.stage.put({"frames": frames})["frames"]
        out = self.engine.infer_async(x)
        return self.fetch.start({k: out[k] for k in self.keys})

    def finish(self, token):
        """The request's outputs, copied into numpy arrays the client reuses
        (fresh arrays a request would fault their pages in anew each time)."""
        if self.out is None:
            self.out = self.fetch.empty_like(token, self.rows)
        return self.fetch.finish(token, into=self.out)


def check(cfg, traffic, params, samples, pool, device, variant=None, block: int = 16):
    """samples: [(pool index, the request's fetched outputs)] → readings.
    variant 'fp8' is the control: the reference with its products' operands
    in float8 (e4m3) takes the place of the program's outputs."""
    from benchmark.reference.model import forward
    from benchmark.reference.preprocess import serving_input

    head = cfg["thermal_head"]
    gaps = Gaps()
    for index, out in samples:
        frames = torch.from_numpy(pool[index])
        for b in range(0, frames.shape[0], block):
            x = serving_input(frames[b:b + block].to(device), cfg["img_size"],
                              head["edge_weight"], head["temp_scale"])
            ref = forward(params, cfg, x)[0]["pts3d"][..., 2]
            if variant == "fp8":
                got = forward(params, cfg, x, gemm_dtype=torch.float8_e4m3fn)[0]["pts3d"][..., 2]
            else:
                got = torch.from_numpy(out["depth"][b:b + block]).to(device)
            gaps.add("depth", got, ref)
    return gaps.readings()
