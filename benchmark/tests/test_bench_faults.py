"""A whole run of each cell at a tiny size on the CPU (the harness's look for a
card skipped), sound and with the timed path broken underneath: `correct`
must come out true for the sound program and false for each fault a cell can
have. (One card: no exchange between chips; serving: no state a step.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import build_tiny_root, workload

# limits for float32 at the tiny size: the reference and the port agree to
# float32's rounding there (test_bench_reference.py)
TINY_LIMITS = {
    "dustr224-stream-b128": {"depth_rel_rms": 1e-4},
    "mastr512-pgt-b8": {"pointmap_rel_rms": 1e-4, "confidence_rel_rms": 1e-4,
                        "depth_rel_rms": 1e-4, "geometry_err": 1e-5},
}


def run(root, spec, path: str):
    return run_cell(root, spec, workload(spec, path), 2**31 + 3, 0.3, False, "cpu",
                    log=lambda *a, **k: None, start=time.perf_counter())


@pytest.fixture
def root(tmp_path):
    return tmp_path, build_tiny_root(tmp_path, limits=TINY_LIMITS)


def alter_first_row(out, keys):
    out = dict(out)
    for k in keys:
        v = out[k].clone()
        v[0] = v[0] * 1.5 + 0.25
        out[k] = v
    return out


def half_batch_mean(out):
    """Only the first half of the rows computed; the rest their mean."""
    out = dict(out)
    for k, v in out.items():
        half = v.shape[0] // 2
        v = v.clone()
        v[half:] = v[:half].mean(0, keepdim=True)
        out[k] = v
    return out


@pytest.mark.parametrize("path", ["serve", "pseudo_gt"])
def test_sound_program_is_correct(root, path):
    res = run(*root, path)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0


SERVE_FAULTS = {
    "answer altered": lambda out: alter_first_row(out, ["depth"]),
    "half of the batch left out": half_batch_mean,
}
PGT_FAULTS = {
    "depth altered": lambda out: alter_first_row(out, ["depth1"]),
    "pose altered": lambda out: alter_first_row(out, ["poses"]),
    "intrinsics altered": lambda out: alter_first_row(out, ["intrinsics"]),
    "half of the batch left out": half_batch_mean,
}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serving_fault_is_caught(root, monkeypatch, fault):
    from thermal3d_torch.infer.engine import InferenceEngine

    sound = InferenceEngine.infer_async
    monkeypatch.setattr(InferenceEngine, "infer_async",
                        lambda self, *a, **k: SERVE_FAULTS[fault](sound(self, *a, **k)))
    assert not run(*root, "serve")["correct"]


@pytest.mark.parametrize("fault", sorted(PGT_FAULTS))
def test_pseudo_gt_fault_is_caught(root, monkeypatch, fault):
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    sound = PseudoGTGenerator.run_pairs_async
    monkeypatch.setattr(PseudoGTGenerator, "run_pairs_async",
                        lambda self, *a, **k: PGT_FAULTS[fault](sound(self, *a, **k)))
    assert not run(*root, "pseudo_gt")["correct"]


def test_no_sample_is_not_correct(root, monkeypatch):
    """A run whose window checked nothing is not correct."""
    from benchmark import loop

    monkeypatch.setattr(loop.Sampler, "offer", lambda self, index, outputs: None)
    assert not run(*root, "serve")["correct"]


def test_nan_reading_fails(root, monkeypatch):
    from thermal3d_torch.infer.engine import InferenceEngine

    sound = InferenceEngine.infer_async

    def nan_depth(self, *a, **k):
        out = dict(sound(self, *a, **k))
        out["depth"] = torch.full_like(out["depth"], float("nan"))
        return out

    monkeypatch.setattr(InferenceEngine, "infer_async", nan_depth)
    assert not run(*root, "serve")["correct"]
