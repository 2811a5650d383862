"""The controls: the program's own int8 trunk (a bfloat16 configuration's
next precision down; the serving cell's control), the reference with its
products in float8 (the pseudo-GT cell's, whose bfloat16 DPT heads bury the
int8 trunk's error), and, for the geometry stage, the reference geometry in
bfloat16 in the program's place. At a tiny size on the CPU each reads worse
than the sound program; on the card, at the cells' own sizes, each fails a
limit of its cell on three seeds while the sound program passes them all."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import REPO, build_tiny_root, workload


def readings(root, spec, cell, seed, variant, device="cpu", seconds=0.3):
    out: dict = {}
    result = run_cell(root, spec, cell, seed, seconds, False, device, variant=variant,
                      log=lambda *a, **k: None, start=time.perf_counter(), readings_out=out)
    return out, result


@pytest.fixture
def bf16_root(tmp_path):
    return tmp_path, build_tiny_root(tmp_path, dtype="bfloat16")


@pytest.mark.parametrize("path, number, variant", [
    ("serve", "depth_rel_rms", "int8"), ("serve", "depth_rel_rms", "fp8"),
    ("pseudo_gt", "pointmap_rel_rms", "fp8"), ("pseudo_gt", "depth_rel_rms", "fp8")])
def test_lower_precision_reads_worse_than_the_sound_program(bf16_root, path, number, variant):
    root, spec = bf16_root
    cell = workload(spec, path)
    sound = readings(root, spec, cell, 21, None)[0][number]
    control = readings(root, spec, cell, 21, variant)[0][number]
    assert control > 1.5 * sound, (sound, control)


def test_bf16_geometry_reads_worse_than_the_program(bf16_root, monkeypatch):
    """On tiny random weights no pixel has Z > 0, so the pointmaps are
    stretched into valid ones for this test: the geometry then has points."""
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    root, spec = bf16_root
    cell = workload(spec, "pseudo_gt")
    step = PseudoGTGenerator._step

    def valid_points(self, *args):
        out = step(self, *args)
        z = torch.tensor([0.0, 0.0, 1.0])
        pm1 = out["pointmap1"] * (1 - 2 * z) + out["pointmap1"].abs() * z + 0.5 * z
        pm2 = out["pointmap2"] * (1 - 2 * z) + out["pointmap2"].abs() * z + 0.5 * z
        return PseudoGTGenerator._geometry({"pts3d": pm1, "conf": out["confidence1"]},
                                           {"pts3d_in_other_view": pm2,
                                            "conf": out["confidence2"]})

    monkeypatch.setattr(PseudoGTGenerator, "_step", valid_points)
    sound = readings(root, spec, cell, 22, None)[0]
    control = readings(root, spec, cell, 22, "geometry_bf16")[0]
    assert sound["geometry_err"] < 1e-5 and control["geometry_err"] > 1e-4


@pytest.mark.card
@pytest.mark.parametrize("cell_name, variant", [("dustr224-stream-b128", "int8"),
                                                ("mastr512-pgt-b8", "fp8"),
                                                ("mastr512-pgt-b8", "geometry_bf16")])
def test_controls_fail_their_limits_at_the_cells_size(cell_name, variant):
    if not torch.cuda.is_available():
        pytest.skip("the controls at the cells' own sizes run on the card")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == cell_name)
    for seed in (101, 102, 103):
        sound = readings(REPO, spec, cell, seed, None, "cuda:0", 2.0)[1]
        control = readings(REPO, spec, cell, seed, variant, "cuda:0", 2.0)[1]
        assert sound["correct"] and not control["correct"], (seed, sound["checks"],
                                                              control["checks"])
