"""The plain reference against the port on the CPU at a tiny size, on the
benchmark's own seeded weights and inputs: serving depth, and the eight
pseudo-GT outputs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.paths import pseudo_gt as pgt_path
from benchmark.paths import serve as serve_path
from benchmark.reference import geometry, model, preprocess
from benchmark.tests.conftest import REPO, tiny_config, tiny_traffic
from benchmark.weights import make_weights


def config(name: str) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    return tiny_config(cfg, "float32")


def traffic(name: str) -> dict:
    return tiny_traffic(json.loads((REPO / "benchmark" / "traffic" / f"{name}.json").read_text()))


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_serving_depth_matches_the_port(seed):
    cfg, t = config("dustr224_linear"), traffic("thermal-u16-b128")
    pool = serve_path.make_pool(t, seed, "cpu")
    program = serve_path.Program(cfg, t, make_weights(cfg, seed, "cpu"), "cpu")
    out = program.finish(program.submit(pool[1]))
    params = make_weights(cfg, seed, "cpu")
    x = preprocess.serving_input(torch.from_numpy(pool[1]), cfg["img_size"], 0.5, 1.0)
    ref = model.forward(params, cfg, x)[0]["pts3d"][..., 2]
    assert out["depth"].shape == tuple(ref.shape)
    assert float((torch.from_numpy(out["depth"]) - ref).abs().max() / ref.abs().max()) < 1e-4
    readings = serve_path.check(cfg, t, params, [(1, out)], pool, "cpu")
    assert readings["depth_rel_rms"] < 1e-4


def test_pseudo_gt_outputs_match_the_port():
    cfg, t = config("mastr512_catmlpdpt"), traffic("rgb-pairs-b8")
    seed = 7
    view1, view2 = pgt_path.make_pool(t, seed, "cpu")
    program = pgt_path.Program(cfg, t, make_weights(cfg, seed, "cpu"), "cpu")
    out = program.finish(program.submit((view1[0], view2[0])))
    params = make_weights(cfg, seed, "cpu")
    p1, p2 = model.forward(params, cfg, torch.from_numpy(view1[0]), torch.from_numpy(view2[0]))
    ref = {"pointmap1": p1["pts3d"], "pointmap2": p2["pts3d_in_other_view"],
           "confidence1": p1["conf"], "confidence2": p2["conf"],
           "depth1": p1["pts3d"][..., 2], "depth2": p2["pts3d_in_other_view"][..., 2]}
    assert sorted(out) == sorted(list(ref) + ["intrinsics", "poses"])
    for k, r in ref.items():
        assert float((torch.from_numpy(out[k]) - r).abs().max() / r.abs().max()) < 1e-4, k
    readings = pgt_path.check(cfg, t, params, [(0, out)], (view1, view2), "cpu")
    for name in ("pointmap", "confidence", "depth"):
        assert readings[f"{name}_rel_rms"] < 1e-4, (name, readings)
    assert readings["geometry_err"] < 1e-5, readings


def test_geometry_matches_a_planted_pose():
    """Points seen from two cameras a known rigid motion apart: the
    reference's pose recovers it, and its focal lengths the projection's."""
    rng = np.random.default_rng(3)
    h = w = 16
    f = 20.0
    z = rng.uniform(2.0, 5.0, (h, w))
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([(u - w / 2) * z / f, (v - h / 2) * z / f, z], -1)
    angle = 0.1
    r = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                  [0, 0, 1]])
    t = np.array([0.2, -0.1, 0.3])
    pm1 = torch.from_numpy(pts[None])
    pm2 = torch.from_numpy((pts @ r.T + t)[None])
    pose = geometry.relative_pose(pm1, pm2)[0].numpy()
    np.testing.assert_allclose(pose[:3, :3], r, atol=1e-9)
    np.testing.assert_allclose(pose[:3, 3], t, atol=1e-9)
    k = geometry.intrinsics(pm1)[0].numpy()
    # the centre column (row) gives 0/0, which the median leaves out; every
    # other pixel gives f
    assert abs(k[0, 0] - f) < 1e-9 and abs(k[1, 1] - f) < 1e-9
    assert (k[0, 2], k[1, 2], k[2, 2]) == (w / 2, h / 2, 1.0)


def test_grid_percentile_is_the_order_statistic():
    """The smallest grid value whose count reaches the rank, as the
    program's K1 selects it (not an interpolated quantile)."""
    q = torch.tensor([[0.0, 1.0, 1.0, 5.0, 9.0, 9.0, 9.0, 12.0, 30.0, 65535.0]])
    # rank 0.5 of 10 → 0.5: the first value whose count reaches it is 0
    assert float(preprocess.grid_percentile(q, 5.0)) == 0.0
    # rank 4.0: counts 1, 3, 4 → 5
    assert float(preprocess.grid_percentile(q, 40.0)) * 65535.0 == pytest.approx(5.0)
    assert float(preprocess.grid_percentile(q, 98.0)) == 1.0


def test_focal_gap_reads_a_median_as_zero():
    rng = np.random.default_rng(5)
    pm = torch.from_numpy(np.stack([rng.normal(size=(8, 8)), rng.normal(size=(8, 8)),
                                    rng.uniform(0.5, 2.0, (8, 8))], -1)[None])
    k = geometry.intrinsics(pm)
    assert float(pgt_path.focal_gap(k, pm)[0]) == 0.0
    k_off = k.clone()
    k_off[0, 0, 0] += 1e-3  # a median off by bfloat16's rounding
    assert float(pgt_path.focal_gap(k_off, pm)[0]) > 1e-4


def test_pose_gap_reads_the_optimum_as_zero_and_a_turned_pose_not():
    gen = torch.Generator().manual_seed(3)
    pm1 = torch.randn(2, 16, 16, 3, generator=gen, dtype=torch.float64)
    pm2 = torch.randn(2, 16, 16, 3, generator=gen, dtype=torch.float64) + 0.5 * pm1
    pm1[..., 2] = pm1[..., 2].abs() + 1.0
    pm2[..., 2] = pm2[..., 2].abs() + 1.0
    pose = geometry.relative_pose(pm1, pm2)
    assert float(geometry.pose_gap(pose, pm1, pm2).max()) < 1e-12
    c, s = np.cos(1e-3), np.sin(1e-3)
    turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)
    turned = pose.clone()
    turned[:, :3, :3] = turn @ pose[:, :3, :3]
    assert float(geometry.pose_gap(turned, pm1, pm2).min()) > 1e-5
    shifted = pose.clone()
    shifted[:, 0, 3] += 0.01
    assert float(geometry.pose_gap(shifted, pm1, pm2).min()) > 1e-3
