"""The VGGT-1B cell (`vggt1b-window-b24`): its counts against hand counts, its
tiny form through run_cell on the CPU, and that it joined the benchmark as
new files and appended entries only."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import counts_vggt
from benchmark.run import run_cell
from benchmark.tests.conftest import REPO, build_tiny_root
from benchmark.tests.test_bench_by_name import appended_only, tree_digest

CELL = "vggt1b-window-b24"
CFG = json.loads((REPO / "benchmark" / "configs" / "vggt1b.json").read_text())
# what the cell added: its files, and its entries in BENCHMARK.json
FILES = ["benchmark/reference/vggt.py", "benchmark/paths/window.py",
         "benchmark/configs/vggt1b.json", "benchmark/traffic/rgb-window-24.json",
         f"benchmark/limits/{CELL}.json", "benchmark/counts_vggt.py"] + [
    f"benchmark/metrics/{m}.window.py" for m in (
        "k2_roofline", "global_attention_ms", "gemm_roofline", "heads_ms", "dispatch_ms",
        "idle_share", "mfu", "issue_ms", "launches", "copy_ms", "host_copy_ms")]
METRICS = ["k2_roofline.window", "global_attention_ms.window", "gemm_roofline.window",
           "heads_ms.window", "dispatch_ms.window", "idle_share.window", "mfu.window",
           "issue_ms.window", "launches.window", "copy_ms.window", "host_copy_ms.window"]


def test_tokens_and_calls_by_hand():
    assert counts_vggt.tokens(CFG) == 1 + 4 + 37 * 37 == 1374
    k2 = counts_vggt.k2_calls(CFG, 24)
    assert k2.count((24, 1374, 1024, 16)) == 24 and k2.count((1, 32976, 1024, 16)) == 24
    assert len(k2) == 48
    k4 = counts_vggt.k4_calls(CFG, 24)
    assert k4.count((24, 1374, 1024, 16)) == 24 and k4.count((1, 24, 2048, 16)) == 16
    assert len(k4) == 40


def test_products_by_hand():
    trunk = counts_vggt.trunk_products(CFG, 24)
    assert len(trunk) == 72 * 4
    # a block's four products: 2·M·(3C² + C² + 4C² + 4C²) = 24·M·C²
    assert counts_vggt.product_flops(trunk) == 72 * 24 * 32976 * 1024 ** 2
    assert counts_vggt.product_flops(trunk) / 24 == pytest.approx(2.49e12, rel=2e-3)
    cam = counts_vggt.camera_products(CFG, 24)
    assert len(cam) == 4 * (2 + 4 * 4 + 2)
    d = 2048
    one = 2 * 24 * (9 * d + d * 3 * d + 4 * 12 * d * d + d * 1024 + 1024 * 9)
    assert counts_vggt.product_flops(cam) == 4 * one
    # bytes: A, B, the output and the bias once, 2 bytes each
    assert counts_vggt.product_bytes([(4, 3, 2)], 2) == (12 + 6 + 8 + 2) * 2


def test_attention_by_hand():
    frame, glob = (24, 1374, 1024, 16), (1, 32976, 1024, 16)
    assert counts_vggt.attention_flops([glob]) == 4 * 32976 ** 2 * 1024
    assert 24 * counts_vggt.attention_flops([glob]) / 24 == pytest.approx(4.45e12, rel=2e-3)
    assert counts_vggt.attention_flops([frame]) == 4 * 24 * 1374 ** 2 * 1024
    # q, k, v and the output in bf16, the float32 cos and sin tables of 64 lanes
    assert counts_vggt.attention_bytes([glob], 2) == 4 * 32976 * 1024 * 2 + 2 * 32976 * 64 * 4
    assert counts_vggt.attention_bytes([frame], 2, tables=False) == 4 * 24 * 1374 * 1024 * 2


def test_dpt_heads_by_hand():
    """One frame of the depth head, each convolution written out."""
    g, h = 37, 19
    f = 2 * g * g * 2048 * (256 + 512 + 1024 + 1024)  # projects, 1x1
    f += 2 * g * g * 256 * 256 * 16 + 2 * g * g * 512 * 512 * 4  # transposed, k = s = 4, 2
    f += 2 * h * h * 1024 * 1024 * 9  # stride-2 3x3
    f += 2 * 9 * 256 * (148 ** 2 * 256 + 74 ** 2 * 512 + 37 ** 2 * 1024 + 19 ** 2 * 1024)
    f += 2 * 9 * 256 * 256 * 2 * (19 ** 2 + 2 * 37 ** 2 + 2 * 74 ** 2 + 2 * 148 ** 2)  # units
    f += 2 * 256 * 256 * (37 ** 2 + 74 ** 2 + 148 ** 2 + 296 ** 2)  # out_conv, 1x1
    f += 2 * 9 * 256 * 128 * 296 ** 2  # output_conv1
    f += 2 * 518 ** 2 * (9 * 128 * 32 + 32 * 2)  # output_conv2
    assert counts_vggt.dpt_flops(CFG, 1, 2) == f
    assert counts_vggt.dpt_flops(CFG, 24, 4) - counts_vggt.dpt_flops(CFG, 24, 2) == \
        24 * 2 * 518 ** 2 * 32 * 2


def test_a_window_is_about_190_tflop():
    """~7.9 TFLOP a frame: trunk products 2.49, frame-local attention 0.37,
    global attention 4.45, the DPT heads ~0.59."""
    assert counts_vggt.window_flops(CFG, 24) / 24 == pytest.approx(7.9e12, rel=0.03)


@pytest.mark.parametrize("name,trunk", [
    ("nvjet_tst_256x144_64x4_2x1_v_bz_coopA_bias_TNT", True),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", True),
    ("nvjet_tst_64x24_64x16_2x1_v_bz_splitK_bias_TNT", False),  # a camera-head product
    ("nvjet_tst_64x24_64x16_4x1_v_bz_bias_TNT", False),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", False),  # no bias: a 1x1 convolution
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", False),
])
def test_gemm_roofline_tells_trunk_kernels_apart(name, trunk):
    """Kernel names of a traced window on the card (NVIDIA H100, torch
    2.11.0+cu128): the 288 trunk products ran the first two."""
    from benchmark.run import metric_module

    assert metric_module(REPO, "gemm_roofline.window").trunk_kernel(name.lower()) is trunk


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    spec = build_tiny_root(root)
    return root, spec, next(w for w in spec["workloads"] if w["name"] == CELL)


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
def test_the_tiny_cell_runs_through_run_cell(tiny, traced):
    from thermal3d_torch.core import profiling

    root, spec, cell = tiny
    profiling.clear()  # spans an earlier traced test of this process left
    res = run_cell(root, spec, cell, 2**31 + 77, 0.3, traced, "cpu",
                   log=lambda *a, **k: None, start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"depth_rel_rms", "world_points_rel_rms", "pose_enc_rel_rms"}
    if traced:  # on the CPU the device's metrics read nothing
        assert set(res["metrics"]) == {"dispatch_ms.window", "mfu.window", "issue_ms.window",
                                       "host_copy_ms.window"}
    else:
        assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_the_cell_joined_as_new_files_only(tmp_path):
    """The tiny benchmark without the cell's files and entries, then with
    them: no file that was there changes, BENCHMARK.json only gains entries
    at the ends of its lists, and the cell runs, traced and untraced."""
    full = build_tiny_root(tmp_path)
    added = sorted(f for f in FILES if (tmp_path / f).exists())
    assert len(added) == len(FILES) - 1  # counts_vggt.py is imported from the checkout
    saved = {f: (tmp_path / f).read_bytes() for f in added}
    for f in added:
        (tmp_path / f).unlink()
    stripped = json.loads(json.dumps(full))
    stripped["configs"] = [c for c in stripped["configs"] if c["name"] != "vggt1b"]
    stripped["workloads"] = [w for w in stripped["workloads"] if w["name"] != CELL]
    stripped["per_layer"] = [m for m in stripped["per_layer"] if m["name"] not in METRICS]
    for m in stripped["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(stripped))
    before = tree_digest(tmp_path)

    for f, data in saved.items():
        (tmp_path / f).write_bytes(data)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(full))
    assert appended_only(stripped, full)
    cell = next(w for w in full["workloads"] if w["name"] == CELL)
    for traced in (True, False):
        res = run_cell(tmp_path, full, cell, 2**31 + 7, 0.3, traced, "cpu",
                       log=lambda *a, **k: None, start=time.perf_counter())
        assert res["correct"], res["checks"]
    after = tree_digest(tmp_path)
    changed = sorted(p for p, h in before.items() if p != "BENCHMARK.json" and after.get(p) != h)
    assert not changed, changed
    new = sorted(p for p in set(after) - set(before) if "__pycache__" not in p)
    assert new == added
