"""The entry points of the fire-scene and figure slice against the JAX CLIs, on
the CPU: cli.infer with its default flags (a panel a frame), with --fire_scene,
with --advanced_fire --refine_depth and with --refine_depth alone (the
directory path), cli.ais_investigate's report and strips, and the port's
bench script (its JSON line with --device cpu, its exit 1 without CUDA).

A tiny DUSt3R-224 (TINY_KW) in float32 at 32×32 on the same .pth for both
packages, on four 40×48 16-bit thermal frames with a hot blob (one more file
is corrupt). Depths are held to rtol 1e-4 of their own scale, as the other
CLI tests (float32 sums in another order; the fire-scene inputs themselves
agree to 1e-5, tests/test_torch_filters.py, and the guided filter's float32
error is below 1e-6 of the depth's scale at this size). A figure's tiles are
held bit for bit to the colormaps of the port's own arrays (the colormaps are
held to matplotlib in tests/test_torch_viz.py), and its file names to the
JAX CLI's.
"""

import glob
import json
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_common import TINY_KW, configs, drawn_params
from thermal3d.cli import ais_investigate as jax_ais
from thermal3d.cli import infer as jax_infer
from thermal3d.convert.flax_to_torch import export_state_dict
from thermal3d.preprocess import io as jax_io
from thermal3d_torch import bench, native
from thermal3d_torch.cli import ais_investigate, infer
from thermal3d_torch.preprocess import io
from thermal3d_torch.viz import panels
from thermal3d_torch.viz.colormaps import colormap_rgb

RTOL = 1e-4
HW = (32, 32)
CLI_TINY = ["--img_size", "32", "32", "--model_preset", "tiny", "--compute_dtype", "float32"]
MODES = {"default": [], "fire_scene": ["--fire_scene"],
         "advanced_refine": ["--advanced_fire", "--refine_depth", "--no_vis"],
         "refine": ["--refine_depth", "--no_vis"]}


def _frame(rng):
    """Raw counts 21000-26000: a ramp and noise, and a hot blob (the fire)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 48), indexing="ij")
    f = 0.5 * xx + 0.3 * rng.uniform(size=xx.shape)
    f = np.where((yy - 0.4) ** 2 + (xx - 0.6) ** 2 < 0.04, f + 1.0, f)
    return (21000 + 5000 * f / f.max()).astype(np.uint16)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode of cli.infer and cli.ais_investigate (four stages), run once
    by the port ('t') and once by the JAX package ('j')."""
    root = tmp_path_factory.mktemp("fire_cli")
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        path = frames / f"fl_ir_aligned_159000{i}_00{i}.png"
        if i == 3:
            path.write_bytes(b"not a png")
        else:
            cv2.imwrite(str(path), _frame(rng))
    jcfg, _ = configs(**TINY_KW)
    pth = root / "w.pth"
    sd = export_state_dict(drawn_params(jcfg), jcfg)
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, pth)
    common = ["--img_path", str(frames), "--weights", str(pth), "--batch_size", "3", *CLI_TINY]
    out = {}
    for mode, flags in MODES.items():
        for who, main, extra in (("t", infer.main, ["--device", "cpu"]), ("j", jax_infer.main, [])):
            out_dir = root / who / mode
            main(common + flags + ["--output_dir", str(out_dir)] + extra)
            out[who, mode] = str(out_dir)
    ais_argv = ["--img_path", str(frames), "--weights", str(pth), *CLI_TINY, "--stages",
                *ais_investigate.STAGES]
    assert ais_investigate.STAGES == jax_ais.STAGES
    out["t", "ais_rows"] = ais_investigate.main(
        ais_argv + ["--output_dir", str(root / "t" / "ais"), "--device", "cpu"])
    out["j", "ais_rows"] = jax_ais.main(ais_argv + ["--output_dir", str(root / "j" / "ais")])
    out["t", "ais"], out["j", "ais"] = str(root / "t" / "ais"), str(root / "j" / "ais")
    out["paths"] = sorted(glob.glob(str(frames / "*.png")))
    return out


def _names(d, pattern="*"):
    return sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, pattern),
                                                           recursive=True))


def _close_depths(got_dir, ref_dir):
    files = _names(ref_dir, "**/*_depth.npy")
    assert _names(got_dir, "**/*_depth.npy") == files and files
    for rel in files:
        got, ref = np.load(os.path.join(got_dir, rel)), np.load(os.path.join(ref_dir, rel))
        assert got.shape == ref.shape == HW and got.dtype == ref.dtype == np.float32, rel
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale, err_msg=rel)
    return files


def _read(path):
    decoded, depth = native.decode_png(path)
    assert depth == 8
    return decoded.astype(np.uint8)


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_infer_modes_match_jax(runs, mode):
    """The same files as the JAX CLI (4 of 5 frames decode): depths within
    RTOL, and a {base}_depth_vis.png a frame unless --no_vis."""
    got_dir, ref_dir = runs["t", mode], runs["j", mode]
    assert len(_close_depths(got_dir, ref_dir)) == 4
    assert _names(got_dir) == _names(ref_dir)
    assert len(_names(got_dir, "*_depth_vis.png")) == (0 if "--no_vis" in MODES[mode] else 4)


@pytest.mark.parametrize("mode", ["default", "fire_scene"])
def test_cli_infer_panel_tiles(runs, mode):
    """input | depth (plasma) + bar | confidence (viridis) + bar: the input
    tile is the frame as the model sees it (preprocess_thermal_for_model, held
    to JAX's), the depth tile the plasma map of the saved depth."""
    for path in runs["paths"]:
        base = os.path.splitext(os.path.basename(path))[0]
        vis = os.path.join(runs["t", mode], f"{base}_depth_vis.png")
        model_view = io.preprocess_thermal_for_model(path, HW, device="cpu")
        if model_view is None:
            assert not os.path.exists(vis) and jax_io.preprocess_thermal_for_model(path, HW) is None
            continue
        np.testing.assert_allclose(model_view, jax_io.preprocess_thermal_for_model(path, HW),
                                   rtol=0, atol=1e-6)
        img = _read(vis)
        bar = panels.BAR_GAP + panels.BAR_WIDTH
        assert img.shape == (HW[0], 3 * HW[1] + 2 * panels.GAP + 2 * bar, 3)
        np.testing.assert_array_equal(img[:, :HW[1]], panels.rgb_tile(model_view))
        depth = np.load(os.path.join(runs["t", mode], f"{base}_depth.npy"))
        x = HW[1] + panels.GAP
        np.testing.assert_array_equal(img[:, x:x + HW[1]], colormap_rgb(depth, "plasma"))
        np.testing.assert_array_equal(img[0, x + HW[1] + panels.BAR_GAP],
                                      colormap_rgb(np.float32(1.0), "plasma", 0.0, 1.0))


def test_preprocess_thermal_batch_matches_jax(runs):
    got = io.preprocess_thermal_batch(runs["paths"], HW, device="cpu")
    ref = jax_io.preprocess_thermal_batch(runs["paths"], HW)
    assert got.shape == ref.shape == (4, *HW, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert io.preprocess_thermal_batch(runs["paths"][3:4], HW, device="cpu").shape == (0, *HW, 3)


def _report_numbers(text):
    """The report with its numbers taken out, and the numbers with their
    printed decimals."""
    number = re.compile(r"-?\d+\.(\d+)")
    return number.sub("#", text), [(float(m.group(0)), len(m.group(1)))
                                   for m in number.finditer(text)]


def test_ais_investigate_matches_jax(runs):
    """Four stages: every stage's depths within RTOL of the JAX CLI's, the
    same files, and investigation.md equal but for its numbers, each within
    RTOL and one unit of its last printed digit of JAX's."""
    got_dir, ref_dir = runs["t", "ais"], runs["j", "ais"]
    assert runs["t", "ais_rows"] == runs["j", "ais_rows"] == 4 * 4
    assert len(_close_depths(got_dir, ref_dir)) == 16
    assert _names(got_dir, "**/*") == _names(ref_dir, "**/*")
    assert len(_names(got_dir, "*_stages.png")) == 4
    text, got = _report_numbers(open(os.path.join(got_dir, "investigation.md")).read())
    ref_text, ref = _report_numbers(open(os.path.join(ref_dir, "investigation.md")).read())
    assert text == ref_text and len(got) == len(ref) > 16
    for (a, digits), (b, _) in zip(got, ref):
        assert abs(a - b) <= 10.0 ** -digits + RTOL * abs(b), (a, b)


def test_ais_stage_strip_tiles(runs):
    """The thermal frame in gray, then each stage's depth in viridis on 0..vmax."""
    got_dir = runs["t", "ais"]
    path = runs["paths"][0]
    base = os.path.splitext(os.path.basename(path))[0]
    img = _read(os.path.join(got_dir, f"{base}_stages.png"))
    depths = [np.load(os.path.join(got_dir, s, f"{base}_depth.npy"))
              for s in ais_investigate.STAGES]
    vmax = max(np.nanmax(d) for d in depths)
    x = HW[1] + panels.GAP
    for d in depths:
        np.testing.assert_array_equal(img[:, x:x + HW[1]], colormap_rgb(d, "viridis", 0.0, vmax))
        x += HW[1] + panels.BAR_GAP + panels.BAR_WIDTH + panels.GAP
    assert img.shape[1] == x - panels.GAP


def test_bench_json_line_on_cpu(capsys):
    rc = bench.main(["--device", "cpu", "--model_preset", "tiny", "--batch", "2", "--iters", "1",
                     "--train_batch", "1", "--pair_batch", "1", "--sweep", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "thermal_frames_per_sec_cpu_check_dustr224"
    assert line["unit"] == "frames/s" and line["value"] > 0 and line["vs_baseline"] is None
    assert [s["batch"] for s in line["sweep"]] == [1]
    secondary = line["secondary_metrics"]
    assert [s["config"] for s in secondary] == [
        "bf16", "int8_fc1_static_acts", "int8_all_static_acts", "train_dustr224_b1",
        "pseudo_gt_mastr512_b1"]
    for s in secondary:
        assert all(np.isfinite(v) for v in s.values() if isinstance(v, float))
    for s in secondary[3:]:
        assert "cpu_check" in s["metric"] and s["value"] > 0
    # the int8 frontier (bench.py's): fps and two drifts against the headline
    assert round(secondary[0]["fps"], 2) == line["value"] and secondary[0]["abs_rel_drift"] == 0.0
    for s in secondary[1:3]:
        assert s["fps"] > 0 and s["vs_baseline"] is None
        assert s["abs_rel_drift"] > 0 and s["depth_drift_rel_rms"] > 0
        assert s["drift_ok"] == (s["abs_rel_drift"] <= 0.01)


def test_bench_without_cuda_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert capsys.readouterr().out == ""
    res = subprocess.run([sys.executable, "-m", "thermal3d_torch.bench"], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 1 and res.stdout == "" and "CUDA" in res.stderr
