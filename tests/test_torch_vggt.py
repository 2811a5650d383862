"""VGGT-1B in the port (models/vggt.py, pseudo_gt/window.py, cli.pseudo_gt
--model vggt1b) against the plain float32 reference the benchmark holds it
to, benchmark/reference/vggt.py, loaded by file as the harness loads it. On
the CPU, at the reference's tiny size (a 4x4 patch grid, every kind of
layer), on the benchmark's seeded weights in float32.

Tolerance: both sides compute in float32 and differ only in the order of
their sums (convolution and product algorithms, attention over the whole
sequence against query blocks, K4/K2's plain versions against a softmax),
which puts every output within ~1e-6 relative RMS of the other; TOL is ten
times that. Each mutation of the port below moves an output far past it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_common import encode_png  # noqa: F401  (also warms exp up)
from benchmark.modules import family, load_module
from benchmark.weights import make_weights
from thermal3d_torch.models import vggt
from thermal3d_torch.models.rope import rope_tables
from thermal3d_torch.pseudo_gt.window import (OUTPUTS, WindowGenerator, frame_windows,
                                              generate_window_pseudo_gt)

REPO = Path(__file__).resolve().parents[1]
CFG = json.loads((REPO / "benchmark" / "configs" / "vggt1b.json").read_text())
REF = family(REPO, CFG)
PATH = load_module(REPO / "benchmark" / "paths" / "window.py", "vggt_test_window_path")
TINY = REF.tiny_config(CFG, "float32")
TOL = 1e-5
SEED = 2**31 + 25


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def weights():
    return make_weights(TINY, SEED, "cpu", REPO)


def window(n: int, seed: int = 0) -> torch.Tensor:
    size = TINY["img_size"]
    return torch.rand(n, size, size, 3, generator=torch.Generator().manual_seed(seed))


def generator(weights, n: int) -> WindowGenerator:
    return WindowGenerator(PATH.vggt_config(TINY), state_dict=weights, frames=n, device="cpu")


def gaps(weights, n: int):
    x = window(n, n)
    got = generator(weights, n).run_window(x.numpy())
    ref = REF.forward(weights, TINY, x)
    return {k: rel(got[k], ref[k]) for k in OUTPUTS}, got


@pytest.mark.parametrize("n", [1, 2, 3])
def test_window_generator_matches_the_reference(weights, n):
    """Every output of an n-frame window; at n = 1 the global blocks attend
    over one frame, as a frame block does."""
    found, got = gaps(weights, n)
    size = TINY["img_size"]
    assert got["depth"].shape == (n, size, size) and got["pose_enc"].shape == (n, 9)
    assert got["world_points"].shape == (n, size, size, 3)
    assert all(v.dtype == np.float32 for v in got.values())
    assert max(found.values()) < TOL, found


def _no_qk_norm(monkeypatch):
    monkeypatch.setattr(vggt, "qk_norm_", lambda *args: None)


def _no_position_shift(monkeypatch):
    shifted = vggt.frame_positions
    monkeypatch.setattr(vggt, "frame_positions",
                        lambda grid, specials, device: shifted(grid, specials, device).clamp(
                            min=1) - 1)


def _no_layer_scale(monkeypatch):
    monkeypatch.setattr(vggt.LayerScale, "forward", lambda self, x, branch: x + branch)


def _slot_zero_for_every_frame(monkeypatch):
    def special_tokens(param, n):
        t = param.to(torch.float32)[:, :1]
        return t.expand(1, n, *t.shape[2:]).reshape(n, *t.shape[2:])

    monkeypatch.setattr(vggt, "special_tokens", special_tokens)


@pytest.mark.parametrize("mutation", [_no_qk_norm, _no_position_shift, _no_layer_scale,
                                      _slot_zero_for_every_frame],
                         ids=["qk_norm", "position_shift", "layer_scale", "camera_slot"])
def test_a_port_without_a_part_fails_the_comparison(weights, monkeypatch, mutation):
    """Leaving out the QK-norm, the (y + 1, x + 1) shift of the patches'
    RoPE positions (the specials stay at (0, 0)), LayerScale, or slot 1 of
    the camera and register tokens for the later frames moves some output
    far past the tolerance."""
    mutation(monkeypatch)
    found, _ = gaps(weights, 3)
    assert max(found.values()) > 100 * TOL, found


@pytest.fixture(scope="module")
def camera_rounds(weights):
    x = window(3, 7)
    with torch.no_grad():
        outs = REF.aggregate(weights, TINY, x, {TINY["depth"] - 1})
        tokens = outs[TINY["depth"] - 1][:, 0]
        ref = REF.camera_head(weights, TINY, tokens)
        got = generator(weights, 3).model.camera_head(tokens)
    return got, ref


@pytest.mark.parametrize("round_", range(TINY["camera_iterations"]))
def test_camera_head_rounds_match_the_reference(camera_rounds, round_):
    """Each of the camera head's rounds on the reference's own last-layer
    camera tokens: the pose encoding activated after that round."""
    got, ref = camera_rounds
    assert len(got) == len(ref) == TINY["camera_iterations"]
    assert rel(got[round_], ref[round_]) < TOL


@pytest.mark.parametrize("n", [1, 2, 3])
def test_global_tables_are_the_frame_tables_tiled(n):
    """The global blocks' RoPE tables are the frame's repeated n times, and
    the frame's are RoPE100 at the positions the reference gives: specials at
    (0, 0), the patches at (y + 1, x + 1)."""
    model = vggt.VGGT(PATH.vggt_config(TINY))
    grid = (TINY["img_size"] // TINY["patch_size"],) * 2
    frame, window_ = model.aggregator.rope(grid, n, "cpu")
    assert torch.equal(frame.positions, REF.positions(TINY, "cpu"))
    d = TINY["embed_dim"] // TINY["num_heads"]
    cos, sin = rope_tables(REF.positions(TINY, "cpu"), d, float(TINY["rope_freq"]))
    assert torch.equal(frame.cos, cos) and torch.equal(frame.sin, sin)
    assert torch.equal(window_.cos, cos.repeat(n, 1)) and torch.equal(window_.sin, sin.repeat(n, 1))
    assert window_.cos.shape == (n * REF.tokens_per_frame(TINY), d)
    assert model.aggregator.rope(grid, n, "cpu") is model.aggregator.rope(grid, n, "cpu")


def test_a_global_block_over_one_frame_is_a_frame_block(weights):
    model = generator(weights, 1).model
    agg = model.aggregator
    grid = (TINY["img_size"] // TINY["patch_size"],) * 2
    frame, window_ = agg.rope(grid, 1, "cpu")
    x = torch.randn(1, REF.tokens_per_frame(TINY), TINY["embed_dim"],
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        blk = agg.global_blocks[0]
        assert torch.equal(blk(x, window_), blk(x, frame))


@pytest.mark.parametrize("shape", [(0, 56, 56, 3), (2, 48, 48, 3), (2, 56, 56), (2, 56, 56, 4)])
def test_run_window_refuses_a_bad_window(weights, shape):
    with pytest.raises(ValueError, match="run_window"):
        generator(weights, 2).run_window_async(np.zeros(shape, np.float32))


def _tree(root: Path, drives=(("seq1", "d1", 5), ("seq1", "d2", 2))):
    """A Freiburg-shaped tree of RGB frames (and their aligned thermal frames)
    at the tiny model's size."""
    rng = np.random.default_rng(11)
    for seq, drive, n in drives:
        for sub, color in (("fl_rgb", "rgb"), ("fl_ir_aligned", "gray")):
            d = root / "train" / seq / drive / sub
            d.mkdir(parents=True)
            for i in range(n):
                shape = (56, 56, 3) if color == "rgb" else (56, 56)
                arr = rng.integers(0, 256, shape, dtype=np.uint8)
                (d / f"{drive}_{i:04d}.png").write_bytes(encode_png(arr, color))
    return root


def test_frame_windows_keep_each_drive_whole():
    frames = [{"rgb": f"{d}{i}", "sequence": "s", "drive": d} for d, n in (("a", 5), ("b", 2))
              for i in range(n)]
    got = [[f["rgb"] for f in w] for w in frame_windows(frames, 3)]
    assert got == [["a0", "a1", "a2"], ["a3", "a4"], ["b0", "b1"]]


def test_generate_window_pseudo_gt_writes_each_frame(weights, tmp_path):
    """Each frame's five outputs, equal to run_window on the same decoded
    window (a drive's short last window runs at its own length)."""
    from thermal3d_torch.data.freiburg import build_rgb_thermal_index
    from thermal3d_torch.native import load_rgb_batch

    frames = build_rgb_thermal_index(str(_tree(tmp_path / "ds")))
    gen = generator(weights, 3)
    assert generate_window_pseudo_gt(frames, str(tmp_path / "out"), gen) == 7
    for w in frame_windows(frames, 3):
        rgb, ok = load_rgb_batch([f["rgb"] for f in w], (56, 56))
        assert ok.all()
        want = gen.run_window(rgb)
        for j, f in enumerate(w):
            name = Path(f["rgb"]).stem
            for k in OUTPUTS:
                np.testing.assert_array_equal(np.load(tmp_path / "out" / k / f"{name}.npy"),
                                              want[k][j])


def test_the_tiny_preset_is_the_reference_tiny_form():
    """core.config.VGGT_TINY, the CLI's --model_preset tiny, is the model the
    tests hold against the reference at its tiny size."""
    from thermal3d_torch.core.config import VGGT_TINY

    assert dataclasses.replace(VGGT_TINY, compute_dtype="float32") == PATH.vggt_config(TINY)


def test_cli_pseudo_gt_vggt1b_writes_the_windows(tmp_path):
    """cli.pseudo_gt --model vggt1b on seeded weights: the files of
    generate_window_pseudo_gt with the same generator."""
    from thermal3d_torch.cli.pseudo_gt import main
    from thermal3d_torch.core.config import VGGT_TINY

    root = _tree(tmp_path / "ds")
    n = main(["--model", "vggt1b", "--window", "3", "--dataset_dir", str(root), "--output_dir",
              str(tmp_path / "cli"), "--model_preset", "tiny", "--compute_dtype", "float32",
              "--device", "cpu"])
    assert n == 7
    from thermal3d_torch.data.freiburg import build_rgb_thermal_index

    gen = WindowGenerator(dataclasses.replace(VGGT_TINY, compute_dtype="float32"), frames=3,
                          device="cpu")
    generate_window_pseudo_gt(build_rgb_thermal_index(str(root)), str(tmp_path / "direct"), gen)
    files = sorted(p.relative_to(tmp_path / "direct") for p in (tmp_path / "direct").rglob("*.npy"))
    assert len(files) == 7 * len(OUTPUTS)
    for f in files:
        assert (tmp_path / "cli" / f).read_bytes() == (tmp_path / "direct" / f).read_bytes()


@pytest.mark.parametrize("argv", [["--weights", "w.pth"], ["--int8"], ["--test_set"],
                                  ["--ndev", "2"], ["--window", "0"], ["--img_size", "518", "518"]])
def test_cli_vggt1b_refuses_what_it_does_not_take(argv, capsys):
    from thermal3d_torch.cli.pseudo_gt import main

    with pytest.raises(SystemExit) as e:
        main(["--model", "vggt1b", "--dataset_dir", "d", "--output_dir", "o", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "vggt1b" in err or "--window" in err
