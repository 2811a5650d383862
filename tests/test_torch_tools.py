"""The port's tools against the JAX package on the CPU: the checkpoint key
inventories and cli.model_info, the scan and branch layouts, profiling,
dataset exploration and the ThermalDUSt3R wrapper."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_common import (TINY_KW, configs, drawn_params, thermal_head_params,
                                     to_np, torch_state)
from thermal3d_torch.convert.from_pth import expected_torch_keys, released_checkpoint_keys

VARIANTS = ["DUSTR_224_LINEAR", "DUSTR_512_DPT", "MASTR_512_CATMLPDPT"]


@pytest.mark.parametrize("name", VARIANTS)
def test_key_inventories_match_jax(name):
    """expected_torch_keys (the port's model on the meta device, plus the
    dead refinenet4 unit) and released_checkpoint_keys equal the JAX dicts,
    names and shapes, at the default and at another native decoder depth."""
    from thermal3d.convert import torch_to_flax
    from thermal3d.core import config as jax_config
    from thermal3d_torch.core import config as torch_config

    tcfg, jcfg = getattr(torch_config, name), getattr(jax_config, name)
    assert expected_torch_keys(tcfg) == torch_to_flax.expected_torch_keys(jcfg)
    assert released_checkpoint_keys(tcfg) == torch_to_flax.released_checkpoint_keys(jcfg)
    assert (released_checkpoint_keys(tcfg, 14)
            == torch_to_flax.released_checkpoint_keys(jcfg, 14))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A .pth of the tiny model's state (what the port's engine loads), with
    croco's mask_token, one unknown key and one tensor of a wrong shape."""
    from thermal3d_torch.core.config import TINY
    from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo

    torch.manual_seed(0)
    state = AsymmetricCroCo3DStereo(TINY).state_dict()
    state["mask_token"] = torch.zeros(1, 1, TINY.dec_embed_dim)
    state["prediction_head.weight"] = torch.zeros(3, 3)
    state["enc_norm.bias"] = torch.zeros(7)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({"model": state}, path)
    return path


@pytest.mark.parametrize("flags", [[], ["--validate"], ["--validate", "--config", "mastr512"]])
def test_model_info_cli_matches_jax(checkpoint, flags, capsys):
    """cli.model_info prints and returns what the JAX CLI does on the same
    .pth: the stats, the architecture text, and --validate's report."""
    from thermal3d.cli.model_info import main as jax_main
    from thermal3d_torch.cli.model_info import main

    got = main(["--checkpoint", checkpoint, *flags])
    got_out = capsys.readouterr().out
    want = jax_main(["--checkpoint", checkpoint, *flags])
    assert got_out == capsys.readouterr().out
    assert got == want
    if flags == ["--validate"]:
        assert got["unexpected"] == ["prediction_head.weight"]
        assert "enc_norm.bias" in got["shape_mismatches"]


def test_model_info_diagram(checkpoint, tmp_path):
    """--diagram writes the box diagram: the reference's 11 × 5 layout at 100
    pixels a unit, with its three box colours and its ink."""
    from thermal3d_torch import native
    from thermal3d_torch.cli.model_info import main

    path = str(tmp_path / "arch.png")
    main(["--checkpoint", checkpoint, "--diagram", path])
    img = native.decode_png(path)[0].astype(np.uint8)
    assert img.shape == (500, 1100, 3)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    for c in ((0xcf, 0xe3, 0xf7), (0xd9, 0xef, 0xd3), (0xf7, 0xe3, 0xcf), (0x33, 0x33, 0x33),
              (255, 255, 255)):
        assert c in colours
    assert tuple(img[250, 110]) == (0xcf, 0xe3, 0xf7)  # inside the patch-embed box


@pytest.mark.parametrize("layout", ["scan_layers", "branch_batch"])
def test_scan_and_branch_layout_trees_match(layout):
    """A JAX tree in the scan or branch layout converts to the unrolled
    state dict bit for bit, and the port (config flag accepted, unrolled
    modules) matches the JAX model of that layout at rtol 1e-4."""
    import jax

    from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
    from thermal3d.models.scan_params import to_branch_params, to_scan_params
    from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo

    jcfg, tcfg = configs(**TINY_KW)
    params = drawn_params(jcfg, 1)
    to_layout = to_scan_params if layout == "scan_layers" else to_branch_params
    tree = to_layout(params, jcfg)
    state = torch_state(tree)
    ref_state = torch_state(params)
    assert state.keys() == ref_state.keys()
    assert all(torch.equal(state[k], ref_state[k]) for k in state)

    jcfg_l = dataclasses.replace(jcfg, **{layout: True})
    model = AsymmetricCroCo3DStereo(dataclasses.replace(tcfg, **{layout: True})).eval()
    model.load_state_dict(state, strict=True)
    rng = np.random.default_rng(3)
    img1, img2 = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    j1, j2 = jax.jit(JaxModel(jcfg_l).apply)({"params": tree}, img1, img2)
    with torch.no_grad():
        t1, t2 = model(torch.from_numpy(img1), torch.from_numpy(img2))
    for a, b in ((j1, t1), (j2, t2)):
        for k in a:
            ref = np.asarray(a[k])
            np.testing.assert_allclose(to_np(b[k]), ref, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(ref).max()), err_msg=k)


def test_cli_infer_accepts_scan_layers(tmp_path):
    """--scan_layers is accepted and the depths equal the run without it
    (the port runs the unrolled model either way)."""
    from tests.test_torch_common import encode_png
    from thermal3d_torch.cli.infer import main

    frame = np.random.default_rng(0).integers(21000, 26000, (20, 24)).astype(np.uint16)
    png = tmp_path / "fl_ir_aligned_0.png"
    png.write_bytes(encode_png(frame, depth=16))
    outs = []
    for flags in ([], ["--scan_layers"]):
        out = tmp_path / f"out{len(outs)}"
        main(["--img_path", str(png), "--output_dir", str(out), "--model_preset", "tiny",
              "--img_size", "32", "32", "--compute_dtype", "float32", "--no_vis",
              "--device", "cpu", *flags])
        outs.append(np.load(out / "fl_ir_aligned_0_depth.npy"))
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# profiling (the cases of tests/test_profiling.py)
# ---------------------------------------------------------------------------

def test_stage_timer():
    from thermal3d_torch.core.profiling import StageTimer

    t = StageTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with t.stage("mm", x):
            x = x @ x / 64
    s = t.summary()
    assert s["mm"]["count"] == 3 and s["mm"]["total_s"] >= 0
    assert json.loads(t.report())["mm"]["count"] == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    from thermal3d_torch.core.profiling import annotate, trace

    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        with annotate("matmul"):
            _ = torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    assert any(e.key == "matmul" for e in prof.key_averages())


def test_nan_guard_raises():
    from thermal3d_torch.core.profiling import nan_guard

    with nan_guard():
        assert torch.isfinite(torch.ones(3) / 2).all()  # no NaN, no raise
    with pytest.raises(FloatingPointError):
        with nan_guard():
            _ = torch.tensor(0.0) / torch.tensor(0.0)
    assert torch.isnan(torch.tensor(0.0) / torch.tensor(0.0))  # the mode is off again


# ---------------------------------------------------------------------------
# exploration and the wrapper
# ---------------------------------------------------------------------------

def test_explore_dataset_matches_jax(tmp_path):
    from thermal3d.data.exploration import explore_dataset as jax_explore
    from thermal3d_torch.data.exploration import explore_dataset

    root = tmp_path / "ds"
    for rel in ("train/seq_00_day/00/fl_rgb/a.png", "train/seq_00_day/00/fl_ir_aligned/a.png",
                "train/seq_01_night/00/thermal_x/b.png", "train/seq_01_night/00/notes.TXT",
                "test/x/y/z/w/v/deep.png", "calib.yaml"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(b"")
    for depth in (2, 4, 6):
        assert explore_dataset(str(root), depth) == jax_explore(str(root), depth)
    assert explore_dataset(str(root))["extension_counts"][".png"] == 3


def test_thermal_dustr_wrapper_matches_jax():
    """The JAX ThermalDUSt3R's params, exported to the reference wrapper's
    .pth layout by the JAX package, load into the port's wrapper with
    strict=True (the reference's sobel buffers too), and both views
    through head and model match the JAX wrapper at rtol 1e-4."""
    import jax

    from thermal3d.convert.flax_to_torch import export_state_dict
    from thermal3d.models.thermal_wrap import ThermalDUSt3R as JaxWrapper
    from thermal3d_torch.models.thermal_wrap import ThermalDUSt3R

    jcfg, tcfg = configs(**TINY_KW)
    params = {"model": drawn_params(jcfg, 2), "thermal_preprocess": thermal_head_params()}
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             export_state_dict(params, jcfg, wrapper=True).items()}
    state["sobel_x"] = torch.zeros(3, 1, 3, 3)
    state["sobel_y"] = torch.zeros(3, 1, 3, 3)
    model = ThermalDUSt3R(tcfg).eval()
    model.load_state_dict(state, strict=True)
    assert set(model.state_dict()) == set(state) - {"sobel_x", "sobel_y"}
    assert float(model.state_dict()["edge_weight"]) == pytest.approx(0.37)
    rng = np.random.default_rng(5)
    img1, img2 = (rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    j1, j2 = jax.jit(JaxWrapper(jcfg).apply)({"params": params}, img1, img2)
    with torch.no_grad():
        t1, t2 = model(torch.from_numpy(img1), torch.from_numpy(img2))
    for a, b in ((j1, t1), (j2, t2)):
        for k in a:
            ref = np.asarray(a[k])
            np.testing.assert_allclose(to_np(b[k]), ref, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(ref).max()), err_msg=k)
