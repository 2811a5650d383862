"""The port's file-driven entry points against the JAX package, on a small
Freiburg-style tree written with cv2: InferenceEngine.infer_paths (and the
serial loop it must equal bit for bit), generate_pseudo_gt and the test-set
writer (every file), the depth metrics and evaluate_test_set, the filename
and index rules, the .pth loader, and the infer / pseudo_gt / evaluate CLIs
against the JAX CLIs on the same .pth.

Tiny models in float32 (TINY_KW and the tiny MASt3R preset), weights drawn by
the Flax init and carried over by convert/from_jax.py or a .pth written by
thermal3d.convert.flax_to_torch.export_state_dict. rtol 1e-4 of each
output's own scale, as in the engine and pseudo-GT parity tests (f32
summation orders differ between XLA and PyTorch; the exp heads amplify them).
"""

import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TINY_KW, configs, drawn_params, run_wrapper,
                                     thermal_head_params, torch_state)
from thermal3d.cli import common as jax_common
from thermal3d.convert.flax_to_torch import export_state_dict
from thermal3d.core.config import MASTR_512_CATMLPDPT as JAX_MASTR
from thermal3d.data import freiburg as jax_freiburg
from thermal3d.evaluation import evaluator as jax_evaluator
from thermal3d.evaluation.metrics import compute_depth_metrics as jax_metrics
from thermal3d.infer.engine import InferenceEngine as JaxEngine
from thermal3d.pseudo_gt.generator import PseudoGTGenerator as JaxGenerator
from thermal3d.pseudo_gt.generator import generate_pseudo_gt as jax_generate
from thermal3d.pseudo_gt.test_set import generate_test_set_pseudo_gt as jax_test_set
from thermal3d_torch.cli import common
from thermal3d_torch.convert import from_pth
from thermal3d_torch.convert.from_jax import thermal_head_state_from_jax
from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
from thermal3d_torch.data import freiburg
from thermal3d_torch.evaluation import evaluator
from thermal3d_torch.evaluation.metrics import batched_depth_metrics, compute_depth_metrics
from thermal3d_torch.infer.engine import OUTPUT_KEYS, InferenceEngine
from thermal3d_torch.pseudo_gt.generator import OUTPUT_DIRS, PseudoGTGenerator, generate_pseudo_gt
from thermal3d_torch.pseudo_gt.test_set import generate_test_set_pseudo_gt

RTOL = 1e-4
STAMPS = [f"157000{i}_00{i}" for i in range(5)]
BATCH = 3  # 5-7 frames: full batches and a padded last one
FRAME_HW = (40, 48)


def _close(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    scale = float(np.nanmax(np.abs(ref))) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale, err_msg=what)


def _thermal(rng):
    ramp = np.linspace(0, 1, FRAME_HW[1])[None, :]
    return (21000 + 5000 * (0.6 * ramp + 0.4 * rng.uniform(size=FRAME_HW))).astype(np.uint16)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A Freiburg tree (train/seq_00_day/00/{fl_ir_aligned,fl_rgb}, 5 frames
    each), a directory of 7 thermal frames of which one is corrupt, pseudo-GT
    depths for them at another size than the model's, a calibration file,
    and .pth files of both tiny models in the plain and the wrapper layout."""
    root = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(0)
    seq = root / "ds" / "train" / "seq_00_day" / "00"
    for sub in ("fl_ir_aligned", "fl_rgb"):
        (seq / sub).mkdir(parents=True)
    frames, gt = root / "frames", root / "gt"
    frames.mkdir()
    gt.mkdir()
    for s in STAMPS:
        cv2.imwrite(str(seq / "fl_ir_aligned" / f"fl_ir_aligned_{s}.png"), _thermal(rng))
        cv2.imwrite(str(seq / "fl_rgb" / f"fl_rgb_{s}.png"),
                    rng.integers(0, 256, (*FRAME_HW, 3)).astype(np.uint8))
    for i in range(7):
        path = frames / f"fl_ir_aligned_158000{i}_00{i}.png"
        if i == 2:
            path.write_bytes(b"not a png")
        else:
            cv2.imwrite(str(path), _thermal(rng))
        depth = rng.uniform(1.0, 20.0, (24, 20)).astype(np.float32)
        depth[:3] = 0.0  # outside the mask
        depth[5, 5] = np.nan
        np.save(gt / f"fl_ir_aligned_158000{i}_00{i}_depth.npy", depth)
    calib = root / "calib.json"
    calib.write_text(json.dumps({"intrinsic": [30.0, 31.0, 16.0, 15.5],
                                 "rotation": np.eye(3).tolist(), "translation": [0, 0, 0]}))

    jcfg, _ = configs(**TINY_KW)
    params = drawn_params(jcfg)
    thp = thermal_head_params()
    mastr_jcfg = jax_common.apply_preset(JAX_MASTR, "tiny", (32, 32), "float32")
    mastr_params = drawn_params(mastr_jcfg, seed=1)

    def save(sd, path, container):
        torch.save({container: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
        return str(path)

    pth = {
        "plain": save(export_state_dict(params, jcfg), root / "plain.pth", "state_dict"),
        "wrapper": save(export_state_dict({"model": params, "thermal_preprocess": thp}, jcfg,
                                          wrapper=True), root / "wrapper.pth", "model"),
        "mastr": save(export_state_dict(mastr_params, mastr_jcfg), root / "mastr.pth",
                      "state_dict"),
    }
    return dict(root=root, ds=str(root / "ds"), frames=str(frames), gt=str(gt),
                calib=str(calib), params=params, thp=thp, mastr_params=mastr_params,
                mastr_jcfg=mastr_jcfg, pth=pth,
                paths=sorted(glob.glob(str(frames / "*.png"))))


def _engines(data):
    jcfg, tcfg = configs(**TINY_KW)
    jeng = JaxEngine(jcfg, params=data["params"], thermal_head_params=data["thp"])
    teng = InferenceEngine(tcfg, state_dict=torch_state(data["params"]),
                           thermal_head_state=thermal_head_state_from_jax(data["thp"]),
                           device="cpu")
    return jeng, teng


def test_infer_paths_matches_jax_and_the_serial_loop(data):
    """7 frames (one corrupt) in batches of 3: the surviving paths, every
    output against the JAX infer_paths, bit-equal to a serial decode → infer
    loop, and the depth-only fetch equal to the full one."""
    jeng, teng = _engines(data)
    paths = data["paths"]
    out = teng.infer_paths(paths, batch_size=BATCH)
    ref = jeng.infer_paths(paths, batch_size=BATCH)
    assert out["paths"] == ref["paths"] == [p for i, p in enumerate(paths) if i != 2]
    for k in OUTPUT_KEYS:
        _close(out[k], ref[k], k)
    from thermal3d_torch.preprocess.io import load_thermal_images_batch

    serial = {k: [] for k in OUTPUT_KEYS}
    for i in range(0, len(paths), BATCH):
        grays, _ = load_thermal_images_batch(paths[i:i + BATCH], out_hw=(32, 32))
        real = len(grays)
        grays += [grays[-1]] * (BATCH - real)
        for k, v in teng.infer(np.stack(grays)).items():
            serial[k].append(v[:real])
    for k in OUTPUT_KEYS:
        np.testing.assert_array_equal(out[k], np.concatenate(serial[k]), err_msg=k)
    depth_only = teng.infer_paths(paths, batch_size=BATCH, outputs=("depth",))
    assert sorted(depth_only) == ["depth", "paths"]
    np.testing.assert_array_equal(depth_only["depth"], out["depth"])
    unpadded = teng.infer_paths(paths, batch_size=BATCH, pad_final=False, prefetch=0)
    _close(unpadded["depth"], out["depth"], "pad_final=False")
    assert teng.infer_paths([paths[2]]) == {}
    with pytest.raises(ValueError, match="unknown outputs"):
        teng.infer_paths(paths, outputs=("depth2",))


def _mastr_generators(data, batch_size=BATCH, calib=None):
    jcfg = data["mastr_jcfg"]
    tcfg = common.apply_preset(MASTR_512_CATMLPDPT, "tiny", (32, 32), "float32")
    jgen = JaxGenerator(jcfg, params=data["mastr_params"], batch_size=batch_size,
                        calib_file=calib)
    tgen = PseudoGTGenerator(tcfg, state_dict=torch_state(data["mastr_params"]),
                             batch_size=batch_size, calib_file=calib, device="cpu")
    return jgen, tgen


def _same_text(got: str, ref: str, what: str):
    """Equal text but for its numbers, which agree to RTOL."""
    import re

    number = re.compile(r"-?\d+\.\d+|nan")
    assert number.sub("#", got) == number.sub("#", ref), what
    a, b = number.findall(got), number.findall(ref)
    np.testing.assert_allclose(np.array(a, float), np.array(b, float), rtol=RTOL, err_msg=what)


def _compare_trees(out_dir, ref_dir, pattern="**/*.npy"):
    got = sorted(os.path.relpath(p, out_dir) for p in glob.glob(
        os.path.join(out_dir, pattern), recursive=True))
    want = sorted(os.path.relpath(p, ref_dir) for p in glob.glob(
        os.path.join(ref_dir, pattern), recursive=True))
    assert got == want and got
    for rel in got:
        a, b = os.path.join(out_dir, rel), os.path.join(ref_dir, rel)
        if rel.endswith(".npy"):
            _close(np.load(a), np.load(b), rel)
        else:
            _same_text(open(a).read(), open(b).read(), rel)
    return got


def _compare_names(out_dir, ref_dir, pattern):
    """The same file names under both trees (figures: their pixels are held
    against matplotlib in test_torch_viz.py and test_torch_fire_cli.py)."""
    names = [sorted(os.path.relpath(p, d) for p in glob.glob(os.path.join(d, pattern),
                                                              recursive=True))
             for d in (out_dir, ref_dir)]
    assert names[0] == names[1] and names[0]
    return names[0]


def test_generate_pseudo_gt_files_match_jax(data, tmp_path):
    """4 pairs (frame_skip 1) in steps of 3 and a padded 1: all eight
    directories, file for file (the calibration's K in place of the
    estimated intrinsics is held in the CLI test)."""
    jgen, tgen = _mastr_generators(data)
    pairs = freiburg.build_rgb_pair_index(data["ds"], frame_skip=1)
    assert len(pairs) == 4
    n = generate_pseudo_gt(pairs, str(tmp_path / "t"), tgen)
    assert n == jax_generate(pairs, str(tmp_path / "j"), jgen) == 4
    files = _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(files) == 6 * 4 + 2 * 4  # pair-named dirs + depth1/depth2 by base name
    assert sorted(os.listdir(tmp_path / "t")) == sorted(OUTPUT_DIRS)
    # visualize=True: the same files plus a 2x2 panel a pair, named as JAX names them
    generate_pseudo_gt(pairs, str(tmp_path / "v"), tgen, visualize=True)
    jax_generate(pairs, str(tmp_path / "jv"), jgen, visualize=True)
    _compare_trees(str(tmp_path / "v"), str(tmp_path / "j"))
    panels = _compare_names(str(tmp_path / "v"), str(tmp_path / "jv"), "visualizations/*.png")
    assert len(panels) == 4


def test_generate_test_set_matches_jax(data, tmp_path):
    """5 frames monocular in steps of 3: {name}_depth.npy,
    {name}_thermal_path.txt and the {name}_depth_vis.png preview of every
    frame as the JAX writer makes them (the preview's pixels are held in
    test_torch_fire_cli.py)."""
    jgen, tgen = _mastr_generators(data)
    frames = freiburg.build_rgb_thermal_index(data["ds"])
    assert generate_test_set_pseudo_gt(frames, str(tmp_path / "t"), tgen) == 5
    assert jax_test_set(frames, str(tmp_path / "j"), jgen) == 5
    _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"))
    _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"), "**/*.txt")
    assert len(_compare_names(str(tmp_path / "t"), str(tmp_path / "j"), "**/*_depth_vis.png")) == 5


def _metric_inputs():
    rng = np.random.default_rng(5)
    gt = rng.uniform(0.5, 30.0, (4, 19, 23)).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, gt.shape)).astype(np.float32)
    gt[0, :4] = 0.0
    gt[0, 6, 6] = np.inf
    gt[1].flat[::2] = 0.0  # an even count of valid pixels (218 of 437)
    gt[2] = 0.0  # an empty mask
    return pred, gt


@pytest.mark.parametrize("case", ["scaled", "unscaled", "mask"])
def test_depth_metrics_match_jax(case):
    """Each image alone and the batched form: the same mask rules, the
    midpoint median for an even count, NaN/0 for an empty mask. rtol 1e-5:
    f32 sums in another order."""
    pred, gt = _metric_inputs()
    assert ((gt[1] > 0) & np.isfinite(gt[1])).sum() % 2 == 0
    scaling = case != "unscaled"
    masks = (gt > 2.0) if case == "mask" else [None] * len(gt)
    for i in range(len(gt)):
        got = compute_depth_metrics(pred[i], gt[i], masks[i], scaling, device="cpu")
        ref = jax_metrics(pred[i], gt[i], masks[i], scaling)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=f"{i} {k}")
        if i == 2 and case != "mask":
            assert np.isnan(got["rmse"]) and got["acc_1"] == 0.0
    if case != "mask":
        batched = batched_depth_metrics(pred, gt, scaling, device="cpu")
        for i in range(len(gt)):
            single = compute_depth_metrics(pred[i], gt[i], None, scaling, device="cpu")
            for k, v in single.items():
                np.testing.assert_allclose(batched[k][i], v, rtol=1e-6)


def test_nanmedian_is_the_midpoint():
    """An even count of valid pixels: the median scale uses the mean of the two
    middle values (jnp.nanmedian), not torch.nanmedian's lower one."""
    gt = np.full((1, 4), 2.0, np.float32)
    pred = np.array([[1.0, 2.0, 3.0, 10.0]], np.float32)
    got = compute_depth_metrics(pred, gt, device="cpu")
    ref = jax_metrics(pred, gt)
    np.testing.assert_allclose(got["abs_rel"], ref["abs_rel"], rtol=1e-6)
    # scale 2 / 2.5: the midpoint of 2 and 3, not the lower value 2
    want = np.mean(np.abs(2.0 - pred[0] * 0.8) / 2.0)
    np.testing.assert_allclose(got["abs_rel"], want, rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((24, 20), (32, 32)), ((512, 640), (224, 224)),
                                     ((7, 5), (3, 11)), ((100, 60), (33, 47))])
def test_resize_nearest_matches_cv2(src, dst):
    """cv2 INTER_NEAREST (not half-pixel) at unequal sizes, as the reference
    evaluator resizes GT."""
    img = np.random.default_rng(1).uniform(size=src).astype(np.float32)
    np.testing.assert_array_equal(evaluator._resize_nearest(img, dst),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))


def test_find_matching_depth_file_matches_jax(tmp_path):
    d = tmp_path / "gt"
    d.mkdir()
    for name in ("fl_ir_aligned_aligned_1570001_15700010_rgb_depth.npy",
                 "fl_rgb_1570002_002_depth.npy", "x_y_1570003_5_depth.npy",
                 "fl_ir_aligned_1570004_004_depth.npy", "a_depth.npy", "notes.txt"):
        (d / name).write_bytes(b"")
    for thermal in ("fl_ir_aligned_1570001_001.png", "fl_ir_aligned_1570002_002.png",
                    "fl_ir_aligned_1570003_003.png", "fl_ir_aligned_1570004_004.png",
                    "x_1570003_5.png", "ab.png", "fl_ir_aligned_9_9.png", "a_b_c.png"):
        assert evaluator.find_matching_depth_file(thermal, str(d)) == \
            jax_evaluator.find_matching_depth_file(thermal, str(d)), thermal


def test_evaluate_test_set_matches_jax(data, tmp_path):
    """GT at 24×20 against 32×32 predictions (resized by the cv2 nearest
    rule), one corrupt frame dropped: the averages, every per-image metrics
    file and metrics_summary.txt, as text."""
    jeng, teng = _engines(data)
    got = evaluator.evaluate_test_set(teng, data["paths"], data["gt"], str(tmp_path / "t"),
                                      save_visualizations=False, batch_size=BATCH)
    ref = jax_evaluator.evaluate_test_set(jeng, data["paths"], data["gt"],
                                          str(tmp_path / "j"), save_visualizations=False,
                                          batch_size=BATCH)
    assert got["n_images"] == ref["n_images"] == 6
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
    _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"), "*.txt")
    # the default save_visualizations: a comparison panel a frame, named as JAX names them
    evaluator.evaluate_test_set(teng, data["paths"], data["gt"], str(tmp_path / "v"),
                                batch_size=BATCH)
    jax_evaluator.evaluate_test_set(jeng, data["paths"], data["gt"], str(tmp_path / "jv"),
                                    batch_size=BATCH)
    assert len(_compare_names(str(tmp_path / "v"), str(tmp_path / "jv"),
                              "*_comparison.png")) == 6


def test_freiburg_indexes_match_jax(data, tmp_path):
    """The index builders on the same tree, with a drive lacking a thermal
    frame, a night sequence and written pseudo-GT to match against."""
    extra = os.path.join(data["ds"], "train", "seq_01_night", "00")
    for sub in ("fl_ir_aligned", "fl_rgb"):
        os.makedirs(os.path.join(extra, sub))
    img = np.zeros((8, 8), np.uint16)
    night = [f"159000{i}_00{i}" for i in range(3)]
    for s in night:
        cv2.imwrite(os.path.join(extra, "fl_rgb", f"fl_rgb_{s}.png"), img)
        if s != night[1]:
            cv2.imwrite(os.path.join(extra, "fl_ir_aligned", f"fl_ir_aligned_{s}.png"), img)
    gt_dir = tmp_path / "pgt"
    for sub in ("pointmap1", "pointmap2", "depth1"):
        (gt_dir / sub).mkdir(parents=True)
    pairs = jax_freiburg.build_pair_index(data["ds"], frame_skip=1)
    first = os.path.splitext(os.path.basename(pairs[0]["rgb1"]))[0]
    second = os.path.splitext(os.path.basename(pairs[0]["rgb2"]))[0]
    for sub in ("pointmap1", "pointmap2"):
        np.save(gt_dir / sub / f"{first}_{second}.npy", np.zeros(1))
    np.save(gt_dir / "depth1" / f"{first}.npy", np.zeros(1))
    try:
        for skip in (1, 2):
            assert freiburg.build_pair_index(data["ds"], frame_skip=skip) == \
                jax_freiburg.build_pair_index(data["ds"], frame_skip=skip)
            assert freiburg.build_rgb_pair_index(data["ds"], frame_skip=skip) == \
                jax_freiburg.build_rgb_pair_index(data["ds"], frame_skip=skip)
        assert freiburg.build_rgb_thermal_index(data["ds"]) == \
            jax_freiburg.build_rgb_thermal_index(data["ds"])
        for day, night in ((True, False), (False, True), (False, False)):
            seqs = ["seq_00_day", "seq_01_night"]
            assert freiburg.day_night_filter(seqs, day, night) == \
                jax_freiburg.day_night_filter(seqs, day, night)
        for pair in pairs:
            assert freiburg.match_pseudo_gt(pair, str(gt_dir)) == \
                jax_freiburg.match_pseudo_gt(pair, str(gt_dir))
        valid = freiburg.validate_pair_index(pairs, str(gt_dir))
        assert valid == jax_freiburg.validate_pair_index(pairs, str(gt_dir))
        assert len(valid) == 1
    finally:
        import shutil

        shutil.rmtree(os.path.dirname(extra))


def test_from_pth_skips_what_the_reference_skips(data, tmp_path):
    """A 12-block-style checkpoint with croco's extras: the extra blocks,
    mask_token, prediction_head, the dead refinenet4.resConfUnit1 and the
    wrapper's sobel buffers are dropped; an unknown key fails the strict load;
    an orbax directory raises NotImplementedError."""
    jcfg, tcfg = configs(**TINY_KW)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_state_dict(data["params"], jcfg).items()}
    extra = {"mask_token": torch.zeros(1, 1, 48), "prediction_head.weight": torch.zeros(2),
             "sobel_x": torch.zeros(3, 3), "edge_weight": torch.tensor(0.3),
             "model.dec_blocks.5.norm1.weight": torch.zeros(48),
             "model.enc_blocks.2.attn.qkv.weight": torch.zeros(3),
             "model.downstream_head1.dpt.scratch.refinenet4.resConfUnit1.conv1.weight":
                 torch.zeros(1)}
    wrapped = {**{f"model.{k}": v for k, v in sd.items()}, **extra}
    model_sd, head = from_pth.split_checkpoint(wrapped, tcfg)
    assert sorted(model_sd) == sorted(sd) and sorted(head) == ["edge_weight"]
    InferenceEngine(tcfg, state_dict=model_sd, device="cpu")  # loads strictly
    with pytest.raises(RuntimeError, match="Unexpected key"):
        InferenceEngine(tcfg, state_dict={**sd, "head.extra": torch.zeros(1)}, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        from_pth.load_pth(str(tmp_path), tcfg)
    with pytest.raises(ValueError, match="unsupported"):
        from_pth.load_pth(str(tmp_path / "w.ckpt"), tcfg)


CLI_TINY = ["--img_size", "32", "32", "--model_preset", "tiny", "--compute_dtype", "float32"]


@pytest.mark.parametrize("layout", ["plain", "wrapper"])
def test_cli_infer_matches_jax(data, tmp_path, layout):
    """cli.infer --no_vis on the directory (6 of 7 frames decode): the same
    {base}_depth.npy files as the JAX CLI on the same .pth."""
    from thermal3d.cli.infer import main as jax_main
    from thermal3d_torch.cli.infer import main

    argv = ["--img_path", data["frames"], "--weights", data["pth"][layout], "--no_vis",
            "--batch_size", str(BATCH), *CLI_TINY]
    main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    jax_main(argv + ["--output_dir", str(tmp_path / "j")])
    files = _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(files) == 6


@pytest.mark.parametrize("mode", ["pairs", "test_set"])
def test_cli_pseudo_gt_matches_jax(data, tmp_path, mode):
    """cli.pseudo_gt on the tree (pairs with a calibration file, or
    --test_set): the same files as the JAX CLI on the same .pth."""
    from thermal3d.cli.pseudo_gt import main as jax_main
    from thermal3d_torch.cli.pseudo_gt import main

    argv = ["--dataset_dir", data["ds"], "--weights", data["pth"]["mastr"], "--frame_skip", "1",
            "--batch_size", str(BATCH), *CLI_TINY]
    argv += ["--test_set"] if mode == "test_set" else ["--calib_file", data["calib"]]
    n = main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert n == jax_main(argv + ["--output_dir", str(tmp_path / "j")]) == (
        5 if mode == "test_set" else 4)
    _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"))
    if mode == "pairs":
        for p in glob.glob(str(tmp_path / "t" / "intrinsics" / "*.npy")):
            np.testing.assert_array_equal(np.load(p), [[30.0, 0, 16.0], [0, 31.0, 15.5],
                                                       [0, 0, 1]])


def test_cli_evaluate_matches_jax(data, tmp_path):
    """cli.evaluate --no_vis with the wrapper .pth: the same metrics files and
    summary text as the JAX CLI."""
    from thermal3d.cli.evaluate import main as jax_main
    from thermal3d_torch.cli.evaluate import main

    argv = ["--thermal_dir", data["frames"], "--pseudo_gt_dir", data["gt"], "--model",
            data["pth"]["wrapper"], "--no_vis", "--batch_size", str(BATCH), *CLI_TINY]
    got = main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    ref = jax_main(argv + ["--output_dir", str(tmp_path / "j")])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)
    files = _compare_trees(str(tmp_path / "t"), str(tmp_path / "j"), "*.txt")
    assert "metrics_summary.txt" in files and len(files) == 7


def test_evaluate_wrapper_equals_the_direct_cli_call(data, tmp_path):
    """scripts/torch_run_evaluate_thermal_dustr.sh with MODEL at the wrapper
    .pth and the tiny preset on the CPU passed on (with --no_vis): exit 0
    and the same files, byte for byte, as cli.evaluate called with the same
    arguments."""
    from thermal3d_torch.cli.evaluate import main

    tiny = ["--no_vis", "--batch_size", str(BATCH), *CLI_TINY, "--device", "cpu"]
    out = tmp_path / "wrapper"
    proc = run_wrapper("torch_run_evaluate_thermal_dustr.sh", tmp_path, tiny, env={
        "MODEL": data["pth"]["wrapper"], "THERMAL_DIR": data["frames"],
        "PSEUDO_GT_DIR": data["gt"], "OUTPUT_DIR": str(out)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    main(["--model", data["pth"]["wrapper"], "--thermal_dir", data["frames"], "--pseudo_gt_dir",
          data["gt"], "--output_dir", str(tmp_path / "direct"), "--img_size", "224", "224",
          *tiny])
    names = sorted(os.listdir(tmp_path / "direct"))
    assert sorted(os.listdir(out)) == names and "metrics_summary.txt" in names
    for name in names:
        assert (out / name).read_bytes() == (tmp_path / "direct" / name).read_bytes(), name


@pytest.mark.parametrize("cli,argv", [
    ("infer", ["--img_path", "x.png", "--no_vis", "--int8_static_acts"]),
    ("infer", ["--img_path", "x.png", "--int8_equalize"]),
    ("infer", ["--img_path", "x.png", "--advanced_fire", "--ndev", "2"]),
    ("infer", ["--img_path", "x.png", "--fire_scene", "--ndev", "2"]),
    ("infer", ["--img_path", "x.png", "--no_vis", "--ndev", "2"]),
    ("infer", ["--img_path", "x.png", "--no_vis", "--int8_equalize", "--int8_static_acts"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--visualize",
                   "--int8_static_acts"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--ndev", "4"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--num_shards", "2",
                   "--shard_id", "2"]),
    ("evaluate", ["--thermal_dir", "t", "--pseudo_gt_dir", "g", "--output_dir", "o",
                  "--ndev", "4"]),
    ("evaluate", ["--thermal_dir", "t", "--pseudo_gt_dir", "g", "--output_dir", "o",
                  "--no_vis", "--ndev", "2"]),
])
def test_cli_unported_options_are_parser_errors(cli, argv, capsys):
    """Options that do not combine stop at the parser before any model is
    built: --int8_static_acts and --int8_equalize without --int8, --ndev > 1
    with the fire modes or with more devices than the host has (here the JAX
    CLIs' texts: the live --ndev runs are in tests/test_torch_mesh.py), and a
    --shard_id out of range, as in the JAX CLIs (the live --int8 modes are
    held in tests/test_torch_quant.py)."""
    import importlib

    main = importlib.import_module(f"thermal3d_torch.cli.{cli}").main
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("--shard_id" in err or "require --int8" in err
            or "supports only the directory-batch monocular path" in err
            or "devices available" in err)


def test_stereo_cli_matches_engine(data, tmp_path):
    """--img_path2: one binocular pass on the two full-resolution frames."""
    from thermal3d_torch.cli.infer import main
    from thermal3d_torch.preprocess.io import load_thermal_image

    a, b = data["paths"][0], data["paths"][1]
    main(["--img_path", a, "--img_path2", b, "--weights", data["pth"]["wrapper"], "--no_vis",
          "--output_dir", str(tmp_path), "--device", "cpu", *CLI_TINY])
    _, teng = _engines(data)
    want = teng.infer(load_thermal_image(a)[None], load_thermal_image(b)[None])["depth"][0]
    base = os.path.splitext(os.path.basename(a))[0]
    np.testing.assert_array_equal(np.load(tmp_path / f"{base}_depth.npy"), want)


def test_metrics_default_device_is_cuda(monkeypatch):
    """No hidden CPU fallback: without CUDA the metrics raise unless the CPU
    is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_depth_metrics(np.ones((2, 2)), np.ones((2, 2)))
