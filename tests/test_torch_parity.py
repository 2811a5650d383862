"""The port's parity gate (thermal3d_torch.evaluation.parity, cli.parity and
its oracle copy) against the JAX package's, on the same synthetic depth
trees, golden sets and .pth weights: the same report dicts, keys and exit
codes in every mode, and the oracle copy equal to the JAX package's test
oracle on the same state dict.

Tiny models in float32; the .pth is a JAX model exported with
thermal3d.convert.flax_to_torch.export_state_dict (the golden-mode tests)
or the test oracle's own state dict (the full gate, as the JAX tests do).
Metrics agree to rtol 1e-4 of each value (float32 summation orders differ
between XLA and PyTorch); dir-mode reports to 1e-6 (one float32 median
scaling, then float64 numpy on both sides).
"""

import dataclasses
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_common import TINY_KW, configs, drawn_params
from thermal3d.cli.parity import main as jax_main
from thermal3d.convert.flax_to_torch import export_state_dict
from thermal3d.evaluation import parity as jax_parity
from thermal3d_torch.cli.parity import main
from thermal3d_torch.evaluation import oracle, parity

RTOL = 1e-4
TINY_ARGS = ["--model_preset", "tiny", "--img_size", "64", "64", "--compute_dtype", "float32",
             "--batch_size", "2"]


def _jax_test_oracle():
    spec = importlib.util.spec_from_file_location(
        "_t3d_test_oracle", os.path.join(os.path.dirname(__file__), "torch_oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(got, ref, rtol, path="report"):
    """Equal structure, equal non-float leaves, floats to rtol (NaN = NaN;
    atol rtol/10 for the values near 0, such as a drift of a metric from
    itself)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, float):
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol / 10, err_msg=path)
    else:
        assert got == ref, path


@pytest.fixture
def depth_pair(tmp_path):
    rng = np.random.default_rng(0)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir(), theirs.mkdir()
    for i in range(3):
        d = rng.uniform(1.0, 10.0, (16, 16)).astype(np.float32)
        np.save(theirs / f"f_{i}_depth.npy", d)
        np.save(ours / f"f_{i}_depth.npy", d)
    return ours, theirs


@pytest.mark.parametrize("case", ["equal", "drift", "noise", "nonpositive"])
def test_compare_depth_arrays_matches_jax(case):
    rng = np.random.default_rng(1)
    theirs = rng.uniform(0.5, 20.0, (24, 20)).astype(np.float32)
    ours = theirs.copy()
    if case == "drift":
        ours[::2] *= 1.5
    elif case == "noise":
        ours = ours * (1 + 1e-3 * rng.standard_normal(ours.shape)).astype(np.float32)
    elif case == "nonpositive":
        theirs[:3] = 0.0
        theirs[4, 4] = -1.0
        ours = theirs.copy()
    got = parity.compare_depth_arrays(ours, theirs, device="cpu")
    ref = jax_parity.compare_depth_arrays(ours, theirs)
    _assert_same(got, ref, 1e-6)
    assert got["bit_equal"] == (case in ("equal", "nonpositive"))


def test_compare_depth_dirs_matches_jax(depth_pair, tmp_path):
    """Bit-equal trees, then a perturbed frame and a missing one: the same
    per-frame and summary dicts, and the same report file."""
    ours, theirs = depth_pair
    for name in ("p.json", "j.json"):
        assert not (tmp_path / name).exists()
    got = parity.compare_depth_dirs(str(ours), str(theirs), report_path=str(tmp_path / "p.json"),
                                    device="cpu")
    ref = jax_parity.compare_depth_dirs(str(ours), str(theirs),
                                        report_path=str(tmp_path / "j.json"))
    _assert_same(got, ref, 1e-6)
    assert got["summary"]["all_bit_equal"] and got["summary"]["within_1pct_abs_rel"]
    _assert_same(json.load(open(tmp_path / "p.json")), json.load(open(tmp_path / "j.json")), 1e-6)
    d = np.load(ours / "f_0_depth.npy")
    d[::2] *= 1.5
    np.save(ours / "f_0_depth.npy", d)
    os.remove(ours / "f_1_depth.npy")
    got = parity.compare_depth_dirs(str(ours), str(theirs), device="cpu")
    ref = jax_parity.compare_depth_dirs(str(ours), str(theirs))
    _assert_same(got, ref, 1e-6)
    assert got["per_frame"]["f_1_depth.npy"] == {"missing": True}
    assert got["summary"]["n_missing"] == 1 and not got["summary"]["all_bit_equal"]


def _run(fn, argv):
    """(exit code, report or None, printed lines) of a CLI main."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            report, code = fn(argv), 0
        except SystemExit as e:
            report, code = None, e.code
    return code, report, buf.getvalue().splitlines()


@pytest.mark.parametrize("mode", ["pass", "drift", "missing"])
def test_cli_dir_mode_matches_jax(depth_pair, tmp_path, mode):
    ours, theirs = depth_pair
    if mode == "drift":
        for f in os.listdir(ours):
            d = np.load(ours / f)
            d[::2] *= 1.5
            np.save(ours / f, d)
    elif mode == "missing":
        os.remove(ours / "f_1_depth.npy")
    argv = ["--ours_dir", str(ours), "--theirs_dir", str(theirs)]
    code, _, lines = _run(main, argv + ["--report", str(tmp_path / "p.json"), "--device", "cpu"])
    jcode, _, jlines = _run(jax_main, argv + ["--report", str(tmp_path / "j.json")])
    assert code == jcode == (0 if mode == "pass" else 1)
    assert lines[-1] == jlines[-1]
    _assert_same(json.load(open(tmp_path / "p.json")), json.load(open(tmp_path / "j.json")), 1e-6)


@pytest.mark.parametrize("argv", [
    ["--ours_dir", "o"],
    ["--ours_dir", "o", "--theirs_dir", "o", "--int8"],
    ["--model", "m.pth"],
    ["--full-gate", "--model", "m.pth"],
    [],
])
def test_cli_half_specified_modes_are_parser_errors(argv):
    """As in the JAX CLI: a CI gate must not print PASS for a comparison
    that never ran."""
    assert _run(main, argv)[0] == _run(jax_main, argv)[0] == 2


def test_cli_unported_flags_are_parser_errors(capsys):
    for argv in (["--ours_dir", "o", "--theirs_dir", "o", "--ndev", "2"],
                 ["--ours_dir", "o", "--theirs_dir", "o", "--scan_layers", "--ndev", "4"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        err = capsys.readouterr().err  # --ndev: the JAX parity CLI has none
        assert e.value.code == 2 and "on one device" in err


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """A golden set of 3 frames (uint16 PNGs at 64x80, golden depths at 32x32)
    and the tiny DUSt3R-224 model exported by the JAX package to a .pth."""
    root = tmp_path_factory.mktemp("golden")
    rng = np.random.default_rng(2)
    gdir = root / "golden"
    gdir.mkdir()
    for i in range(3):
        ts = f"157000000{i}_1234{i}"
        png = root / f"fl_ir_aligned_{ts}_ir.png"
        ramp = np.linspace(0, 1, 80)[None, :]
        cv2.imwrite(str(png), (21000 + 5000 * (0.6 * ramp + 0.4 * rng.uniform(size=(64, 80))))
                    .astype(np.uint16))
        base = f"fl_ir_aligned_{ts}0_rgb"
        np.save(gdir / f"{base}_depth.npy", rng.uniform(1.0, 10.0, (32, 32)).astype(np.float32))
        (gdir / f"{base}_thermal_path.txt").write_text(str(png))
    jcfg, _ = configs(**dict(TINY_KW, img_size=(64, 64)))
    pth = root / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in
                          export_state_dict(drawn_params(jcfg, seed=4), jcfg).items()}}, pth)
    return dict(dir=str(gdir), root=root, pth=str(pth))


@pytest.mark.parametrize("extra,want_code", [
    ([], 0),
    (["--reference_metrics", "REF_OK"], 0),
    (["--reference_metrics", "REF_BAD"], 1),
    (["--max_frames", "2", "--remap", "fl_ir=fl_ir"], 0),
])
def test_cli_golden_mode_matches_jax(golden, tmp_path, extra, want_code):
    """--model/--golden_dir with the same .pth: the same exit code, report
    keys and metrics, and the same verdict line. REF_OK is a reference the
    model meets (the JAX AbsRel itself), REF_BAD one it cannot."""
    argv = ["--golden_dir", golden["dir"], "--model", golden["pth"], *TINY_ARGS]
    refs = {"REF_OK": tmp_path / "ok.json", "REF_BAD": tmp_path / "bad.json"}
    refs["REF_BAD"].write_text(json.dumps({"abs_rel": 1e-6}))
    if "REF_OK" in extra:
        refs["REF_OK"].write_text(json.dumps({"abs_rel": _run(jax_main, argv)[1]
                                              ["golden_bf16"]["abs_rel"]}))
    argv += [str(refs.get(a, a)) for a in extra]
    jcode, _, jlines = _run(jax_main, argv + ["--report", str(tmp_path / "j.json")])
    code, _, lines = _run(main, argv + ["--report", str(tmp_path / "p.json"), "--device", "cpu"])
    assert code == jcode == want_code
    _assert_same(json.load(open(tmp_path / "p.json")), json.load(open(tmp_path / "j.json")),
                 RTOL)
    assert lines[-1] == jlines[-1] == ("PARITY GATE PASSED" if want_code == 0 else
                                       "PARITY GATE FAILED: reference AbsRel drift gate")


@pytest.mark.parametrize("scope", ["fc1", "all"])
def test_cli_golden_int8_gate_matches_jax(golden, scope):
    """--int8: both engines run and the int8 drift is reported and gated,
    with JAX's report keys and float metrics on the same .pth. (The JAX
    CLI's int8 engine pins 'auto' attention to bf16 scores, a TPU policy the
    port does not carry over, so its int8 numbers are not the port's; the
    int8 engines are held to each other in tests/test_torch_quant.py, with
    JAX attention 'xla'.)"""
    argv = ["--golden_dir", golden["dir"], "--model", golden["pth"], *TINY_ARGS, "--int8",
            "--int8_scope", scope, "--gate", "10.0"]
    code, rep, _ = _run(main, argv + ["--device", "cpu"])
    jcode, jrep, _ = _run(jax_main, argv)
    assert code == jcode == 0
    assert sorted(rep) == sorted(jrep) == ["golden_bf16", "golden_int8", "int8_abs_rel_drift"]
    _assert_same(rep["golden_bf16"], jrep["golden_bf16"], RTOL)
    assert sorted(rep["golden_int8"]) == sorted(jrep["golden_int8"])
    assert rep["golden_int8"]["abs_rel"] != rep["golden_bf16"]["abs_rel"]
    assert rep["int8_abs_rel_drift"] == abs(rep["golden_int8"]["abs_rel"] - rep[
        "golden_bf16"]["abs_rel"]) / rep["golden_bf16"]["abs_rel"]
    # a gate below the drift fails the command, as in the JAX CLI
    tight = argv[:-1] + [str(rep["int8_abs_rel_drift"] / 2)]
    assert _run(main, tight + ["--device", "cpu"])[2][-1] == "PARITY GATE FAILED: int8 drift gate"


@pytest.mark.parametrize("variant", ["dustr224_linear", "mastr512_catmlpdpt"])
def test_cli_full_gate_matches_jax(golden, tmp_path, variant):
    """--full-gate on a tiny oracle-layout checkpoint (the JAX tests' stand-in
    for the released .pth): the convert and oracle stages pass, the oracle's
    worst layer stays within 2e-4, the same stages and JSON line as the JAX
    CLI; an impossible --oracle_tol fails the command."""
    from thermal3d.cli.common import apply_preset as jax_preset
    from thermal3d.core.config import DUSTR_224_LINEAR, MASTR_512_CATMLPDPT

    base = {"dustr224_linear": DUSTR_224_LINEAR, "mastr512_catmlpdpt": MASTR_512_CATMLPDPT}
    cfg = jax_preset(base[variant], "tiny", (64, 64), "float32")
    torch.manual_seed(0)
    ckpt = tmp_path / "tiny_real.pth"
    torch.save({"model": dict(_jax_test_oracle().TorchDustr(cfg).eval().state_dict())}, ckpt)
    argv = ["--full-gate", "--model", str(ckpt), "--golden_dir", golden["dir"],
            "--model_variant", variant, *TINY_ARGS, "--gate", "10.0"]
    code, rep, lines = _run(main, argv + ["--device", "cpu"])
    jcode, jrep, jlines = _run(jax_main, argv)
    assert code == jcode == 0
    assert sorted(rep) == sorted(jrep)
    assert rep["full_gate_convert"] == jrep["full_gate_convert"]
    assert rep["full_gate_oracle"]["ok"] and rep["full_gate_oracle"]["worst_rel"] <= 2e-4
    assert rep["full_gate_oracle"]["layers"] == jrep["full_gate_oracle"]["layers"]
    _assert_same(rep["golden_bf16"], jrep["golden_bf16"], RTOL)
    assert "int8_abs_rel_drift" in rep
    line = [ln for ln in lines if ln.startswith("{")][-1]
    assert line == [ln for ln in jlines if ln.startswith("{")][-1]
    assert json.loads(line) == {"full_gate": "PASS", "stages": {
        "convert": "pass", "oracle": "pass", "golden_metrics": "pass", "int8_drift": "pass"}}
    assert _run(main, argv + ["--oracle_tol", "0.0", "--device", "cpu"])[0] == 1


def test_cli_full_gate_broken_checkpoint_skips_cleanly(golden, tmp_path):
    """A checkpoint the strict load rejects fails the gate with the JSON line
    (later stages 'skipped'), exit 1, never a traceback: as the JAX CLI."""
    ckpt = tmp_path / "broken.pth"
    torch.save({"model": {"totally_unknown.weight": torch.zeros(3)}}, ckpt)
    argv = ["--full-gate", "--model", str(ckpt), "--golden_dir", golden["dir"], *TINY_ARGS]
    code, _, lines = _run(main, argv + ["--device", "cpu"])
    jcode, _, jlines = _run(jax_main, argv)
    assert code == jcode == 1
    line = [ln for ln in lines if ln.startswith("{")][-1]
    assert line == [ln for ln in jlines if ln.startswith("{")][-1]
    assert json.loads(line)["stages"] == {"convert": "fail", "oracle": "skipped",
                                          "golden_metrics": "skipped", "int8_drift": "skipped"}


@pytest.mark.parametrize("variant", ["dustr224_linear", "dustr512_dpt", "mastr512_catmlpdpt"])
def test_oracle_copy_matches_the_jax_test_oracle(variant):
    """The port's oracle copy and the JAX package's test oracle on the same
    state dict and images: every captured layer and every output equal, so
    the two copies cannot drift apart."""
    from thermal3d.cli.common import apply_preset as jax_preset
    from thermal3d.core.config import DUSTR_224_LINEAR, DUSTR_512_DPT, MASTR_512_CATMLPDPT
    from thermal3d_torch.cli.common import apply_preset
    from thermal3d_torch.core import config as tconfig

    jbase = {"dustr224_linear": DUSTR_224_LINEAR, "dustr512_dpt": DUSTR_512_DPT,
             "mastr512_catmlpdpt": MASTR_512_CATMLPDPT}[variant]
    tbase = {"dustr224_linear": tconfig.DUSTR_224_LINEAR, "dustr512_dpt": tconfig.DUSTR_512_DPT,
             "mastr512_catmlpdpt": tconfig.MASTR_512_CATMLPDPT}[variant]
    ref_mod = _jax_test_oracle()
    torch.manual_seed(3)
    ref = ref_mod.TorchDustr(jax_preset(jbase, "tiny", (64, 64), "float32")).eval()
    ours = oracle.OracleDustr(apply_preset(tbase, "tiny", (64, 64), "float32")).eval()
    ours.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(5)
    img1, img2 = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    ref_acts, ref_out = ref_mod.capture_torch_activations(ref, img1, img2)
    acts, out = oracle.capture_oracle_activations(ours, img1, img2)
    assert sorted(acts) == sorted(ref_acts)
    for name in ref_acts:
        for a, b in zip(acts[name], ref_acts[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    flat = (lambda o: [o[0], o[1]] if isinstance(o, tuple) else [o[k] for k in sorted(o)])
    for a, b in zip(flat(out[0]) + flat(out[1]), flat(ref_out[0]) + flat(ref_out[1])):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_oracle_agrees_with_the_port_model_layer_by_layer():
    """The capture of the port's model on the oracle's state dict: the same
    layer names and calls, each within 2e-4 of the activation scale (the
    full gate's bar), at two decoder depths."""
    from thermal3d_torch.cli.common import apply_preset
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.models.dustr import frozen_model

    cfg = dataclasses.replace(apply_preset(DUSTR_224_LINEAR, "tiny", (64, 64), "float32"),
                              dec_depth=3)
    torch.manual_seed(4)
    ref = oracle.OracleDustr(cfg).eval()
    model = frozen_model(cfg, torch.device("cpu"), ref.state_dict())
    rng = np.random.default_rng(6)
    img1, img2 = (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    t_acts, _ = oracle.capture_oracle_activations(ref, img1, img2)
    m_acts, _ = oracle.capture_model_activations(model, img1, img2)
    assert sorted(t_acts) == sorted(m_acts)
    assert len(m_acts["decoder_embed"]) == len(m_acts["dec_norm"]) == 2
    drift = oracle.per_layer_drift(t_acts, m_acts)
    assert len(drift) == 2 + 2 * 3 + 3 and all(
        delta <= 2e-4 * max(1.0, scale) for delta, scale in drift.values()), drift
