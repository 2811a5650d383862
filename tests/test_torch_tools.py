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


# The span tree of one request (core/profiling.py): span → its parent.
ENGINE_SPANS = {"pipeline.stage": None, "engine.request": None,
                "engine.preprocess": "engine.request", "engine.thermal_head": "engine.request",
                "model.encoder": "engine.request", "model.decoder": "engine.request",
                "model.heads": "engine.request", "pipeline.fetch_start": None,
                "pipeline.fetch": None}
PGT_SPANS = {"pipeline.stage": None, "pgt.request": None, "model.encoder": "pgt.request",
             "model.decoder": "pgt.request", "model.heads": "pgt.request",
             "pgt.geometry": "pgt.request", "geometry.intrinsics": "pgt.geometry",
             "geometry.pose": "pgt.geometry", "pipeline.fetch_start": None,
             "pipeline.fetch": None}


def _tiny_program(path):
    """(the program's async call, one request's inputs) at a tiny size."""
    from thermal3d_torch.core.config import TINY, HeadConfig
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    rng = np.random.default_rng(0)
    if path == "engine":
        engine = InferenceEngine(TINY, device="cpu")
        return engine.infer_async, {"frames": rng.uniform(0, 1, (2, 40, 48)).astype(np.float32)}
    head = HeadConfig(head_type="catmlpdpt", feature_dim=32, last_dim=16,
                      dpt_layer_dims=(8, 16, 24, 32), local_feat_dim=6)
    gen = PseudoGTGenerator(dataclasses.replace(TINY, head=head), batch_size=2, device="cpu")
    views = {k: rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for k in ("a", "b")}
    return (lambda a, b: gen.run_pairs_async(a, b)), views


def test_annotate_is_a_shared_no_op_when_off():
    from thermal3d_torch.core import profiling

    profiling.clear()
    off = profiling.annotate("a")
    assert off is profiling.annotate("b", "cpu", request=profiling.NEW_REQUEST)
    with off as span:
        assert span is None
    engine_call, inputs = _tiny_program("engine")
    engine_call(inputs["frames"])
    assert profiling.spans() == [] and profiling.current() is None


@pytest.mark.parametrize("path", ["engine", "generator"])
def test_spans_under_trace_follow_the_layers(path, tmp_path):
    """Two requests through PinnedStage → the entry's async call →
    PinnedFetch under trace(): each span once a request with its parent, the
    request's id on every span but the staging, self time = host time less
    the children's."""
    from thermal3d_torch.core import profiling
    from thermal3d_torch.data.pipeline import PinnedFetch, PinnedStage

    call, inputs = _tiny_program(path)
    expected = ENGINE_SPANS if path == "engine" else PGT_SPANS
    cpu = torch.device("cpu")
    stage, fetch = PinnedStage(cpu), PinnedFetch(cpu)
    profiling.clear()
    with profiling.trace(str(tmp_path / "trace")):
        for _ in range(2):
            fetch.finish(fetch.start(call(*stage.put(inputs).values())))
    spans = profiling.spans()
    assert len(spans) == 2 * len(expected)
    assert [s.name for s in spans[:len(expected)]] == list(expected)
    assert {s.name: s.parent and s.parent.name for s in spans} == expected
    assert all(s.end_ns >= s.start_ns and s.events is None for s in spans)
    n = len(expected)
    ids = [{s.request for s in half if s.name != "pipeline.stage"}
           for half in (spans[:n], spans[n:])]
    assert [len(i) for i in ids] == [1, 1] and ids[0] != ids[1]
    assert profiling.request_ids() == ids[0] | ids[1]
    assert all(s.request is None for s in spans if s.name == "pipeline.stage")
    totals = profiling.totals()
    assert set(totals) == set(expected)
    entry = "engine.request" if path == "engine" else "pgt.request"
    kids = sum(s.host_ms for s in spans if s.parent is not None and s.parent.name == entry)
    assert totals[entry]["self_ms"] == pytest.approx(totals[entry]["host_ms"] - kids, abs=1e-6)
    assert 0 <= totals[entry]["self_ms"] < totals[entry]["host_ms"]
    for name, t in totals.items():
        assert t["count"] == 2 and t["device_ms"] is None
        assert t["requests"] == (0 if name == "pipeline.stage" else 2)


def test_span_ops_are_not_user_annotations(tmp_path):
    """A span is a CPU op of the profiler that is no user annotation, so
    Kineto copies nothing of it onto the device timeline."""
    from torch.autograd import DeviceType

    from thermal3d_torch.core.profiling import annotate, trace

    with trace(str(tmp_path / "trace")) as prof:
        with annotate("layer.outer"):
            with annotate("layer.inner"):
                _ = torch.ones(8, 8) @ torch.ones(8, 8)
    events = [e for e in prof.events() if e.name.startswith("layer.")]
    assert sorted(e.name for e in events) == ["layer.inner", "layer.outer"]
    assert all(not e.is_user_annotation and e.device_type == DeviceType.CPU for e in events)


def test_annotate_is_off_while_compiling():
    """Inside a torch.export trace spans are off even under a profiler: the
    exported program holds no profiler op."""
    from thermal3d_torch.core import profiling

    class M(torch.nn.Module):
        def forward(self, x):
            with profiling.annotate("layer.traced", x.device):
                return x * 2

    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        exported = torch.export.export(M(), (torch.ones(3),), strict=False)
        assert profiling.spans() == []
        with profiling.annotate("layer.eager"):
            pass
    assert [s.name for s in profiling.spans()] == ["layer.eager"]
    assert "profiler" not in str(exported.graph)
    torch.testing.assert_close(exported.module()(torch.ones(3)), torch.full((3,), 2.0))


def test_spans_on_two_threads_keep_separate_parents():
    """Threads handed the caller's span by within() record (torch's profiler
    records on its own thread only) and nest their spans in stacks of their
    own, while the caller opens spans of its own at the same time; all take
    the caller's request id. A thread handed nothing records nothing."""
    import threading

    from thermal3d_torch.core import profiling

    barrier = threading.Barrier(3, timeout=20)

    def work(tag, root):
        with profiling.within(root):
            with profiling.annotate(f"outer.{tag}"):
                barrier.wait()  # every thread's outer span is open at once
                with profiling.annotate(f"inner.{tag}"):
                    barrier.wait()

    def unhanded():
        with profiling.annotate("unhanded"):
            pass

    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("root", request=profiling.NEW_REQUEST) as root:
            threads = [threading.Thread(target=work, args=(t, root)) for t in "ab"]
            threads.append(threading.Thread(target=unhanded))
            for t in threads:
                t.start()
            with profiling.annotate("main"):
                barrier.wait()
                barrier.wait()
            for t in threads:
                t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in profiling.spans()}
    assert set(by_name) == {"root", "main", "outer.a", "outer.b", "inner.a", "inner.b"}
    for tag in "ab":
        assert by_name[f"inner.{tag}"].parent is by_name[f"outer.{tag}"]
        assert by_name[f"outer.{tag}"].parent is root
    assert by_name["main"].parent is root and root.parent is None
    assert {s.request for s in by_name.values()} == {root.request}
    assert profiling.current() is None


def test_mesh_chunk_spans_take_the_callers_request():
    """Over [cpu, cpu:0, cpu, cpu:0] run_on_mesh runs a thread a device; the
    chunks' spans still have engine.request as parent and share its id."""
    from thermal3d_torch.core import profiling
    from thermal3d_torch.core.config import TINY
    from thermal3d_torch.core.mesh import make_mesh
    from thermal3d_torch.infer.engine import InferenceEngine

    devices = [torch.device("cpu"), torch.device("cpu", 0)] * 2
    engine = InferenceEngine(TINY, device="cpu",
                             mesh=make_mesh((4,), ("data",), devices=devices))
    frames = np.random.default_rng(1).uniform(0, 1, (4, 40, 48)).astype(np.float32)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.infer_async(frames)
    spans = profiling.spans()
    (entry,) = [s for s in spans if s.name == "engine.request"]
    chunks = [s for s in spans if s is not entry]
    assert sorted({s.name for s in chunks}) == sorted(
        n for n, parent in ENGINE_SPANS.items() if parent == "engine.request")
    assert len(chunks) == 4 * 5
    assert all(s.parent is entry and s.request == entry.request for s in chunks)


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
