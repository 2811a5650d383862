"""The port's serving artifact (thermal3d_torch/infer/export.py, cli/export.py)
and the kernels' ops (kernels/ops.py) on the CPU: the artifact against the
port's engine and against the JAX ServingArtifact on the same converted
weights, padding, stereo, int8, the loader without model code, the native
program's ops, and the resize cache under tracing."""

import dataclasses
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_common import (TINY_KW, configs, drawn_params, thermal_head_params,
                                     torch_state)
from thermal3d.infer.engine import InferenceEngine as JaxEngine
from thermal3d.infer.export import ServingArtifact as JaxArtifact
from thermal3d.infer.export import save_serving_artifact as jax_save
from thermal3d_torch.convert.from_jax import thermal_head_state_from_jax
from thermal3d_torch.infer.engine import InferenceEngine
from thermal3d_torch.infer.export import FORMAT, ServingArtifact, save_serving_artifact

RAW_HW = (24, 28)  # not the model's size, so the program's resize runs
BLOCKED = ("thermal3d_torch.models", "thermal3d_torch.infer.engine", "thermal3d_torch.convert",
           "thermal3d_torch.preprocess")


def _raw(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(21000.0, 26000.0, (n,) + RAW_HW).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs(**TINY_KW)
    params = drawn_params(jcfg, 0)
    return jcfg, tcfg, params, thermal_head_params()


def _engine(weights, **kw):
    _, tcfg, params, thp = weights
    return InferenceEngine(tcfg, state_dict=torch_state(params),
                           thermal_head_state=thermal_head_state_from_jax(thp), device="cpu",
                           **kw)


@pytest.fixture(scope="module")
def engine(weights):
    return _engine(weights)


@pytest.fixture(scope="module")
def artifacts(engine, tmp_path_factory):
    """The tiny engine exported once each way: portable (the default
    platforms) and native (platforms=None), batch 4 at RAW_HW."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name, platforms in (("portable", ("cpu", "cuda")), ("native", None)):
        path = str(root / f"{name}.npz")
        meta = save_serving_artifact(path, engine, batch_sizes=(4,), input_hw=RAW_HW,
                                     platforms=platforms)
        out[name] = (path, meta, ServingArtifact.load(path, device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_artifact(weights, tmp_path_factory):
    """The JAX engine on the same weights, exported by the JAX package."""
    jcfg, _, params, thp = weights
    path = str(tmp_path_factory.mktemp("jax") / "jax.npz")
    jax_save(path, JaxEngine(jcfg, params=params, thermal_head_params=thp), batch_sizes=(4,),
             input_hw=RAW_HW, platforms=None)
    return path


def _program(path, b):
    import thermal3d_torch.kernels.ops  # noqa: F401

    with np.load(path) as z:
        return torch.export.load(io.BytesIO(z[f"program_{b}"].tobytes()))


@pytest.mark.parametrize("kind", ["portable", "native"])
def test_artifact_matches_engine(artifacts, engine, kind):
    """Both programs restate the engine's computation on the CPU (the sort
    enhance, the plain attention; the native one behind the K2/K3 ops), so
    the outputs match the engine's to rtol 1e-6 (they read equal here)."""
    _, meta, art = artifacts[kind]
    raw = _raw()
    got, want = art.infer(raw), engine.infer(raw)
    assert set(got) == set(meta["outputs"]) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    assert meta["portable_program"] == (kind == "portable")
    assert meta["platforms"] == (["cpu", "cuda"] if kind == "portable" else ["cpu"])


def test_artifact_matches_jax_artifact(artifacts, jax_artifact):
    """The port's artifact against the JAX ServingArtifact exported from the
    JAX engine on the same weights: rtol 1e-4 of each output's scale, the
    port's parity tolerance (f32 sums in other orders, amplified by exp)."""
    raw = _raw(seed=1)
    ref = JaxArtifact.load(jax_artifact).infer(raw)
    got = artifacts["native"][2].infer(raw)
    for k in ref:
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_artifact_pads_short_batches(artifacts):
    art = artifacts["portable"][2]
    raw = _raw()
    full = art.infer(raw)
    short = art.infer(raw[:3])
    assert short["depth"].shape[0] == 3
    np.testing.assert_array_equal(short["depth"], full["depth"][:3])
    with pytest.raises(ValueError, match="largest exported"):
        art.infer(np.concatenate([raw, raw]))


def test_artifact_stereo(engine, tmp_path):
    path = str(tmp_path / "stereo.npz")
    save_serving_artifact(path, engine, batch_sizes=(2,), input_hw=RAW_HW, stereo=True)
    art = ServingArtifact.load(path, device="cpu")
    a, b = _raw(2, 2), _raw(2, 3)
    got, want = art.infer(a, b), engine.infer(a, b)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    with pytest.raises(ValueError, match="second view"):
        art.infer(a)


def test_artifact_int8(weights, engine, tmp_path):
    """The int8 weights and their scales ride the artifact: the program
    matches the int8 engine, not the float one."""
    int8 = _engine(weights, quantize_int8=True)
    path = str(tmp_path / "int8.npz")
    meta = save_serving_artifact(path, int8, batch_sizes=(4,), input_hw=RAW_HW)
    assert meta["int8"] and "int8" in {w["dtype"] for w in meta["weights"]}
    raw = _raw()
    got = ServingArtifact.load(path, device="cpu").infer(raw)
    want = int8.infer(raw)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6, atol=0)
    assert not np.allclose(got["depth"], engine.infer(raw)["depth"], rtol=1e-5, atol=1e-6)


def test_artifact_rejects_wrong_shape_and_format(artifacts, jax_artifact, tmp_path):
    """Bad frames, the other package's artifact (each loader with the JAX
    loader's text) and a native artifact on another device type."""
    path, _, art = artifacts["portable"]
    with pytest.raises(ValueError, match="raw frames"):
        art.infer(_raw()[:, :12, :])
    with pytest.raises(ValueError, match="empty batch"):
        art.infer(_raw()[:0])
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, meta=np.frombuffer(b'{"format": "nope"}', dtype=np.uint8))
    with pytest.raises(ValueError, match=f"not a {FORMAT} artifact"):
        ServingArtifact.load(str(bogus), device="cpu")
    with pytest.raises(ValueError, match="not a thermal3d-serving-v1 artifact "
                                         rf"\(format='{FORMAT}'\)"):
        JaxArtifact.load(path)
    with pytest.raises(ValueError, match=f"not a {FORMAT} artifact "
                                         r"\(format='thermal3d-serving-v1'\)"):
        ServingArtifact.load(jax_artifact, device="cpu")
    with pytest.raises(ValueError, match="native cpu artifact cannot serve on cuda"):
        ServingArtifact.load(artifacts["native"][0], device="cuda")


def test_loader_imports_without_model_code(artifacts, tmp_path):
    """The deployment contract: `ServingArtifact` loads and serves both
    artifacts in a fresh process where the port's models, engine, converters
    and preprocessing cannot be imported, and jax is never imported. The
    sub-packages `thermal3d_torch.infer` (lazy) and `thermal3d_torch.core`
    (with their re-exports) import there too."""
    raw = _raw()
    np.save(tmp_path / "frames.npy", raw)
    code = f"""
import sys

BLOCKED = {BLOCKED!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(BLOCKED) or name.split(".")[0] in ("jax", "thermal3d"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import thermal3d_torch.core
import thermal3d_torch.infer
from thermal3d_torch.infer import ServingArtifact
raw = np.load({str(tmp_path / "frames.npy")!r})
for path in {[artifacts[k][0] for k in ("portable", "native")]!r}:
    out = ServingArtifact.load(path, device="cpu").infer(raw)
    np.save(path + ".depth.npy", out["depth"])
assert not [m for m in sys.modules if m.startswith(BLOCKED) or m.split(".")[0] == "jax"]
print("MODEL_CODE_FREE_OK")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MODEL_CODE_FREE_OK" in proc.stdout
    for kind in ("portable", "native"):
        path, _, art = artifacts[kind]
        np.testing.assert_array_equal(np.load(path + ".depth.npy"), art.infer(raw)["depth"])


def test_native_program_holds_the_ops(artifacts):
    """platforms=None traces the engine's own route: K2/K3 become
    thermal3d_torch ops (2 encoder K2, 2·2 decoder K2 and 2·2 K3 at depth
    2); the portable program holds none. Neither owns a weight: each
    program's state_dict is empty, it keeps no example inputs (they would
    be the weights), and no constant it holds is a weight."""
    ops = {}
    for kind in ("portable", "native"):
        path, meta, _ = artifacts[kind]
        program = _program(path, 4)
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        ops[kind] = sorted(t for t in targets if t.startswith("thermal3d_torch."))
        assert program.state_dict == {} and program.example_inputs is None
        with np.load(path) as z:
            stored = [z[f"w_{i:05d}"] for i in range(meta["num_weights"])]
        weight_bytes = sum(w.nbytes for w in stored)
        const_bytes = sum(c.numel() * c.element_size() for c in program.constants.values())
        assert const_bytes < 0.01 * weight_bytes, (const_bytes, weight_bytes)
        shapes = {tuple(w["shape"]) for w in meta["weights"]}
        assert not [k for k, c in program.constants.items()
                    if tuple(c.shape) in shapes and c.numel() > 4]
    assert ops["portable"] == []
    assert ops["native"] == (["thermal3d_torch.fused_rope_attention.default"] * 6
                             + ["thermal3d_torch.fused_rope_cross_attention.default"] * 4)
    # the served module keeps no dtype check and no cast of a tensor to its
    # own dtype (test_artifact_matches_engine holds its outputs)
    for kind in ("portable", "native"):
        nodes = [n for n in artifacts[kind][2]._fns[4].graph.nodes if n.op == "call_function"]
        assert not [n for n in nodes if n.target is torch.ops.aten._assert_tensor_metadata.default]
        assert not [n for n in nodes if n.target is torch.ops.aten.to.dtype
                    and n.args[0].meta["val"].dtype == n.args[1]]


def test_export_cli(tmp_path):
    from thermal3d_torch.cli.export import main

    out = str(tmp_path / "cli.npz")
    meta = main(["--out", out, "--batch_sizes", "2", "--input_hw", *map(str, RAW_HW),
                 "--model_preset", "tiny", "--img_size", "32", "32",
                 "--compute_dtype", "float32", "--device", "cpu", "--platforms", "native"])
    assert meta["platforms"] == ["cpu"] and not meta["portable_program"]
    depth = ServingArtifact.load(out, device="cpu").infer(_raw(2))["depth"]
    assert depth.shape == (2, 32, 32) and np.isfinite(depth).all()
    with pytest.raises(SystemExit):
        main(["--out", out, "--device", "cpu", "--ndev", "2"])


def test_export_leaves_resize_cache_real(engine, tmp_path):
    """A trace must not fill the resize matrices' cache with its fake
    tensors: after an export at a raw size the cache has not seen, the
    engine at that size returns real tensors, bit-equal to before."""
    from torch._subclasses.fake_tensor import FakeTensor

    from thermal3d_torch.preprocess import resize

    raw = np.random.default_rng(4).uniform(21000.0, 26000.0, (2, 20, 36)).astype(np.float32)
    before = engine.infer(raw)
    resize._cached_matrix.cache_clear()
    save_serving_artifact(str(tmp_path / "a.npz"), engine, batch_sizes=(2,), input_hw=(20, 36))
    out = engine.infer_async(raw)
    for k, v in out.items():
        assert type(v) is torch.Tensor and not isinstance(v, FakeTensor), k
        np.testing.assert_array_equal(v.numpy(), before[k], err_msg=k)


# ---------------------------------------------------------------------------
# the ops of kernels/ops.py on the CPU (their implementations: the plain
# versions; on the card the kernels, held in chip_smoke.py)
# ---------------------------------------------------------------------------

def _attention_inputs(b=2, s=16, h=2, d=8, seed=0):
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g)
    cos, sin = rope_tables(make_grid_positions(4, s // 4), d, 100.0)
    return qkv, cos, sin, h, 1.0 / d ** 0.5


def test_ops_match_the_wrappers():
    """Each op equals its wrapper bit for bit on the CPU, and passes
    torch.library.opcheck (schema, fake implementation against the real
    one)."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.kernels import image_ops, ops

    gray = torch.rand(3, 9, 11, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ops.percentile_enhance(gray, 2.0, 98.0),
                       image_ops.percentile_enhance(gray, 2.0, 98.0))
    qkv, cos, sin, h, scale = _attention_inputs()
    c = qkv.shape[-1] // 3
    q, k, v = (qkv[..., i * c:(i + 1) * c].contiguous() for i in range(3))
    assert torch.equal(ops.fused_rope_attention(qkv, cos, sin, h, scale),
                       fa.fused_rope_attention(qkv, cos, sin, h, scale))
    assert torch.equal(ops.fused_rope_cross_attention(q, k, v, cos, sin, h, scale),
                       fa.fused_rope_cross_attention(q, k, v, cos, sin, h, scale))
    cases = [((gray, 2.0, 98.0), ops.percentile_enhance),
             ((qkv, cos, sin, h, scale), ops.fused_rope_attention),
             ((q, k, v, cos, sin, h, scale), ops.fused_rope_cross_attention)]
    for args, op in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("entry", ["flash_attention_pallas", "flash_attention_grouped",
                                   "flash_attention_multihead"])
def test_softmax_attention_op_matches_wrapper(entry):
    """thermal3d_torch::softmax_attention for each K4-K6 entry equals the
    entry on [B, H, S, D] inputs and on the [B, S, H, D] views of
    attention_bshd, with q's layout kept (what the fake tells a trace)."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.kernels import ops

    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 10, 3, 8, generator=g) for _ in range(3))  # [B, S, H, D]
    fn = getattr(fa, entry)
    for args in ((q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous()),
                 (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))):
        got = ops.softmax_attention(*args, 0.3, entry)
        assert torch.equal(got, fn(*args, 0.3))
        assert got.stride() == torch.empty_like(args[0]).stride()
        torch.library.opcheck(ops.softmax_attention, (*args, 0.3, entry),
                              test_utils=("test_schema", "test_faketensor"))
    with pytest.raises(ValueError, match="unknown entry"):
        ops.softmax_attention(q, k, v, 0.3, "flash_attention")


def test_tracing_routes_through_the_ops_and_never_launches(monkeypatch):
    """Under a trace the wrappers call the ops (the plain versions are not
    traced in the kernels' place), and a launch reached while tracing
    raises."""
    from thermal3d_torch.kernels import _build
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")

    qkv, cos, sin, h, scale = _attention_inputs()

    class K2(torch.nn.Module):
        def forward(self, x):
            return fa.fused_rope_attention(x, cos, sin, h, scale)

    program = torch.export.export(K2(), (qkv,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets == ["thermal3d_torch.fused_rope_attention.default"]
    assert torch.equal(program.module()(qkv), fa.fused_rope_attention(qkv, cos, sin, h, scale))
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with pytest.raises(RuntimeError, match="reached while tracing"):
        _build.library("attention")


def test_export_validates_its_arguments(engine, tmp_path):
    path = str(tmp_path / "x.npz")
    with pytest.raises(ValueError, match="batch_sizes"):
        save_serving_artifact(path, engine, batch_sizes=(0,))
    with pytest.raises(ValueError, match="platforms"):
        save_serving_artifact(path, engine, batch_sizes=(1,), platforms=("tpu",))
    assert not os.path.exists(path)
    # cpu alone on a CPU engine is its native program, as in the JAX package
    meta = save_serving_artifact(path, engine, batch_sizes=(1,), input_hw=RAW_HW,
                                 platforms=("cpu",))
    assert not meta["portable_program"]
    assert dataclasses.asdict(engine.config)["img_size"] == tuple(meta["img_size"])


def test_quantile_linear_is_torch_quantile():
    """The sort percentile's restatement of torch.quantile (which a trace on
    torch 2.11 cannot take) equals torch.quantile bit for bit, NaN rows,
    flat rows and the end ranks included."""
    from thermal3d_torch.preprocess.enhance import quantile_linear

    g = torch.Generator().manual_seed(3)
    for shape in ((3, 1000), (2, 4, 50176), (5, 7), (1, 1)):
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(shape, generator=g, dtype=dtype)
            if x.numel() > 4:
                x.view(-1)[3] = float("nan")
                x[-1] = 1.5
            for qs in ([0.02, 0.98], [0.0, 1.0], [0.5, 0.25]):
                q = torch.tensor(qs, dtype=dtype)
                got = quantile_linear(x, q)
                want = torch.quantile(x, q, dim=-1, interpolation="linear")
                assert torch.equal(got.isnan(), want.isnan())
                assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
