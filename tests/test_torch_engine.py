"""The port's whole serving slice against the JAX InferenceEngine, and the
rules around it: no hidden CPU fallback, no silent acceptance of what the
port does not run yet."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_common import (PROD_DEPTH1_KW, TINY_KW, configs,
                                     jax_model_params, thermal_head_params, torch_state)
from thermal3d.infer.engine import InferenceEngine as JaxEngine
from thermal3d_torch.convert.from_jax import thermal_head_state_from_jax
from thermal3d_torch.infer.engine import InferenceEngine

KEYS = ("pointmap1", "pointmap2", "confidence1", "confidence2", "depth")


def _both_engines(kw, seed=0):
    jcfg, tcfg = configs(**kw)
    params = jax_model_params(jcfg, seed)
    thp = thermal_head_params()
    jeng = JaxEngine(jcfg, params=params, thermal_head_params=thp)
    teng = InferenceEngine(tcfg, state_dict=torch_state(params),
                           thermal_head_state=thermal_head_state_from_jax(thp),
                           device="cpu")
    return jeng, teng


def _raw_frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(21000.0, 26000.0, shape) / 65535.0).astype(np.float32)


def _assert_outputs_close(out, ref, rtol):
    # atol is set against each output's own scale: the exp/expm1 heads
    # amplify the f32 rounding of the trunk, so the error grows with |value|
    for k in KEYS:
        assert out[k].shape == ref[k].shape, k
        assert np.isfinite(out[k]).all(), k
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(out[k], ref[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


def test_whole_slice_tiny_matches_jax():
    """TINY_KW in f32 on raw [2,40,48] frames: resize, sort-path enhance,
    thermal head, model, heads. rtol 1e-4: f32 rounding through the trunk
    (summation orders differ between XLA and PyTorch), amplified by exp."""
    jeng, teng = _both_engines(TINY_KW)
    raw = _raw_frames((2, 40, 48))
    ref = jeng.infer(raw)
    out = teng.infer(raw)
    _assert_outputs_close(out, {k: np.asarray(v) for k, v in ref.items()}, 1e-4)


def test_whole_slice_production_width_depth1_matches_jax():
    """ViT-L/base-decoder widths at 224², one block each, f32, on raw
    [1,320,416] frames (the serving resize). rtol 1e-4 as above."""
    jeng, teng = _both_engines(PROD_DEPTH1_KW)
    raw = _raw_frames((1, 320, 416), seed=1)
    ref = jeng.infer(raw)
    out = teng.infer(raw)
    _assert_outputs_close(out, {k: np.asarray(v) for k, v in ref.items()}, 1e-4)


def test_binocular_views_match_jax():
    """Two different views: both encoded in one pass, decoder cross-attends."""
    jeng, teng = _both_engines(TINY_KW, seed=3)
    a, b = _raw_frames((2, 32, 32), 4), _raw_frames((2, 32, 32), 5)
    ref = jeng.infer(a, b)
    out = teng.infer(a, b)
    _assert_outputs_close(out, {k: np.asarray(v) for k, v in ref.items()}, 1e-4)


def test_engine_without_cuda_raises(monkeypatch):
    """device=None means CUDA; without it the engine raises, it does not move
    to the CPU."""
    from thermal3d_torch.core.config import TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(TINY, device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; it returns no library and hands back no
    plain version."""
    from thermal3d_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("rope_attention")


@pytest.mark.parametrize("field,value", [
    ("scan_layers", True),
    ("branch_batch", True),
    ("head", "dpt"),
    ("head", "catmlpdpt"),
])
def test_unported_config_raises(field, value):
    """A DPT-family head with an unknown dpt_dtype, or an unknown head_type,
    is refused (ValueError), as the JAX model refuses them. scan_layers and
    branch_batch, the JAX model's compile layouts, are accepted: the port
    runs its unrolled model, so the engine's outputs equal the unrolled
    config's (tests/test_torch_tools.py holds the layouts' trees)."""
    from thermal3d_torch.core.config import TINY, HeadConfig

    if field == "head":
        for head in (HeadConfig(head_type=value, dpt_dtype="float16"),
                     HeadConfig(head_type=value + "_v2")):
            with pytest.raises(ValueError):
                InferenceEngine(dataclasses.replace(TINY, head=head), device="cpu")
        return
    cfg = dataclasses.replace(TINY, **{field: value})
    raw = _raw_frames((1, 32, 32))
    got = InferenceEngine(cfg, device="cpu").infer(raw)
    want = InferenceEngine(TINY, device="cpu").infer(raw)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _mesh_over_processes():
    """A one-rank mesh over processes (core.mesh), which serving refuses."""
    from thermal3d_torch.core.mesh import Mesh

    devices = np.empty(1, dtype=object)
    devices[0] = torch.device("cpu")
    return Mesh(devices, ("data",), ranks=np.arange(1))


@pytest.mark.parametrize("kw", [{"mesh": "over_processes"}])
def test_unported_engine_modes_raise(kw):
    """Data-parallel serving takes a single-controller mesh (one process, a
    replica a device; tests/test_torch_mesh.py); a mesh over processes, the
    training kind, is refused (ValueError)."""
    from thermal3d_torch.core.config import TINY

    with pytest.raises(ValueError, match="single-controller"):
        InferenceEngine(TINY, device="cpu", mesh=_mesh_over_processes())


def test_int8_engine_serves_on_cpu():
    """quantize_int8=True (once refused here) serves: the trunk's Dense
    modules hold int8 weights, the heads stay float, every product goes
    through torch._int_mm, and the outputs are finite."""
    from thermal3d_torch.core.config import TINY
    from thermal3d_torch.kernels import quant

    eng = InferenceEngine(TINY, device="cpu", quantize_int8=True)
    n_int8 = sum(t.dtype == torch.int8 for t in eng.model.state_dict().values())
    assert n_int8 == TINY.enc_depth * 4 + TINY.dec_depth * 2 * 8 + 1
    quant.int_mm.launches = 0
    out = eng.infer(_raw_frames((2, 40, 48)))
    assert quant.int_mm.launches == n_int8 + 1  # decoder_embed runs once a view
    assert all(np.isfinite(out[k]).all() for k in KEYS)


def test_bf16_params_engine_runs_on_cpu():
    """params_dtype='bfloat16' stores the model weights in bf16; the linear
    head computes in f32 from the rounded weights."""
    from thermal3d_torch.core.config import TINY

    eng = InferenceEngine(TINY, device="cpu", params_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    assert eng.thermal_head.edge_weight.dtype == torch.float32
    out = eng.infer(_raw_frames((1, 40, 48)))
    assert out["depth"].dtype == np.float32 and np.isfinite(out["depth"]).all()
