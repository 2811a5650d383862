"""The port's int8 serving (thermal3d_torch.kernels.quant, Dense's int8 route,
the calibration forward, the engines' int8_* options, the CLIs' --int8*
flags) against the JAX package's, on the same inputs and weights.

Inputs come from numpy seeds. Held bit for bit: the int8 weights and their
scales (transposed: the port's weights are [N, K]), the int32 accumulators
of both product routes, and int8_dense's outputs in float32 and bfloat16
(flat, static and grouped up to 16 segments), against the JAX function
under jit, as the JAX engine runs it. Beyond 16 segments XLA's CPU backend
sums the grouped products in 8 interleaved partial sums where the port
keeps segment order: there the outputs agree to float32 rounding (1e-6).
Whole forwards agree to f32 summation order (1e-5 on the same int8
weights); an int8 engine quantized from the same float weights may flip a
rounding, so it is held to a tenth of JAX's own int8 drift.
"""

import dataclasses
import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests.test_torch_common import (TINY_KW, configs, jax_model_params, thermal_head_params,
                                     torch_state)
from thermal3d.kernels import quant as jq
from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
from thermal3d_torch.convert.from_jax import (int8_state_dict_from_jax,
                                              thermal_head_state_from_jax)
from thermal3d_torch.kernels import quant
from thermal3d_torch.models.dustr import calibrate_act_absmax, frozen_model

CPU = torch.device("cpu")


def _jit_dense(x, wq, ws, dtype, act=None):
    """JAX int8_dense under jit, as the JAX model runs it."""
    fn = jax.jit(lambda x, wq, ws, a: jq.int8_dense(x, wq, ws, dtype, act_scale=a))
    return np.asarray(fn(jnp.asarray(x), wq, ws, act).astype(jnp.float32))


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    # channel magnitudes spread over 30x: per-token scales are set by outliers
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 3.0, (1, k))).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("k,n,group", [(64, 48, None), (1024, 256, None), (256, 72, 32),
                                       (1024, 96, 128), (768, 64, 128)])
def test_quantize_kernel_matches_jax(k, n, group):
    _, w = _operands(8, k, n, 0)
    wq, ws = jq.quantize_kernel(jnp.asarray(w), group)
    twq, tws = quant.quantize_kernel(torch.from_numpy(w.T.copy()), group)
    assert twq.dtype == torch.int8 and tws.dtype == torch.float32
    np.testing.assert_array_equal(twq.numpy(), np.asarray(wq).T)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(ws).T)


def _port_operands(x, w, group):
    wq, ws = jq.quantize_kernel(jnp.asarray(w), group)
    return (wq, ws, torch.from_numpy(np.asarray(wq).T.copy()),
            torch.from_numpy(np.asarray(ws).T.copy()))


@pytest.mark.parametrize("impl", ["int_mm", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["flat", "static", "grouped8", "grouped16"])
def test_int8_dense_bit_equal_to_jax(case, dtype, impl):
    """196 tokens × K 1024: the int32 accumulators of the route equal the
    exact integer product, and the outputs equal the jitted JAX function's."""
    x, w = _operands(196, 1024, 256, 1)
    group = {"grouped8": 128, "grouped16": 64}.get(case)
    wq, ws, twq, tws = _port_operands(x, w, group)
    act = jnp.float32(2.5) if case == "static" else None
    tact = torch.tensor(2.5) if case == "static" else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    quant.int_mm.launches = 0
    got = quant.int8_dense(torch.from_numpy(x), twq, tws, tdt, act_scale=tact, impl=impl)
    assert got.dtype == tdt and got.shape == (196, 256)
    assert quant.int_mm.launches == ((1024 // group if group else 1) if impl == "int_mm" else 0)
    np.testing.assert_array_equal(got.float().numpy(), _jit_dense(x, wq, ws, jdt, act))

    xq = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, (196, 1024))
                          .astype(np.int8))
    exact = xq.numpy().astype(np.int64) @ twq.numpy().astype(np.int64).T
    acc = quant.int_product(xq, twq, impl)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), exact)


@pytest.mark.parametrize("k", [3072, 4096])
def test_int8_dense_many_segments_within_float32_rounding(k):
    """K/128 = 24 and 32 segments (the fc2 and MASt3R shapes): XLA's CPU
    backend vectorizes the segment sum there (8 interleaved partial sums);
    the port sums in segment order, so the two agree to float32 rounding."""
    x, w = _operands(64, k, 64, 3)
    wq, ws, twq, tws = _port_operands(x, w, 128)
    got = quant.int8_dense(torch.from_numpy(x), twq, tws, torch.float32).numpy()
    want = _jit_dense(x, wq, ws, jnp.float32)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    plain = quant.int8_dense(torch.from_numpy(x), twq, tws, torch.float32, impl="plain")
    np.testing.assert_array_equal(plain.numpy(), got)


def test_int8_dense_input_layouts_and_errors():
    """A leading batch shape is kept; an unknown route, a static scale with
    grouped weights, and a shape torch._int_mm refuses on CUDA raise."""
    x, w = _operands(2 * 33, 64, 48, 4)
    _, _, twq, tws = _port_operands(x, w, None)
    flat = quant.int8_dense(torch.from_numpy(x), twq, tws, torch.float32)
    batched = quant.int8_dense(torch.from_numpy(x).reshape(2, 33, 64), twq, tws, torch.float32)
    np.testing.assert_array_equal(batched.reshape(66, 48).numpy(), flat.numpy())
    with pytest.raises(ValueError, match="int8_impl"):
        quant.int8_dense(torch.from_numpy(x), twq, tws, torch.float32, impl="cublas")
    _, _, gwq, gws = _port_operands(x, w, 32)
    with pytest.raises(ValueError, match="grouped"):
        quant.int8_dense(torch.from_numpy(x), gwq, gws, torch.float32, act_scale=torch.tensor(1.0))
    for m, k, n in ((16, 64, 48), (196, 60, 48), (196, 64, 50)):
        with pytest.raises(ValueError, match="_int_mm"):
            quant.check_int_mm_shape(m, k, n)
    quant.check_int_mm_shape(17, 64, 48)


def _float_pair(seed=0, attention="xla", **kw):
    """A tiny JAX model (attention_impl 'xla': float32 scores, as the port
    computes them) and the port's frozen model on its weights."""
    jcfg, tcfg = configs(**dict(TINY_KW, **kw))
    jcfg = dataclasses.replace(jcfg, attention_impl=attention)
    params = jax_model_params(jcfg, seed)
    return jcfg, params, frozen_model(tcfg, CPU, torch_state(params))


def _images(jcfg, seed=0, n=2):
    h, w = jcfg.img_size
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def _port_path(jax_path) -> str:
    """A JAX module path → the port's ('enc_blocks_0', 'attn', 'qkv') →
    'enc_blocks.0.attn.qkv'."""
    top = jax_path[0]
    if top.startswith(quant.TRUNK_STACKS):
        stack, idx = top.rsplit("_", 1)
        return ".".join([stack, idx, *jax_path[1:]])
    return ".".join(jax_path)


def test_calibration_matches_jax_calib_collection():
    """The calibration forward's act_absmax per trunk Dense, monocular and
    binocular, against JAX's 'calib' collection: 1e-6 relative."""
    jcfg, params, model = _float_pair()
    img, img2 = _images(jcfg, 0), _images(jcfg, 1)
    for second in (None, img2):
        _, mut = JaxModel(jcfg).apply({"params": params}, jnp.asarray(img),
                                      None if second is None else jnp.asarray(second),
                                      mutable=["calib"])
        calib = {_port_path(p[:-1]): float(v)
                 for p, v in traverse_util.flatten_dict(mut["calib"]).items()}
        got = calibrate_act_absmax(model, torch.from_numpy(img),
                                   None if second is None else torch.from_numpy(second))
        assert sorted(got) == sorted(calib) == sorted(p for p, _ in quant.trunk_dense(model))
        for p, v in calib.items():
            assert got[p].dtype == torch.float32 and got[p].dim() == 0
            assert abs(float(got[p]) - v) <= 1e-6 * v, p
    assert not any(m._forward_pre_hooks for m in model.modules())


@pytest.mark.parametrize("kw", [dict(), dict(only=("fc1", "fc2")), dict(only=("fc1",)),
                                dict(skip=("enc_blocks_0", "decoder_embed")),
                                dict(group_size=16), dict(group_size=128), "static"])
def test_quantized_set_matches_jax(kw):
    """quantize_model_int8 on the port's model against quantize_params_int8:
    the same modules (scope 'all' / 'mlp' / 'fc1', skip, grouped where the
    group divides K), the same int8 weights and scales, the same static
    act_scales; heads, norms and biases stay float."""
    jcfg, params, model = _float_pair(seed=1)
    kw_t = kw
    if kw == "static":
        img = _images(jcfg)
        _, mut = JaxModel(jcfg).apply({"params": params}, jnp.asarray(img), None,
                                      mutable=["calib"])
        kw, kw_t = dict(act_scales=mut["calib"]), dict(
            act_scales=calibrate_act_absmax(model, torch.from_numpy(img)))
    _, jquant = jq.quantize_params_int8(params, **kw)
    n = quant.quantize_model_int8(model, **kw_t)
    want = {}
    for p, v in traverse_util.flatten_dict(jquant).items():
        want.setdefault(_port_path(p[:-1]), {})[p[-1]] = np.asarray(v)
    got = {p: d for p, d in quant.trunk_dense(model) if d.weight_scale is not None}
    assert n == len(got) and sorted(got) == sorted(want)
    for p, d in got.items():
        assert d.weight.dtype == torch.int8
        np.testing.assert_array_equal(d.weight_scale.numpy(), want[p]["kernel_scale"].T)
        if "act_scale" in want[p]:
            np.testing.assert_allclose(d.act_scale.numpy(), want[p]["act_scale"], rtol=1e-6)
        else:
            assert d.act_scale is None
    floats = [name for name, t in model.state_dict().items() if t.dtype == torch.int8]
    assert all(name.endswith(".weight") and name[:-len(".weight")] in got for name in floats)


def test_quantized_weights_bit_equal_to_jax():
    """Every int8 weight of scope 'all' equals the JAX kernel, transposed."""
    jcfg, params, model = _float_pair(seed=2)
    pq, _ = jq.quantize_params_int8(params)
    quant.quantize_model_int8(model)
    flat = traverse_util.flatten_dict(pq)
    n = 0
    for p, leaf in flat.items():
        if p[-1] == "kernel" and leaf.dtype == jnp.int8:
            d = model.get_submodule(_port_path(p[:-1]))
            np.testing.assert_array_equal(d.weight.numpy(), np.asarray(leaf).T)
            n += 1
    assert n == 2 * 4 + 2 * 2 * 8 + 1


@pytest.mark.parametrize("kw", [dict(), dict(group_size=16), dict(only=("fc1",)), "static",
                                dict(skip=("dec_blocks2_1",))])
def test_int8_forward_matches_jax_on_same_int8_weights(kw):
    """The JAX int8 tree carried over by int8_state_dict_from_jax: the port's
    int8 forward against JAX's on the same int8 weights, float32, 1e-5 of
    each output's scale."""
    jcfg, params, _ = _float_pair(seed=3)
    img = _images(jcfg, 4)
    model = JaxModel(jcfg)
    if kw == "static":
        _, mut = model.apply({"params": params}, jnp.asarray(img), None, mutable=["calib"])
        kw = dict(act_scales=mut["calib"])
    pq, q = jq.quantize_params_int8(params, **kw)
    j1, j2 = jax.jit(lambda p, q, x: model.apply({"params": p, "quant": q}, x, None))(
        pq, q, jnp.asarray(img))
    state = int8_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, pq),
                                     jax.tree_util.tree_map(np.asarray, q))
    tmodel = frozen_model(configs(**TINY_KW)[1], CPU, torch_state(params))
    quant.load_int8_state_dict(tmodel, state)
    with torch.inference_mode():
        t1, t2 = tmodel(torch.from_numpy(img))
    for got, want in ((t1["pts3d"], j1["pts3d"]), (t1["conf"], j1["conf"]),
                      (t2["pts3d_in_other_view"], j2["pts3d_in_other_view"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_equalize_matches_jax_and_is_exact():
    """equalize_ln_gemm on the port's model against the JAX fold: every
    block's LN affine and weights within 3 float32 ulp (XLA's pow(x, 0.5)
    is 1 ulp off the IEEE square root for ~0.8% of inputs, torch's is the
    square root, so s = a^½ / w^½ differs by up to 2 ulp and a folded value
    by up to 3); folded weights stay float32 in a bf16-stored model; the
    float forward unchanged within 1e-5 relative."""
    jcfg, params, model = _float_pair(seed=5)
    img = torch.from_numpy(_images(jcfg, 6))
    with torch.inference_mode():
        before = model(img)[0]["pts3d"].numpy()
    jeq = traverse_util.flatten_dict(jq.equalize_ln_gemm(params))
    n = quant.equalize_ln_gemm(model)
    assert n == 2 * 2 + 2 * 2 * 5  # enc: qkv, fc1; dec: qkv, projq, projk, projv, fc1
    sd = model.state_dict()
    worst = 0.0
    for p, leaf in jeq.items():
        key = _port_path(p[:-1]) + (".weight" if p[-1] in ("kernel", "scale") else ".bias")
        if not key.startswith(quant.TRUNK_STACKS):
            continue
        want = np.asarray(leaf, np.float32)
        want = want.T if p[-1] == "kernel" else want
        got = sd[key].numpy()
        ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
        worst = max(worst, float(ulps.max()))
    assert worst <= 3, worst
    with torch.inference_mode():
        after = model(img)[0]["pts3d"].numpy()
    np.testing.assert_allclose(after, before, rtol=1e-5, atol=1e-5 * np.abs(before).max())

    _, tcfg = configs(**TINY_KW)
    bf = frozen_model(tcfg, CPU, torch_state(params), params_dtype="bfloat16")
    quant.equalize_ln_gemm(bf, only=("fc1",))
    assert bf.enc_blocks[0].mlp.fc1.weight.dtype == torch.float32
    assert bf.enc_blocks[0].norm2.weight.dtype == torch.bfloat16
    assert bf.enc_blocks[0].attn.qkv.weight.dtype == torch.bfloat16


def test_error_cases():
    """As the JAX functions: nothing to quantize, static scales with a
    group size, nothing to equalize, an int8 weight without its scales."""
    _, params, model = _float_pair(seed=6)
    with pytest.raises(ValueError, match="no quantizable"):
        quant.quantize_model_int8(model, only=("nothing",))
    tops = [f"{s}_{i}" for s in quant.TRUNK_STACKS for i in range(2)] + ["decoder_embed"]
    with pytest.raises(ValueError, match="no quantizable"):
        quant.quantize_model_int8(model, skip=tops)
    with pytest.raises(ValueError, match="requires group_size=None"):
        quant.quantize_model_int8(model, group_size=16, act_scales={})
    with pytest.raises(ValueError, match="int8_impl"):
        quant.quantize_model_int8(model, impl="fast")
    with pytest.raises(ValueError, match="no equalizable"):
        quant.equalize_ln_gemm(model, only=("fc2", "proj"))
    dense = model.enc_blocks[0].mlp.fc1
    dense.weight = torch.nn.Parameter(dense.weight.to(torch.int8), requires_grad=False)
    with pytest.raises(ValueError, match="without its scales"):
        dense(torch.zeros(1, dense.weight.shape[1]))


def _engines(int8_kw, jax_kw=None, dtype="float32", seed=7):
    """The float and int8 JAX engines and the port's int8 engine on the same
    tiny float weights (JAX attention 'xla')."""
    from thermal3d.infer.engine import InferenceEngine as JaxEngine
    from thermal3d_torch.infer.engine import InferenceEngine

    jcfg, tcfg = configs(**dict(TINY_KW, compute_dtype=dtype))
    jcfg = dataclasses.replace(jcfg, attention_impl="xla")
    params, thp = jax_model_params(jcfg, seed), thermal_head_params()
    jf = JaxEngine(jcfg, params=params, thermal_head_params=thp)
    jq8 = JaxEngine(jcfg, params=params, thermal_head_params=thp, quantize_int8=True,
                    **(jax_kw or int8_kw))
    tq8 = InferenceEngine(tcfg, state_dict=torch_state(params),
                          thermal_head_state=thermal_head_state_from_jax(thp), device="cpu",
                          quantize_int8=True, **int8_kw)
    return jf, jq8, tq8


def _raw(seed=0, shape=(4, 40, 48)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(21000.0, 26000.0, shape) / 65535.0).astype(np.float32)


def _rel_rms(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("case", ["all", "fc1", "static", "grouped", "equalize", "skip"])
def test_int8_engine_matches_jax_engine(case):
    """The tiny int8 engine against JAX's int8 engine quantized from the same
    float weights, on the same raw frames: depth within 0.1 x JAX's own
    int8-vs-float drift (rel RMS; measured 0 to 1e-4 x); with dynamic scales
    the port's own drift under 0.04 (the JAX test's bound; static scales
    calibrated on other frames drift 0.048 in both packages). With
    enc_blocks_0 and decoder_embed in float, their float32 GEMMs (summation
    order) move an int8 rounding further down, which the exp heads carry:
    0.137 x there, held to 0.25 x."""
    calib = _raw(9, (2, 40, 48))
    kw = {"all": {}, "fc1": dict(int8_only=("fc1",)),
          "static": dict(int8_calibration=calib), "grouped": dict(int8_group_size=16),
          "equalize": dict(int8_equalize=True),
          "skip": dict(int8_skip=("enc_blocks_0", "decoder_embed"))}[case]
    jf, jq8, tq8 = _engines(kw)
    raw = _raw(10)
    ref = jf.infer(raw)["depth"]
    jdepth = jq8.infer(raw)["depth"]
    tdepth = tq8.infer(raw)["depth"]
    jdrift = _rel_rms(jdepth, ref)
    assert jdrift > 0
    if case != "static":  # the JAX test's bound holds for dynamic scales
        assert jdrift < 0.04 and _rel_rms(tdepth, ref) < 0.04
    limit = 0.25 if case == "skip" else 0.1
    assert _rel_rms(tdepth, jdepth) <= limit * jdrift, (_rel_rms(tdepth, jdepth), jdrift)


def test_int8_engine_bf16_storage_and_routes():
    """bf16 weights and compute: the int8 weights are quantized from the
    bf16-rounded weights (as the JAX engine, which quantizes after its
    params_dtype cast), and the two product routes give the same depth."""
    from thermal3d_torch.infer.engine import InferenceEngine

    _, tcfg = configs(**dict(TINY_KW, compute_dtype="bfloat16"))
    jcfg, params, _ = _float_pair(seed=8)
    engines = [InferenceEngine(tcfg, state_dict=torch_state(params), device="cpu",
                               params_dtype="bfloat16", quantize_int8=True, int8_impl=impl)
               for impl in ("int_mm", "plain")]
    bf = frozen_model(tcfg, CPU, torch_state(params), params_dtype="bfloat16")
    wq, ws = quant.quantize_kernel(bf.enc_blocks[1].attn.proj.weight)
    d = engines[0].model.enc_blocks[1].attn.proj
    assert torch.equal(d.weight, wq) and torch.equal(d.weight_scale, ws)
    raw = _raw(11, (2, 40, 48))
    quant.int_mm.launches = 0
    a = engines[0].infer(raw)["depth"]
    assert quant.int_mm.launches == 2 * 4 + 2 + 2 * 2 * 8
    b = engines[1].infer(raw)["depth"]
    assert quant.int_mm.launches == 2 * 4 + 2 + 2 * 2 * 8
    np.testing.assert_array_equal(a, b)


def test_int8_generator_matches_jax_generator():
    """The tiny MASt3R int8 generator with static scales calibrated on the
    pair batch: its depths against JAX's int8 generator (attention 'xla')
    within 0.1 x JAX's own int8 drift; without quantize_int8 the int8_*
    options change nothing, as in JAX."""
    from thermal3d.cli.common import apply_preset as jax_preset
    from thermal3d.core.config import MASTR_512_CATMLPDPT as JAX_MASTR
    from thermal3d.pseudo_gt.generator import PseudoGTGenerator as JaxGenerator
    from thermal3d_torch.cli.common import apply_preset
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    jcfg = dataclasses.replace(jax_preset(JAX_MASTR, "tiny", (32, 32), "float32"),
                               attention_impl="xla")
    tcfg = apply_preset(MASTR_512_CATMLPDPT, "tiny", (32, 32), "float32")
    params = jax_model_params(jcfg, 12)
    rng = np.random.default_rng(13)
    r1, r2 = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    kw = dict(quantize_int8=True, int8_calibration=(r1, r2))
    jf = JaxGenerator(jcfg, params=params, batch_size=2).run_pairs(r1, r2)
    jq8 = JaxGenerator(jcfg, params=params, batch_size=2, **kw).run_pairs(r1, r2)
    tq8 = PseudoGTGenerator(tcfg, state_dict=torch_state(params), batch_size=2, device="cpu",
                            **kw).run_pairs(r1, r2)
    for key in ("depth1", "depth2"):
        jdrift = _rel_rms(jq8[key], jf[key])
        assert 0 < jdrift < 0.1
        assert _rel_rms(tq8[key], jq8[key]) <= 0.1 * jdrift, key
    plain = PseudoGTGenerator(tcfg, state_dict=torch_state(params), batch_size=2, device="cpu",
                              int8_group_size=16, int8_equalize=True).run_pairs(r1, r2)
    np.testing.assert_allclose(plain["depth1"], jf["depth1"], rtol=1e-4,
                               atol=1e-4 * np.abs(jf["depth1"]).max())


# --- the CLIs' --int8* flags -------------------------------------------------

CLI_TINY = ["--model_preset", "tiny", "--img_size", "32", "32", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """5 thermal frames, the first corrupt, and a Freiburg tree of 3 RGB/IR
    frames; the tiny DUSt3R .pth."""
    from thermal3d.convert.flax_to_torch import export_state_dict

    root = tmp_path_factory.mktemp("int8_cli")
    rng = np.random.default_rng(14)
    fdir = root / "frames"
    fdir.mkdir()
    for i in range(5):
        path = fdir / f"fl_ir_aligned_158000{i}_00{i}.png"
        if i == 0:
            path.write_bytes(b"not a png")
        else:
            cv2.imwrite(str(path), rng.integers(21000, 26000, (40, 48)).astype(np.uint16))
    seq = root / "ds" / "train" / "seq_00_day" / "00"
    for sub in ("fl_ir_aligned", "fl_rgb"):
        (seq / sub).mkdir(parents=True)
    for i in range(3):
        s = f"157000{i}_00{i}"
        cv2.imwrite(str(seq / "fl_ir_aligned" / f"fl_ir_aligned_{s}.png"),
                    rng.integers(21000, 26000, (40, 48)).astype(np.uint16))
        cv2.imwrite(str(seq / "fl_rgb" / f"fl_rgb_{s}.png"),
                    rng.integers(0, 256, (40, 48, 3)).astype(np.uint8))
    jcfg, _ = configs(**TINY_KW)
    pth = root / "tiny.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(
        jax_model_params(jcfg, 15), jcfg).items()}}, pth)
    return dict(root=root, dir=str(fdir), ds=str(root / "ds"), pth=str(pth),
                paths=sorted(glob.glob(str(fdir / "*.png"))))


@pytest.mark.parametrize("cli,argv", [
    ("infer", ["--img_path", "x.png", "--no_vis", "--int8_static_acts"]),
    ("infer", ["--img_path", "x.png", "--int8_equalize"]),
    ("infer", ["--img_path", "x.png", "--int8", "--int8_static_acts", "--int8_group_size", "64"]),
    ("infer", ["--img_path", "x.png", "--int8", "--int8_scope", "attn"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--visualize",
                   "--int8_static_acts"]),
    ("pseudo_gt", ["--dataset_dir", "d", "--output_dir", "o", "--int8_equalize"]),
])
def test_cli_int8_parser_errors_match_jax(cli, argv, capsys):
    """The JAX CLIs' parser errors, before any model is built (an unknown
    scope is a KeyError in the JAX pseudo_gt CLI, a parser error here)."""
    import importlib

    main = importlib.import_module(f"thermal3d_torch.cli.{cli}").main
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    jax_main = importlib.import_module(f"thermal3d.cli.{cli}").main
    if "--int8_scope" not in argv:
        with pytest.raises(SystemExit) as je:
            jax_main(argv)
        assert je.value.code == 2
        assert err.splitlines()[-1].split("error: ")[1] == \
            capsys.readouterr().err.splitlines()[-1].split("error: ")[1]


@pytest.mark.parametrize("flags", [["--int8"], ["--int8", "--int8_static_acts"],
                                   ["--int8", "--int8_scope", "fc1", "--int8_equalize"],
                                   ["--int8", "--int8_group_size", "16"],
                                   ["--int8_group_size", "16"]])
def test_cli_infer_int8_modes(frames, tmp_path, flags):
    """cli.infer --int8*: the depth files equal an engine built with the same
    options on the same .pth; --int8_static_acts calibrates on the first
    decodable batch (the corrupt first frame is skipped); --int8_group_size
    without --int8 changes nothing, as in the JAX CLI."""
    from thermal3d_torch.cli.infer import main
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.preprocess.io import load_thermal_images_batch

    main(["--img_path", frames["dir"], "--output_dir", str(tmp_path), "--weights",
          frames["pth"], "--no_vis", "--batch_size", "3", "--device", "cpu", *CLI_TINY, *flags])
    _, tcfg = configs(**TINY_KW)
    state, head = load_pth(frames["pth"], tcfg)
    kw = {}
    if "--int8" in flags:
        kw = dict(quantize_int8=True, int8_equalize="--int8_equalize" in flags,
                  int8_only=("fc1",) if "fc1" in flags else (),
                  int8_group_size=16 if "16" in flags else None)
    if "--int8_static_acts" in flags:
        grays, ok = load_thermal_images_batch(frames["paths"][:3], out_hw=(32, 32))
        assert ok == frames["paths"][1:3]
        kw["int8_calibration"] = np.stack(grays)
    eng = InferenceEngine(tcfg, state_dict=state, thermal_head_state=head, device="cpu", **kw)
    want = eng.infer_paths(frames["paths"], batch_size=3, outputs=("depth",))
    for i, path in enumerate(want["paths"]):
        base = os.path.splitext(os.path.basename(path))[0]
        np.testing.assert_array_equal(np.load(tmp_path / f"{base}_depth.npy"), want["depth"][i])
    assert len(want["paths"]) == 4


@pytest.mark.parametrize("flags", [["--int8"], ["--int8", "--int8_static_acts", "--test_set"],
                                   ["--int8", "--int8_scope", "mlp", "--int8_equalize"]])
def test_cli_pseudo_gt_int8_modes(frames, tmp_path, flags):
    """cli.pseudo_gt --int8*: every file equals a generator built with the
    same options; --int8_static_acts calibrates on the first pair batch
    (a test-set frame is its own pair)."""
    from thermal3d_torch.cli.common import apply_preset
    from thermal3d_torch.cli.pseudo_gt import main
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.data.freiburg import build_rgb_pair_index, build_rgb_thermal_index
    from thermal3d_torch.pseudo_gt.generator import (PseudoGTGenerator, decode_rgb_pairs,
                                                     generate_pseudo_gt)
    from thermal3d_torch.pseudo_gt.test_set import generate_test_set_pseudo_gt

    out = tmp_path / "cli"
    common = ["--dataset_dir", frames["ds"], "--batch_size", "2", "--frame_skip", "1",
              "--model_preset", "tiny", "--img_size", "32", "32", "--compute_dtype", "float32",
              "--device", "cpu"]
    n = main(common + ["--output_dir", str(out), *flags])
    cfg = apply_preset(MASTR_512_CATMLPDPT, "tiny", (32, 32), "float32")
    kw = dict(quantize_int8=True, int8_equalize="--int8_equalize" in flags,
              int8_only=("fc1", "fc2") if "mlp" in flags else ())
    test_set = "--test_set" in flags
    items = (build_rgb_thermal_index if test_set else
             lambda d: build_rgb_pair_index(d, frame_skip=1))(frames["ds"])
    if "--int8_static_acts" in flags:
        r1, r2, _ = decode_rgb_pairs(items[:2], (32, 32), ("rgb", "rgb"))
        kw["int8_calibration"] = (r1, r2)
    gen = PseudoGTGenerator(cfg, batch_size=2, device="cpu", **kw)
    ref = tmp_path / "ref"
    if test_set:
        m = generate_test_set_pseudo_gt(items, str(ref), gen)
    else:
        m = generate_pseudo_gt(items, str(ref), gen)
    assert n == m > 0
    files = sorted(os.path.relpath(p, out) for p in glob.glob(str(out / "**" / "*.npy"),
                                                               recursive=True))
    assert files == sorted(os.path.relpath(p, ref) for p in glob.glob(
        str(ref / "**" / "*.npy"), recursive=True)) and files
    for f in files:
        np.testing.assert_array_equal(np.load(out / f), np.load(ref / f), err_msg=f)


def test_bench_int8_headline_and_parser_error(capsys):
    """bench --int8: the headline through the int8 engine, no int8
    secondaries; --int8_static_acts without --int8 is a parser error, as in
    bench.py."""
    import json

    from thermal3d_torch import bench

    assert bench.main(["--device", "cpu", "--model_preset", "tiny", "--batch", "2", "--iters",
                       "1", "--int8", "--int8_scope", "fc1", "--int8_static_acts",
                       "--train_batch", "1", "--pair_batch", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["int8"] is True and line["int8_scope"] == "fc1" and line["int8_static_acts"]
    assert line["value"] > 0
    assert [s["config"] for s in line["secondary_metrics"]] == ["train_dustr224_b1",
                                                                "pseudo_gt_mastr512_b1"]
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--int8_static_acts"])
    assert e.value.code == 2 and "requires --int8" in capsys.readouterr().err
