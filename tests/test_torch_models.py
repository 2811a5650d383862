"""Per-module parity of the port's model (thermal3d_torch.models) against the
Flax modules, with weights converted by the port's convert/from_jax.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (PROD_DEPTH1_KW, TINY_KW, configs, jax_model_params, to_np,
                                     torch_state)
from thermal3d.convert.flax_to_torch import export_state_dict
from thermal3d.core.config import HeadConfig as JaxHeadConfig
from thermal3d.models import heads as jheads
from thermal3d.models import layers as jlayers
from thermal3d.models import rope as jrope
from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
from thermal3d.models.thermal_wrap import ThermalPreprocessHead as JaxThermalHead
from thermal3d_torch.convert.from_jax import state_dict_from_jax
from thermal3d_torch.core.config import HeadConfig
from thermal3d_torch.models import heads, layers, rope
from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo
from thermal3d_torch.models.thermal_wrap import ThermalPreprocessHead


def _rng(seed):
    return np.random.default_rng(seed)


def test_grid_positions_and_rope_tables_match_jax():
    np.testing.assert_array_equal(rope.make_grid_positions(5, 7).numpy(),
                                  np.asarray(jrope.make_grid_positions(5, 7)))
    pos = rope.make_grid_positions(14, 14)
    cos, sin = rope.rope_tables(pos, 64)
    jcos, jsin = jrope.rope_tables(jrope.make_grid_positions(14, 14), 64)
    # f32 pow/cos/sin of two libraries: a few ulp on arguments up to 13
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)


def test_apply_rope_2d_bshd_matches_jax_and_tables():
    x = _rng(0).standard_normal((2, 35, 3, 16)).astype(np.float32)
    pos = rope.make_grid_positions(5, 7)
    out = rope.apply_rope_2d_bshd(torch.from_numpy(x), pos)
    ref = jrope.apply_rope_2d_bshd(jnp.asarray(x), jrope.make_grid_positions(5, 7))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the tables' layout gives the same rotation (what K2/K3 apply)
    from thermal3d_torch.kernels.flash_attention import rot_lanes

    cos, sin = rope.rope_tables(pos, 16)
    t = torch.from_numpy(x)
    via_tables = t * cos[:, None] + rot_lanes(t) * sin[:, None]
    torch.testing.assert_close(via_tables, out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("batched_positions", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_2d_matches_jax(batched_positions, dtype):
    """apply_rope_2d on [B, H, S, D] tokens, with [S, 2] grid positions or
    [B, S, 2] positions of its own for each batch row, against
    thermal3d.models.rope.apply_rope_2d on the same seeded numpy input.
    float32: the same f32 ops, within 1e-6 (cos/sin may round one ulp
    apart); bfloat16: max|Δ|/max|ref| within 2^-7 (XLA may keep a product
    in f32 where PyTorch rounds it to bf16, one bf16 rounding)."""
    rng = _rng(7)
    b, h, s, d = 2, 3, 35, 16
    x = rng.standard_normal((b, h, s, d)).astype(np.float32)
    grid = np.asarray(jrope.make_grid_positions(5, 7))
    pos = np.stack([grid[rng.permutation(s)] for _ in range(b)]) if batched_positions else grid
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    ref = np.asarray(jrope.apply_rope_2d(jnp.asarray(x, jdt), jnp.asarray(pos)), np.float32)
    out = rope.apply_rope_2d(torch.from_numpy(x).to(tdt), torch.from_numpy(pos)).float().numpy()
    assert out.shape == ref.shape == (b, h, s, d)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    else:
        assert np.abs(out - ref).max() / np.abs(ref).max() <= 2.0 ** -7


def test_thermal_head_matches_jax():
    """Local normalisation, zero-padded Sobel, (x + w·mag)·t, clip: the same
    f32 ops in the same order (atol 1e-6)."""
    x = _rng(1).uniform(0.2, 0.9, (2, 20, 24, 3)).astype(np.float32)
    jp = {"edge_weight": jnp.float32(0.37), "temp_scale": jnp.float32(1.1)}
    ref = JaxThermalHead().apply({"params": jp}, jnp.asarray(x))
    head = ThermalPreprocessHead(0.37, 1.1)
    with torch.no_grad():
        out = head(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    # one gray channel is tiled to three
    with torch.no_grad():
        one = head(torch.from_numpy(x[..., :1]))
    assert one.shape == (2, 20, 24, 3)


def test_pixel_shuffle_matches_jax():
    feat = _rng(2).standard_normal((2, 6, 4 * 3 * 3)).astype(np.float32)
    out = heads.pixel_shuffle_tokens(torch.from_numpy(feat), (2, 3), 3)
    ref = jheads.pixel_shuffle_tokens(jnp.asarray(feat), (2, 3), 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_linear_head_matches_jax():
    """proj + pixel shuffle + expm1/exp activations in f32; rtol 1e-5 (the
    activations amplify the GEMM's f32 rounding)."""
    tokens = _rng(3).standard_normal((2, 4, 48)).astype(np.float32)
    jhead = jheads.LinearPts3dHead(4, JaxHeadConfig())
    params = jhead.init(jax.random.key(1), [jnp.asarray(tokens)], (2, 2))["params"]
    ref = jhead.apply({"params": params}, [jnp.asarray(tokens)], (2, 2))
    head = heads.LinearPts3dHead(48, 4, HeadConfig())
    head.proj.weight.data = torch.from_numpy(np.array(params["proj"]["kernel"]).T.copy())
    head.proj.bias.data = torch.from_numpy(np.array(params["proj"]["bias"]))
    with torch.no_grad():
        out = head(torch.from_numpy(tokens), (2, 2))
    for k in ("pts3d", "conf"):
        np.testing.assert_allclose(to_np(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


def _load(module, flax_params, prefix):
    sd = state_dict_from_jax({f"{prefix}_0": flax_params})
    module.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()}, strict=True)


def _block_tolerance():
    # f32 GEMMs and LayerNorms of two libraries on O(1) activations
    return dict(rtol=1e-5, atol=2e-5)


def test_encoder_block_matches_jax():
    dim, nh, s = 64, 4, 24
    x = _rng(4).standard_normal((2, s, dim)).astype(np.float32)
    jpos = jrope.make_grid_positions(4, 6)
    jblk = jlayers.EncoderBlock(nh)
    params = jblk.init(jax.random.key(2), jnp.asarray(x), jpos)["params"]
    ref = jblk.apply({"params": params}, jnp.asarray(x), jpos)
    blk = layers.EncoderBlock(dim, nh, 4.0, torch.float32)
    _load(blk, params, "enc_blocks")
    cos, sin = rope.rope_tables(rope.make_grid_positions(4, 6), dim // nh)
    with torch.no_grad():
        out = blk(torch.from_numpy(x), (cos, sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_block_tolerance())


def test_decoder_block_matches_jax():
    dim, nh, s = 48, 2, 24
    x = _rng(5).standard_normal((2, s, dim)).astype(np.float32)
    y = _rng(6).standard_normal((2, s, dim)).astype(np.float32)
    jpos = jrope.make_grid_positions(4, 6)
    jblk = jlayers.DecoderBlock(nh)
    params = jblk.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(y), jpos)["params"]
    ref = jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(y), jpos)
    blk = layers.DecoderBlock(dim, nh, 4.0, torch.float32)
    _load(blk, params, "dec_blocks")
    cos, sin = rope.rope_tables(rope.make_grid_positions(4, 6), dim // nh)
    with torch.no_grad():
        out = blk(torch.from_numpy(x), torch.from_numpy(y), (cos, sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_block_tolerance())


def test_from_jax_matches_export_state_dict_and_loads_strict():
    """The port's own converter gives the keys and values of the JAX
    package's exporter, and the state dict loads into the port strictly."""
    jcfg, tcfg = configs(**TINY_KW)
    params = jax_model_params(jcfg)
    ref = export_state_dict(params, jcfg)
    sd = torch_state(params)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    AsymmetricCroCo3DStereo(tcfg).load_state_dict(sd, strict=True)


def test_from_jax_wrapper_layout_matches_export():
    """ThermalDUSt3R layout: top-level edge_weight/temp_scale, 'model.' prefix."""
    jcfg, _ = configs(**TINY_KW)
    params = {"thermal_preprocess": {"edge_weight": np.float32(0.5),
                                     "temp_scale": np.float32(1.0)},
              "model": jax_model_params(jcfg)}
    ref = export_state_dict(params, jcfg, wrapper=True)
    sd = state_dict_from_jax(params, wrapper=True)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_from_jax_rejects_unported_params():
    """A path that no module of the port has (here an unknown DPT head
    submodule) is refused, not dropped."""
    with pytest.raises(KeyError, match="no module of the port"):
        state_dict_from_jax({"downstream_head1": {"dpt": {"head9": {"kernel": np.zeros(1)}}}})


@pytest.mark.parametrize("tree", [
    {"downstream_head2": {"dpt_head": {"dpt": {"refinenet5": {"out_conv": {"bias": np.zeros(1)}}}}}},
    {"downstream_head1": {"dpt": {"refinenet1": {"resConfUnit3": {"conv1": {"bias": np.zeros(1)}}}}}},
    {"downstream_head1": {"mlp_fc3": {"kernel": np.zeros((1, 1))}}},
    {"enc_norm2": {"scale": np.zeros(1)}},
], ids=["refinenet5", "resConfUnit3", "mlp_fc3", "enc_norm2"])
def test_from_jax_rejects_unknown_paths(tree):
    with pytest.raises(KeyError, match="no module of the port"):
        state_dict_from_jax(tree)


# production encoder widths with the decoder at CroCo v2's small-decoder
# widths, 512 wide with 16 heads (head_dim 32), one block each
SMALL_DECODER_KW = dict(PROD_DEPTH1_KW, dec_embed_dim=512, dec_num_heads=16)


def test_small_decoder_slice_matches_jax():
    """The whole model at SMALL_DECODER_KW (the encoder at head_dim 64, every
    decoder attention at head_dim 32, which the card serves on the tensor
    cores), f32, two 224² views, on weights carried from the Flax init by
    convert/from_jax: the port's forward against the Flax forward. Each
    output within 1e-4 of its own scale, as the whole-slice tests: f32
    rounding of two libraries through the trunk, amplified by the exp
    heads."""
    jcfg, tcfg = configs(**SMALL_DECODER_KW)
    assert tcfg.dec_embed_dim // tcfg.dec_num_heads == 32
    params = jax_model_params(jcfg, seed=4)
    rgb1, rgb2 = (_rng(s).uniform(0, 1, (1, 224, 224, 3)).astype(np.float32) for s in (8, 9))
    ref1, ref2 = JaxModel(jcfg).apply({"params": params}, jnp.asarray(rgb1), jnp.asarray(rgb2))
    model = AsymmetricCroCo3DStereo(tcfg)
    model.load_state_dict(torch_state(params), strict=True)
    with torch.no_grad():
        out1, out2 = model(torch.from_numpy(rgb1), torch.from_numpy(rgb2))
    assert sorted(out1) == sorted(ref1) and sorted(out2) == sorted(ref2)
    for ref, out in ((ref1, out1), (ref2, out2)):
        for k in ref:
            want = np.asarray(ref[k])
            got = to_np(out[k])
            assert got.shape == want.shape and np.isfinite(got).all(), k
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=k)


# production decoder widths with the encoder at head_dim 80 (a ViT-Huge
# encoder's: 1280 wide with 16 heads), cut to 160 wide with 2 heads, one
# block each
HEAD_DIM_80_KW = dict(PROD_DEPTH1_KW, enc_embed_dim=160, enc_num_heads=2)


def test_head_dim_80_encoder_slice_matches_jax():
    """The whole model at HEAD_DIM_80_KW (every encoder attention at
    head_dim 80, which the card serves on the packed route at width 128;
    the decoder at 64), f32, two 224² views, on weights carried from the
    Flax init by convert/from_jax: the port's forward against the Flax
    forward, each output within 1e-4 of its own scale (as the other
    whole-slice tests: f32 rounding of two libraries through the trunk,
    amplified by the exp heads)."""
    jcfg, tcfg = configs(**HEAD_DIM_80_KW)
    assert tcfg.enc_embed_dim // tcfg.enc_num_heads == 80
    params = jax_model_params(jcfg, seed=5)
    rgb1, rgb2 = (_rng(s).uniform(0, 1, (1, 224, 224, 3)).astype(np.float32) for s in (10, 11))
    ref1, ref2 = JaxModel(jcfg).apply({"params": params}, jnp.asarray(rgb1), jnp.asarray(rgb2))
    model = AsymmetricCroCo3DStereo(tcfg)
    model.load_state_dict(torch_state(params), strict=True)
    with torch.no_grad():
        out1, out2 = model(torch.from_numpy(rgb1), torch.from_numpy(rgb2))
    assert sorted(out1) == sorted(ref1) and sorted(out2) == sorted(ref2)
    for ref, out in ((ref1, out1), (ref2, out2)):
        for k in ref:
            want = np.asarray(ref[k])
            got = to_np(out[k])
            assert got.shape == want.shape and np.isfinite(got).all(), k
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=k)
