"""The port's preprocessing (resize, grayscale, percentile enhance) against
thermal3d.preprocess."""

import dataclasses

import numpy as np
import pytest
import torch

import tests.test_torch_common  # noqa: F401  (torch thread count)
from thermal3d.core.config import PreprocessConfig as JaxPreprocessConfig
from thermal3d.preprocess.enhance import enhance_thermal_contrast as jax_enhance
from thermal3d.preprocess.enhance import percentile_rescale as jax_percentile_rescale
from thermal3d.preprocess.enhance import rgb_to_gray as jax_rgb_to_gray
from thermal3d.preprocess.resize import _axis_matrix
from thermal3d.preprocess.resize import resize_bilinear_hw as jax_resize
from thermal3d_torch.preprocess.enhance import (enhance_thermal_contrast, percentile_rescale,
                                                rgb_to_gray)
from thermal3d_torch.core.config import PreprocessConfig
from thermal3d_torch.preprocess.resize import axis_matrix, resize_bilinear_hw


def test_preprocess_config_equals_jax():
    """PreprocessConfig: the JAX dataclass's fields, in its order, with its
    defaults, frozen."""
    got, want = PreprocessConfig(), JaxPreprocessConfig()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in
                                                         dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.raw_min = 0


@pytest.mark.parametrize("n_in,n_out", [(320, 224), (416, 224), (480, 224),
                                        (640, 224), (64, 32), (32, 64)])
def test_half_pixel_matrix_matches_jax_image_resize(n_in, n_out):
    """Re-derived in numpy vs extracted from jax.image.resize: atol 1e-6
    (both compute the weights in f32; JAX's matrix also passes through a
    resize of an identity image)."""
    np.testing.assert_allclose(axis_matrix(n_in, n_out), _axis_matrix(n_in, n_out, False),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(14, 28), (28, 14), (7, 224)])
def test_align_corners_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(axis_matrix(n_in, n_out, True),
                                  _axis_matrix(n_in, n_out, False, True))


def test_resize_same_size_is_identity():
    assert axis_matrix(224, 224) is None
    x = torch.rand(2, 224, 224)
    assert torch.equal(resize_bilinear_hw(x, (224, 224)), x)


def test_resize_matches_jax():
    """Serving resize [2,320,416] → 224²: f32 matmuls on both sides, atol 1e-5
    on values in [0.3, 0.4] (JAX's HIGH precision is full f32 on the CPU)."""
    x = np.random.default_rng(0).uniform(0.3, 0.4, (2, 320, 416)).astype(np.float32)
    ref = np.asarray(jax_resize(x, (224, 224)))
    out = resize_bilinear_hw(torch.from_numpy(x), (224, 224)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_rgb_to_gray_matches_jax():
    x = np.random.default_rng(1).uniform(size=(2, 8, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(rgb_to_gray(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_rgb_to_gray(x)), rtol=0, atol=1e-6)
    g = x[..., :1]
    np.testing.assert_array_equal(rgb_to_gray(torch.from_numpy(g)).numpy(), g[..., 0])


def _thermal_like(shape, seed):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, shape[-1], dtype=np.float32)
    raw = 21000.0 + 5000.0 * (0.6 * ramp + 0.4 * rng.uniform(size=shape))
    return (raw / 65535.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["thermal", "flat"])
def test_sort_path_matches_jax(kind):
    """Linear-interpolation quantile with the zero-span guard (a flat frame
    maps to 0): atol 1e-5 (f32 interpolation and division, with the span of
    thermal frames ~0.05)."""
    x = (_thermal_like((3, 48, 64), 2) if kind == "thermal"
         else np.full((3, 48, 64), 0.35, np.float32))
    ref = np.asarray(jax_percentile_rescale(x, impl="sort"))
    out = percentile_rescale(torch.from_numpy(x), impl="sort").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if kind == "flat":
        assert (out == 0).all()


def test_enhance_auto_on_cpu_is_sort_and_matches_jax():
    """enhance_thermal_contrast on a [B,H,W] batch: 3 identical channels,
    'auto' takes the sort path on the CPU (as JAX's does off TPU)."""
    x = _thermal_like((2, 40, 48), 3)
    ref = np.asarray(jax_enhance(x, impl="sort"))
    out = enhance_thermal_contrast(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 40, 48, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        out, enhance_thermal_contrast(torch.from_numpy(x), impl="sort").numpy())


def test_enhance_plain_matches_jax_pallas_path():
    """impl='plain': min/max normalisation + K1's plain version, against
    JAX's Pallas path in interpret mode: the same order statistics, so
    agreement to f32 rounding of the normalisation (atol 1e-6)."""
    from thermal3d.preprocess.enhance import _percentile_rescale_pallas

    x = _thermal_like((2, 56, 56), 4)
    ref = np.asarray(_percentile_rescale_pallas(x, 2.0, 98.0, interpret=True))
    out = percentile_rescale(torch.from_numpy(x), impl="plain").numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_unknown_enhance_impl_raises():
    with pytest.raises(ValueError):
        percentile_rescale(torch.zeros(1, 4, 4), impl="pallas")


def test_resize_matrix_cached_in_inference_mode_serves_autograd():
    """The resampling matrices are cached by shape; one first made inside
    torch.inference_mode (a serving call) must not break a later training
    step's backward through the same resize."""
    from thermal3d_torch.preprocess.resize import resize_bilinear_hw

    with torch.inference_mode():
        resize_bilinear_hw(torch.rand(2, 37, 29), (11, 13))
    x = torch.rand(2, 37, 29, requires_grad=True)
    resize_bilinear_hw(x, (11, 13)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
