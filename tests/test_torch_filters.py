"""The port's filters, fire-scene preprocessing, depth refinement and JAX
random numbers against the JAX package, on the CPU.

Inputs are seeded numpy frames shaped like normalised Freiburg thermal frames
(a ramp, a wave, noise and a hot blob), at 37×53 (CLAHE pads its tiles) and
224² (the model's size). Limits, each measured here against the JAX
functions before it was set:
  * CLAHE, Sobel, the bilateral filter: max|Δ| ≤ 1e-6 of the output's scale
    (measured ≤ 2.4e-7: XLA and torch round a few float32 steps apart);
  * Canny: at most 1e-3 of the pixels may differ (measured 0: a pixel flips
    only when its gradient direction sits on a 22.5° sector edge, where
    XLA's and torch's atan2 may round apart);
  * the fire-scene variants of a gray frame (the CLI's input): at most 1e-3
    of the values beyond 1e-5 (measured 0; every other value within 6e-7);
    an RGB frame is its luma's (see the test);
  * the outlier median: within 1e-6 of the scale (measured: 1 float32 ulp
    on 0.1% of the pixels at 224², where the median is a midpoint);
  * the guided filter (and refine_depth, whose guided stage it is): JAX's
    float32 integral images cancel, and the port sums them in float64 (the
    same bits on every device), so the limit is twice JAX's own float32
    error against a float64 run of the same JAX function on the same input
    (plus 1e-6 of the scale for the bilateral stage; measured: 1.00-1.01×
    that error); in float64 the port and JAX agree to 1e-9;
  * threefry and the percentiles of the fire mask: bit-equal.
chip_smoke.py's phase 8 holds the card to the same limits against the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_common  # noqa: F401  (torch threads, exp warm-up)
from thermal3d.kernels import filters as jf
from thermal3d.preprocess import enhance as jenhance
from thermal3d.preprocess import fire_scene as jfire
from thermal3d.preprocess.refine import refine_depth as jax_refine
from thermal3d_torch.core import threefry
from thermal3d_torch.kernels import filters as tf
from thermal3d_torch.preprocess import enhance as tenhance
from thermal3d_torch.preprocess import fire_scene as tfire
from thermal3d_torch.preprocess.refine import refine_depth

SIZES = [(37, 53), (224, 224)]
SMOOTH_REL = 1e-6
EDGE_FRAC = 1e-3
FIRE_ATOL, FIRE_FRAC = 1e-5, 1e-3
GUIDED_FACTOR = 2.0


def frame(hw, seed=0):
    """A normalised thermal frame: raw counts 21000-26000 of a ramp, a wave,
    noise and a hot blob, / 65535."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    f = 0.5 * xx + 0.3 * (0.5 + 0.5 * np.sin(6 * xx + seed) * np.cos(4 * yy)) \
        + 0.2 * rng.uniform(size=hw)
    f = np.where((yy - 0.5) ** 2 + (xx - 0.6) ** 2 < 0.03, f + 0.8, f)
    return ((21000 + 5000 * f / f.max()).astype(np.uint16) / 65535.0).astype(np.float32)


def unit(x):
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32)


def depth_map(hw, seed=0):
    d = (5 + 30 * frame(hw, seed + 10)).astype(np.float32)
    d[2, 3], d[hw[0] // 2, hw[1] // 3] = 90.0, -40.0  # outliers
    return d


def close_rel(got, ref, limit=SMOOTH_REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= limit, err


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", [(1,), (7, 13), (224, 224), (512, 640)])
def test_uniform_is_jax_bit_for_bit(shape):
    got = threefry.uniform_f32(shape)
    ref = np.asarray(jax.random.uniform(jax.random.key(0), shape))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_threefry_bits_and_other_keys():
    """The raw bits, a key with both words set, and the documented value."""
    np.testing.assert_array_equal(threefry.random_bits32((5, 7)),
                                  np.asarray(jax.random.bits(jax.random.key(0), (5, 7))))
    key = jax.random.wrap_key_data(np.array([3, 0xDEADBEEF], np.uint32))
    np.testing.assert_array_equal(threefry.random_bits32((9,), (3, 0xDEADBEEF)),
                                  np.asarray(jax.random.bits(key, (9,))))
    assert threefry.uniform_f32((2, 3))[0, 0] == np.float32(0.947667)


@pytest.mark.parametrize("hw", SIZES)
def test_clahe_and_sobel_match_jax(hw):
    x = unit(frame(hw))
    for limit, grid in ((3.0, (8, 8)), (2.5, (8, 8)), (2.0, (3, 5))):
        close_rel(tf.clahe(t(x), limit, grid), jf.clahe(jnp.asarray(x), limit, grid))
    gx, gy = tf.sobel_xy(t(x))
    jgx, jgy = jf.sobel_xy(jnp.asarray(x))
    close_rel(gx, jgx)
    close_rel(gy, jgy)
    close_rel(tf.sobel_magnitude_normalized(t(x)), jf.sobel_magnitude_normalized(jnp.asarray(x)))


@pytest.mark.parametrize("hw", SIZES)
def test_canny_matches_jax(hw):
    x = unit(frame(hw, 1))
    for low, high in ((50.0, 150.0), (30.0, 150.0), (5.0, 20.0)):
        got = tf.canny_edges(t(x), low, high).numpy()
        ref = np.asarray(jf.canny_edges(jnp.asarray(x), low, high))
        assert set(np.unique(got)) <= {0.0, 1.0}
        assert np.mean(got != ref) <= EDGE_FRAC


@pytest.mark.parametrize("hw", SIZES)
def test_bilateral_matches_jax(hw):
    x = unit(frame(hw, 2))
    rgb = np.stack([x, x[::-1], x[:, ::-1]], axis=-1).copy()
    close_rel(tf.bilateral_filter(t(rgb), 9, 75.0 / 255.0, 75.0),
              jf.bilateral_filter(jnp.asarray(rgb), 9, 75.0 / 255.0, 75.0))
    d = depth_map(hw)
    close_rel(tf.bilateral_filter(t(d), 5, 50.0, 50.0),
              jf.bilateral_filter(jnp.asarray(d), 5, 50.0, 50.0))


def _guided_f32_error(guide, src):
    """max|JAX float32 − JAX float64| of the guided filter on these inputs."""
    f32 = np.asarray(jf.guided_filter(jnp.asarray(guide), jnp.asarray(src)), np.float64)
    with jax.enable_x64(True):
        f64 = np.asarray(jf.guided_filter(jnp.asarray(guide, jnp.float64),
                                          jnp.asarray(src, jnp.float64)))
    return np.abs(f32 - f64).max(), f64


@pytest.mark.parametrize("hw", SIZES)
def test_guided_filter_within_the_float32_error(hw):
    g, d = unit(frame(hw, 3)), depth_map(hw, 3)
    err32, f64 = _guided_f32_error(g, d)
    got = tf.guided_filter(t(g), t(d)).numpy()
    ref = np.asarray(jf.guided_filter(jnp.asarray(g), jnp.asarray(d)))
    assert np.abs(got.astype(np.float64) - ref).max() <= GUIDED_FACTOR * err32
    got64 = tf.guided_filter(t(g).double(), t(d).double()).numpy()
    np.testing.assert_allclose(got64, f64, rtol=0, atol=1e-9 * np.abs(f64).max())


@pytest.mark.parametrize("hw", SIZES)
def test_outliers_and_nan_statistics_match_jax(hw):
    d = depth_map(hw, 4)
    close_rel(tf.remove_depth_outliers(t(d)), jf.remove_depth_outliers(jnp.asarray(d)))
    close_rel(tf.remove_depth_outliers(t(d), 3, 2.0),
              jf.remove_depth_outliers(jnp.asarray(d), 3, 2.0))
    d[0, :5] = np.nan
    np.testing.assert_allclose(tf.nanmean(t(d)).item(), float(jnp.nanmean(jnp.asarray(d))),
                               rtol=1e-6)
    np.testing.assert_allclose(tf.nanstd(t(d)).item(), float(jnp.nanstd(jnp.asarray(d))),
                               rtol=1e-6)
    assert np.isnan(tf.nanstd(torch.full((3,), float("nan"))).item())


@pytest.mark.parametrize("hw", SIZES)
def test_refine_depth_matches_jax(hw):
    g, d = frame(hw, 5), depth_map(hw, 5)
    cleaned = np.asarray(jf.remove_depth_outliers(jnp.asarray(d)))
    err32, _ = _guided_f32_error(g, cleaned)
    ref = np.asarray(jax_refine(jnp.asarray(d), jnp.asarray(g)))
    got = refine_depth(t(d), t(g)).numpy()
    assert np.abs(got.astype(np.float64) - ref).max() <= (GUIDED_FACTOR * err32
                                                          + SMOOTH_REL * np.abs(ref).max())
    rgb = np.repeat(g[..., None], 3, axis=-1)
    close_rel(refine_depth(t(d), t(rgb), use_guided_filter=False),
              jax_refine(jnp.asarray(d), jnp.asarray(rgb), use_guided_filter=False))


def _fire_close(got, ref):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref))
    assert got.shape == ref.shape
    assert np.mean(diff > FIRE_ATOL) <= FIRE_FRAC, np.mean(diff > FIRE_ATOL)


@pytest.mark.parametrize("hw", SIZES)
def test_fire_scene_matches_jax(hw):
    for seed in (0, 1):
        x = frame(hw, seed)
        p = tfire.percentile_linear(t(x).reshape(-1), (5.0, 95.0)).numpy()
        np.testing.assert_array_equal(p, np.asarray(jnp.percentile(jnp.asarray(x).reshape(-1),
                                                                   jnp.array([5.0, 95.0]))))
        got = tfire.preprocess_fire_scene_thermal(t(x)).numpy()
        _fire_close(got, np.asarray(jfire.preprocess_fire_scene_thermal(jnp.asarray(x))))
        _fire_close(tfire.preprocess_fire_scene_thermal(t(x), key=(0, 7), fire_threshold=0.6)
                    .numpy(),
                    np.asarray(jfire.preprocess_fire_scene_thermal(
                        jnp.asarray(x), jax.random.key(7), fire_threshold=0.6)))


@pytest.mark.parametrize("variant", ["fire_scene", "advanced"])
def test_fire_scene_of_rgb_is_fire_scene_of_its_luma(variant):
    """An [H, W, 3] frame is processed as its luma. XLA's and torch's luma
    differ by 1 float32 ulp, and Canny's thresholds and hysteresis turn that
    into whole edges (up to 0.7% of the pixels at 224² against JAX), so the
    RGB path is held to the gray path of the port itself, and the luma to
    JAX's within an ulp."""
    x = frame((224, 224), 2)
    rgb = np.stack([x, x[::-1], x[:, ::-1]], axis=-1).copy()
    luma = tenhance.rgb_to_gray(t(rgb))
    np.testing.assert_allclose(luma.numpy(), np.asarray(jenhance.rgb_to_gray(jnp.asarray(rgb))),
                               rtol=0, atol=6e-8)
    fn = {"fire_scene": tfire.preprocess_fire_scene_thermal,
          "advanced": tfire.advanced_fire_scene_processing}[variant]
    np.testing.assert_array_equal(fn(t(rgb)).numpy(), fn(luma).numpy())


@pytest.mark.parametrize("hw", SIZES)
def test_advanced_fire_matches_jax(hw):
    x = frame(hw, 6)
    _fire_close(tfire.advanced_fire_scene_processing(t(x)).numpy(),
                np.asarray(jfire.advanced_fire_scene_processing(x)))
    # a frame with one histogram peak takes the 0.7 default threshold
    flat = np.full(hw, 0.5, np.float32)
    flat[: hw[0] // 3] = 0.9
    np.testing.assert_array_equal(tfire.fire_thresholds(flat), np.float32([0.7]))
    _fire_close(tfire.advanced_fire_scene_processing(t(flat), key=(0, 3)).numpy(),
                np.asarray(jfire.advanced_fire_scene_processing(flat, jax.random.key(3))))


def test_histogram_peaks_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(20):
        hist = rng.integers(0, 50, 100).astype(np.float64)
        for height, distance in ((10.0, 10), (30.0, 3), (0.0, 1)):
            np.testing.assert_array_equal(tfire._find_histogram_peaks(hist, height, distance),
                                          jfire._find_histogram_peaks(hist, height, distance))


def test_fixed_range_enhance_matches_jax():
    x = frame((37, 53), 9)
    for img in (x, np.repeat(x[..., None], 3, axis=-1), x[..., None]):
        np.testing.assert_allclose(tenhance.enhance_thermal_fixed_range(t(img)).numpy(),
                                   np.asarray(jenhance.enhance_thermal_fixed_range(
                                       jnp.asarray(img))), rtol=0, atol=1e-6)
    raw = x * 65535.0
    np.testing.assert_allclose(tenhance.enhance_thermal_fixed_range(t(raw), normalized=False)
                               .numpy(),
                               np.asarray(jenhance.enhance_thermal_fixed_range(
                                   jnp.asarray(raw), normalized=False)), rtol=0, atol=1e-6)
