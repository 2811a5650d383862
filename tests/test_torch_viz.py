"""The port's figures (thermal3d_torch/viz) against matplotlib 3.10.8 and cv2,
on the CPU: every colormap bit-equal to matplotlib's Normalize + Colormap
mapping (NaN and out-of-range values included), the PNG encoder read back by
cv2 and by the port's decoder, and each figure's tiles, decoded from the PNG
it writes, equal to what matplotlib maps (and, for the comparison panel's
thermal tile, to what cv2.imread shows). Matplotlib and cv2 are imported by
this test only."""

import os

import cv2
import matplotlib
import numpy as np
import pytest
from matplotlib import colormaps
from matplotlib.cm import ScalarMappable
from matplotlib.colors import Normalize

import tests.test_torch_common  # noqa: F401  (torch threads)
from thermal3d.viz import panels as jax_panels
from thermal3d_torch import native
from thermal3d_torch.viz import colormaps as tcm
from thermal3d_torch.viz import panels
from thermal3d_torch.viz.png import encode_png_rgb

NAMES = ["plasma", "viridis", "hot", "gray"]


def mpl(x, name, vmin=None, vmax=None):
    return colormaps[name](Normalize(vmin, vmax)(x), bytes=True)


def values(dtype=np.float32):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(41, 29)) * 2).astype(dtype)
    x[0, 0], x[1, 1], x[2, 2], x[3, 3], x[4, 4] = np.nan, 3.0, -1.0, 1e30, -np.inf
    return x


def test_matplotlib_version_of_the_tables():
    assert matplotlib.__version__ == "3.10.8"
    for name in NAMES:
        np.testing.assert_array_equal(tcm.rgba_table(name)[:256],
                                      colormaps[name](np.arange(256), bytes=True))


@pytest.mark.parametrize("name", NAMES)
def test_colormap_is_matplotlib_bit_for_bit(name):
    x = values()
    for vmin, vmax in ((-1.0, 3.0), (0, 1), (np.float32(-0.3), np.float32(0.7)), (0.5, 0.5),
                       (-2.3333, 1.1), (0.0, np.float32(2.5))):
        np.testing.assert_array_equal(tcm.colormap(x, name, vmin, vmax), mpl(x, name, vmin, vmax))
    x64 = values(np.float64)
    np.testing.assert_array_equal(tcm.colormap(x64, name, -1, 2.5), mpl(x64, name, -1, 2.5))
    finite = np.nan_to_num(values(), nan=0.0, posinf=4.0, neginf=-4.0)
    np.testing.assert_array_equal(tcm.colormap(finite, name), mpl(finite, name))
    ints = np.arange(-3, 300, dtype=np.int16).reshape(3, -1)
    np.testing.assert_array_equal(tcm.colormap(ints, name, 0, 255), mpl(ints, name, 0, 255))
    with pytest.raises(ValueError):
        tcm.colormap(x, name, 1.0, 0.0)


def test_png_reads_back_through_cv2_and_the_port(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (23, 37, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(encode_png_rgb(img))
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), img)
    decoded, depth = native.decode_png(path)
    assert depth == 8
    np.testing.assert_array_equal(decoded.astype(np.uint8), img)
    with pytest.raises(ValueError):
        encode_png_rgb(img.astype(np.float32))


def read(path):
    decoded, _ = native.decode_png(path)
    return decoded.astype(np.uint8)


def test_depth_result_panel(tmp_path):
    """input | depth (plasma) + colorbar | confidence (viridis) + colorbar."""
    rng = np.random.default_rng(2)
    thermal = rng.uniform(-0.1, 1.1, (3, 30, 40)).astype(np.float32)  # CHW, clipped
    depth = rng.uniform(1, 9, (30, 40)).astype(np.float32)
    depth[3, 4] = np.nan
    conf = rng.uniform(1, 3, (30, 40)).astype(np.float32)
    path = str(tmp_path / "d.png")
    assert panels.visualize_depth_result(thermal, depth, conf, save_path=path) is None
    img = read(path)
    hwc = np.clip(thermal.transpose(1, 2, 0), 0, 1)
    np.testing.assert_array_equal(img[:, :40], ScalarMappable().to_rgba(hwc, bytes=True)[..., :3])
    x = 40 + panels.GAP
    want = mpl(depth, "plasma", np.nanmin(depth), np.nanmax(depth))
    finite = ~np.isnan(depth)
    np.testing.assert_array_equal(img[:, x:x + 40][finite], want[..., :3][finite])
    assert (img[3, x + 4] == 255).all()  # NaN: transparent on white
    bar = img[:, x + 40 + panels.BAR_GAP:x + 40 + panels.BAR_GAP + panels.BAR_WIDTH]
    np.testing.assert_array_equal(bar[0, 0], colormaps["plasma"](255, bytes=True)[:3])
    np.testing.assert_array_equal(bar[-1, 0], colormaps["plasma"](0, bytes=True)[:3])
    x += 40 + panels.BAR_GAP + panels.BAR_WIDTH + panels.GAP
    np.testing.assert_array_equal(img[:, x:x + 40], mpl(conf, "viridis")[..., :3])
    assert img.shape == (30, x + 40 + panels.BAR_GAP + panels.BAR_WIDTH, 3)
    two = panels.visualize_depth_result(hwc, depth)  # no confidence: returned, two tiles
    assert two.shape == (30, 40 + panels.GAP + 40 + panels.BAR_GAP + panels.BAR_WIDTH, 3)


@pytest.mark.parametrize("kind", ["gray16", "rgb8", "gray8", "corrupt"])
def test_comparison_panel_thermal_tile_is_what_cv2_shows(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "t.png")
    if kind == "gray16":
        cv2.imwrite(path, rng.integers(0, 65536, (20, 24)).astype(np.uint16))
    elif kind == "rgb8":
        cv2.imwrite(path, rng.integers(0, 256, (20, 24, 3)).astype(np.uint8))
    elif kind == "gray8":
        cv2.imwrite(path, rng.integers(0, 256, (20, 24)).astype(np.uint8))
    else:
        open(path, "wb").write(b"\x89PNG\r\n\x1a\nbroken")
    pred = rng.uniform(1, 5, (16, 16)).astype(np.float32)
    gt = rng.uniform(0, 5, (16, 16)).astype(np.float32)
    out = str(tmp_path / "c.png")
    panels.save_comparison_panel(path, pred, gt, 0.5, out)
    img = read(out)
    shown = cv2.imread(path)
    if shown is None:
        assert (img[:16, :16] == 255).all()
        w = 16
    else:
        w = shown.shape[1]
        np.testing.assert_array_equal(img[:20, :w], cv2.cvtColor(shown, cv2.COLOR_BGR2RGB))
    x = w + panels.GAP
    np.testing.assert_array_equal(img[:16, x:x + 16], mpl(pred, "plasma")[..., :3])
    x += 16 + panels.GAP
    np.testing.assert_array_equal(img[:16, x:x + 16], mpl(gt, "plasma")[..., :3])


def test_pseudo_gt_panel_and_depth_preview(tmp_path):
    rng = np.random.default_rng(4)
    rgb1, rgb2 = rng.uniform(size=(2, 12, 14, 3)).astype(np.float32)
    d1 = rng.uniform(1, 3, (12, 14)).astype(np.float32)
    d2 = rng.uniform(2, 6, (12, 14)).astype(np.float32)
    path = str(tmp_path / "p.png")
    panels.visualize_data(rgb1, rgb2, d1, d2, save_path=path)
    img = read(path)
    vmin, vmax = jax_panels._depth_limits(d1, d2)
    assert (vmin, vmax) == panels._depth_limits(d1, d2)
    np.testing.assert_array_equal(img[:12, :14], (rgb1 * 255).astype(np.uint8))
    np.testing.assert_array_equal(img[:12, 14 + panels.GAP:28 + panels.GAP],
                                  (rgb2 * 255).astype(np.uint8))
    y = 12 + panels.GAP
    np.testing.assert_array_equal(img[y:y + 12, :14], mpl(d1, "plasma", vmin, vmax)[..., :3])
    x = 14 + panels.BAR_GAP + panels.BAR_WIDTH + panels.GAP
    np.testing.assert_array_equal(img[y:y + 12, x:x + 14], mpl(d2, "plasma", vmin, vmax)[..., :3])
    assert panels._depth_limits(np.ones(3), np.ones(2)) == jax_panels._depth_limits(np.ones(3),
                                                                                   np.ones(2))
    chw = np.zeros((3, 5, 7))
    assert panels._to_hwc(chw).shape == jax_panels._to_hwc(chw).shape == (5, 7, 3)

    prev = str(tmp_path / "v.png")
    panels.save_depth_vis(d2, prev)
    np.testing.assert_array_equal(read(prev)[:, :14], mpl(d2, "plasma")[..., :3])


def test_stage_strip(tmp_path):
    rng = np.random.default_rng(5)
    thermal = rng.uniform(0.3, 0.4, (10, 12)).astype(np.float32)
    depths = {"original": rng.uniform(0, 2, (10, 12)).astype(np.float32),
              "final": rng.uniform(0, 5, (10, 12)).astype(np.float32)}
    path = str(tmp_path / "s.png")
    panels.stage_strip(thermal, depths, path)
    img = read(path)
    np.testing.assert_array_equal(img[:, :12], mpl(thermal, "gray")[..., :3])
    vmax = max(np.nanmax(d) for d in depths.values())
    x = 12 + panels.GAP
    for d in depths.values():
        np.testing.assert_array_equal(img[:, x:x + 12], mpl(d, "viridis", 0.0, vmax)[..., :3])
        x += 12 + panels.BAR_GAP + panels.BAR_WIDTH + panels.GAP
    assert img.shape[1] == x - panels.GAP
    assert os.path.getsize(path) > 0
