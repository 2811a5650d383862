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

NAMES = ["plasma", "viridis", "hot", "gray", "jet"]


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


# ---------------------------------------------------------------------------
# the IR displays, the 3-D panels and the sampler (thermal3d/viz/panels.py
# :149-459, thermal3d/viz/sampler.py)
# ---------------------------------------------------------------------------

def _ir_frame(seed=6, hw=(30, 40), border=2):
    """uint16 raw counts with a dead (zero) border."""
    rng = np.random.default_rng(seed)
    ir = rng.integers(21000, 26000, hw).astype(np.uint16)
    ir[:border], ir[:, :border] = 0, 0
    return ir


def test_ir_arrays_match_jax(tmp_path):
    """colorize_ir (array and file), remove_black_borders and
    overlay_rgb_thermal return JAX's arrays exactly (jet as matplotlib
    maps it; the file read by the port's decoder against cv2)."""
    ir = _ir_frame()
    path = str(tmp_path / "ir.png")
    cv2.imwrite(path, ir)
    np.testing.assert_array_equal(panels.colorize_ir(ir), jax_panels.colorize_ir(ir))
    np.testing.assert_array_equal(panels.colorize_ir(path), jax_panels.colorize_ir(path))
    np.testing.assert_array_equal(panels.colorize_ir(ir, 21000.0, 26000.0),
                                  jax_panels.colorize_ir(ir, 21000.0, 26000.0))
    for t in (ir, np.zeros((5, 6)), ir.astype(np.float32)):
        np.testing.assert_array_equal(panels.remove_black_borders(t),
                                      jax_panels.remove_black_borders(t))
    assert panels.remove_black_borders(ir).shape == (28, 38)
    rgb = np.random.default_rng(7).uniform(-0.2, 1.2, (30, 40, 3)).astype(np.float32)
    for thermal in (ir.astype(np.float32), np.repeat(ir[..., None], 3, -1), ir[:, :] * 0):
        for alpha in (0.5, 0.3):
            got = panels.overlay_rgb_thermal(rgb, thermal, alpha)
            want = jax_panels.overlay_rgb_thermal(rgb, thermal, alpha)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        panels.colorize_ir(str(tmp_path / "missing.png"))


def test_ir_figures(tmp_path):
    """visualize_ir: jet over the fixed window with a colorbar;
    visualize_ir_standalone: gray | colorized; visualize_enhanced_thermal:
    the JAX function's enhanced array (a crop that needs no resize, so the
    port's resize and cv2's agree) and the raw jet tile beside the display."""
    ir = _ir_frame(hw=(28, 38))
    path = str(tmp_path / "ir.png")
    cv2.imwrite(path, ir)
    fig = panels.visualize_ir(ir)
    np.testing.assert_array_equal(fig[:, :38], mpl(ir, "jet", 21800, 23700)[..., :3])
    assert fig.shape == (28, 38 + panels.BAR_GAP + panels.BAR_WIDTH, 3)
    out = str(tmp_path / "s.png")
    colored = panels.visualize_ir_standalone(path, save_path=out)
    np.testing.assert_array_equal(colored, jax_panels.colorize_ir(ir))
    img = read(out)
    np.testing.assert_array_equal(img[:, :38], mpl(ir, "gray")[..., :3])
    np.testing.assert_array_equal(img[:, 38 + panels.GAP:], colored)
    enh_path = str(tmp_path / "e.png")
    got = panels.visualize_enhanced_thermal(path, img_size=(36, 26), save_path=enh_path,
                                            device="cpu")
    want = jax_panels.visualize_enhanced_thermal(path, img_size=(36, 26))
    assert got.shape == want.shape == (26, 36, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(read(enh_path)[:, :38], jax_panels.colorize_ir(ir))


def test_3d_projection_matches_mplot3d():
    """view3d.projection and project restate Axes3D.get_proj and
    proj3d.proj_transform at the reference figure's view (no view_init:
    elevation 30, azimuth -60, perspective), on the same limits."""
    from mpl_toolkits.mplot3d import proj3d

    import matplotlib.pyplot as plt
    from thermal3d_torch.viz import view3d

    rng = np.random.default_rng(8)
    pts = rng.normal(size=(200, 3)) * (1.0, 2.0, 0.5) + (0.0, 1.0, 5.0)
    lims = view3d.limits(pts)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim3d(*lims[0])
    ax.set_ylim3d(*lims[1])
    ax.set_zlim3d(*lims[2])
    m = ax.get_proj()
    plt.close(fig)
    np.testing.assert_allclose(view3d.projection(*lims), m, rtol=1e-12, atol=1e-15)
    want = proj3d.proj_transform(pts[:, 0], pts[:, 1], pts[:, 2], m)
    for a, b in zip(view3d.project(pts, view3d.projection(*lims)), want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    view = view3d.View(lims)
    xy, _ = view.pixels(pts)
    assert (xy >= 0).all() and (xy <= view3d.TILE - 1).all()
    # screen x grows with the projected x, screen rows down as projected y rises
    order_x, order_y = np.argsort(want[0]), np.argsort(-want[1])
    assert (np.diff(xy[order_x, 0]) >= -1e-9).all() and (np.diff(xy[order_y, 1]) >= -1e-9).all()


def _pgt_dir(root, name="0001_0002"):
    rng = np.random.default_rng(9)
    for sub in ("pointmap1", "pointmap2", "poses", "intrinsics"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    pm1 = np.concatenate([rng.uniform(-1, 1, (12, 16, 2)), rng.uniform(2, 4, (12, 16, 1))], -1)
    pm2 = pm1 + (0.3, 0.0, 0.2)
    pm1[0, 0, 2] = -1.0  # behind the camera: not drawn
    pose = np.eye(4)
    pose[:3, 3] = (0.3, 0.0, 0.2)
    np.save(os.path.join(root, "pointmap1", f"fl_rgb_{name}.npy"), pm1.astype(np.float32))
    np.save(os.path.join(root, "pointmap2", f"{name}.npy"), pm2.astype(np.float32))
    np.save(os.path.join(root, "poses", f"{name}.npy"), pose.astype(np.float32))
    np.save(os.path.join(root, "intrinsics", f"{name}.npy"), np.eye(3, dtype=np.float32))
    return name, pm1, pm2


@pytest.mark.parametrize("merged", [False, True])
def test_pair_panels_from_dir(tmp_path, merged, capsys):
    """visualize_pair_from_dir reads the pseudo-GT layout by pair name (a
    prefixed pointmap1 file too) and writes the file the JAX function
    writes; its tiles are the gray depth view, the depth in plasma with a
    colorbar, and a 3-D view with the clouds (and, unmerged, view 2 in red
    and the cameras' axes in red, green and blue)."""
    root = str(tmp_path / "pgt")
    name, pm1, pm2 = _pgt_dir(root)
    out = str(tmp_path / "port.png")
    assert panels.visualize_pair_from_dir(root, name, merged=merged, save_path=out) is None
    jax_out = str(tmp_path / "jax.png")
    jax_panels.visualize_pair_from_dir(root, name, merged=merged, save_path=jax_out)
    assert os.path.exists(out) and os.path.exists(jax_out)
    if not merged:
        assert "Relative Pose" in capsys.readouterr().out
    img = read(out)
    d1 = pm1[..., 2]
    gray = np.repeat(((d1 - d1.min()) / (float(np.ptp(d1)) + 1e-6))[..., None], 3, -1)
    np.testing.assert_array_equal(img[:12, :16], panels.rgb_tile(gray))
    x = 16 + panels.GAP
    finite = np.isfinite(d1)
    want = mpl(d1, "plasma", np.nanmin(d1), np.nanmax(d1))[..., :3]
    np.testing.assert_array_equal(img[:12, x:x + 16][finite], want[finite])
    x += 16 + panels.BAR_GAP + panels.BAR_WIDTH + panels.GAP
    cloud = img[:480, x:x + 480]
    assert cloud.shape == (480, 480, 3) and (cloud != 255).any(axis=-1).sum() > 100
    colours = {tuple(c) for c in cloud.reshape(-1, 3)}
    if not merged:
        assert {(255, 0, 0), (0, 128, 0), (0, 0, 255), (0, 0, 0)} <= colours


def test_point_cloud_panel_and_cameras():
    """plot_point_cloud: the plasma cloud with its colorbar, or the RGB
    colours; with a pose the camera lines are drawn; invalid points are
    dropped as the reference drops them."""
    rng = np.random.default_rng(10)
    pm = np.concatenate([rng.uniform(-1, 1, (16, 16, 2)), rng.uniform(1, 3, (16, 16, 1))], -1)
    pm[0, :4, 2] = -1.0
    pose = np.eye(4)
    pose[:3, 3] = (0.5, 0.0, 0.0)
    fig = panels.plot_point_cloud(pm, pose=pose, subsample=2)
    assert fig.shape == (480, 480 + panels.BAR_GAP + panels.BAR_WIDTH, 3)
    assert len(panels.valid_points(pm, 2)) == 64 - 2
    colours = {tuple(c) for c in fig[:, :480].reshape(-1, 3)}
    assert {(255, 0, 0), (0, 128, 0), (0, 0, 255)} <= colours
    rgb = np.full((16, 16, 3), 0.5)
    fig = panels.plot_point_cloud(pm, color_img=rgb)
    assert fig.shape == (480, 480, 3)
    assert set(map(tuple, fig.reshape(-1, 3))) == {(255, 255, 255), (127, 127, 127)}


def test_sampler_panels():
    """visualize_pair (gray tiles, enhanced RGB), visualize_pair_merged
    (depths on shared limits) and sample_dataset (rows of normalised
    thermal pairs and the GT depth, the reference's random draw)."""
    from thermal3d_torch.viz import sampler

    rng = np.random.default_rng(11)
    t1, t2 = rng.uniform(0, 1, (2, 10, 12)).astype(np.float32)
    e1 = rng.uniform(0, 1, (10, 12, 3)).astype(np.float32)
    fig = sampler.visualize_pair(t1, t2, e1, e1)
    np.testing.assert_array_equal(fig[:, :12], mpl(t1, "gray")[..., :3])
    np.testing.assert_array_equal(fig[:, 2 * (12 + panels.GAP):3 * 12 + 2 * panels.GAP],
                                  (e1 * 255).astype(np.uint8))
    d1, d2 = rng.uniform(1, 3, (2, 10, 12)).astype(np.float32)
    fig = sampler.visualize_pair_merged(t1, t2, d1, d2)
    vmin, vmax = panels._depth_limits(d1, d2)
    np.testing.assert_array_equal(fig[10 + panels.GAP:, 12 + panels.GAP:],
                                  mpl(d2, "plasma", vmin, vmax)[..., :3])
    data = [{"thermal1": t1[..., None].repeat(3, -1), "thermal2": t2[..., None].repeat(3, -1),
             "pointmap1": np.stack([d1] * 3, -1)} for _ in range(5)]
    fig = sampler.sample_dataset(data, n=3, seed=0)
    assert fig.shape == (3 * 10 + 2 * panels.GAP, 3 * 12 + 2 * panels.GAP, 3)


def test_cli_explore_writes_what_the_jax_cli_writes(tmp_path):
    """cli.explore's census and --samples panels: the JAX CLI's report and
    file names on the same drive tree (2 sequences, 4 frames in one drive:
    the first drive's 2 frames fill --samples 2); each panel is RGB |
    colorize_ir | the overlay."""
    from thermal3d.cli.explore import main as jax_main
    from thermal3d_torch.cli.explore import main

    rng = np.random.default_rng(12)
    for seq, n in (("seq_00_day", 4), ("seq_01_night", 1)):
        d = tmp_path / "ds" / "train" / seq / "00"
        (d / "fl_rgb").mkdir(parents=True)
        (d / "fl_ir_aligned").mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(d / "fl_rgb" / f"fl_rgb_{i}.png"),
                        rng.integers(0, 255, (16, 18, 3)).astype(np.uint8))
            cv2.imwrite(str(d / "fl_ir_aligned" / f"fl_ir_aligned_{i}.png"),
                        rng.integers(21000, 26000, (16, 18)).astype(np.uint16))
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    argv = ["--dataset_dir", str(tmp_path / "ds"), "--samples", "2"]
    report = main(argv + ["--output_dir", str(port_out)])
    assert report == jax_main(argv + ["--output_dir", str(jax_out)])
    names = sorted(os.listdir(port_out))
    assert names == sorted(os.listdir(jax_out)) == ["seq_00_day_00_sample_0.png",
                                                    "seq_00_day_00_sample_1.png"]
    d = tmp_path / "ds" / "train" / "seq_00_day" / "00"
    rgb = cv2.cvtColor(cv2.imread(str(d / "fl_rgb" / "fl_rgb_0.png")), cv2.COLOR_BGR2RGB)
    ir = cv2.imread(str(d / "fl_ir_aligned" / "fl_ir_aligned_0.png"), cv2.IMREAD_ANYDEPTH)
    img = read(str(port_out / names[0]))
    np.testing.assert_array_equal(img[:, :18], rgb)
    np.testing.assert_array_equal(img[:, 18 + panels.GAP:36 + panels.GAP],
                                  jax_panels.colorize_ir(ir))
    overlay = jax_panels.overlay_rgb_thermal(rgb.astype(np.float32) / 255.0,
                                             ir.astype(np.float32))
    np.testing.assert_array_equal(img[:, 36 + 2 * panels.GAP:], panels.rgb_tile(overlay))
