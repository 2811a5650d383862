"""The MASt3R-512 pseudo-GT slice of the port against the JAX package: the
align-corners resize, the DPT family of heads, the hook-list decoder, the
converter's DPT/catmlpdpt keys, the geometry, and the whole generator.
Flax param trees (drawn with numpy from a seed) reach the port through its
convert/from_jax.py."""

import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import StandInLibrary, record_device_blocks, torch_state
from thermal3d.convert.flax_to_torch import export_state_dict
from thermal3d.core.config import DustrModelConfig as JaxConfig
from thermal3d.core.config import HeadConfig as JaxHeadConfig
from thermal3d.geometry import intrinsics as jintr
from thermal3d.geometry import umeyama as jume
from thermal3d.models import heads as jheads
from thermal3d.models.dustr import AsymmetricCroCo3DStereo as JaxModel
from thermal3d.preprocess.resize import resize_bilinear_hwc as jax_resize_hwc
from thermal3d.pseudo_gt.generator import PseudoGTGenerator as JaxGenerator
from thermal3d_torch.convert.from_jax import state_dict_from_jax
from thermal3d_torch.core.config import DustrModelConfig, HeadConfig
from thermal3d_torch.geometry.calibration import load_thermal_calibration
from thermal3d_torch.geometry.intrinsics import estimate_camera_intrinsics, nanmedian_midpoint
from thermal3d_torch.geometry.umeyama import (GeometryException, extract_relative_pose,
                                              umeyama_alignment)
from thermal3d_torch.kernels import umeyama3x3
from thermal3d_torch.kernels.umeyama3x3 import kabsch3x3, kabsch3x3_plain
from thermal3d_torch.models import heads
from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo
from thermal3d_torch.preprocess.resize import resize_bilinear_hwc
from thermal3d_torch.pseudo_gt.generator import OUTPUT_DIRS, PseudoGTGenerator

# tests/test_pseudo_gt.py's TINY_MASTR_KW, built for both packages
TINY_HEAD = dict(head_type="catmlpdpt", feature_dim=32, last_dim=16,
                 dpt_layer_dims=(8, 16, 24, 32), local_feat_dim=6)
TINY_TRUNK = dict(img_size=(32, 32), enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
                  dec_embed_dim=48, dec_depth=2, dec_num_heads=2)
# production widths (ViT-L, base decoder, the real DPT and catmlpdpt dims),
# one encoder block, a 2-block decoder, 64×64
PROD_TRUNK = dict(img_size=(64, 64), enc_depth=1, dec_depth=2)

# f32 through the trunk in two libraries (other summation orders), then the
# exp/expm1 heads: as the serving slice's whole-path test (rtol 1e-4 of each
# output's own scale)
OUT_RTOL = 1e-4


def _configs(trunk, head=None, **kw):
    head = head or {}
    return (JaxConfig(**trunk, head=JaxHeadConfig(**head), **kw),
            DustrModelConfig(**trunk, head=HeadConfig(**head), **kw))


def _rng(seed):
    return np.random.default_rng(seed)


def _params(jcfg, seed=0):
    """A Flax param tree for jcfg, drawn with numpy: shapes from an abstract
    init (no XLA compile), kernels normal with std 1/sqrt(fan_in), biases and
    LayerNorm scales perturbed from 0 and 1 so that every converted leaf
    matters."""
    h, w = jcfg.img_size
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(jax.random.key(0), dummy, dummy))
    rng = _rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _close(out, ref, rtol, what):
    assert out.shape == ref.shape, what
    assert np.isfinite(out).all(), what
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("shape,out_hw", [((2, 5, 7, 3), (10, 14)), ((1, 4, 4, 8), (7, 9))])
def test_resize_bilinear_hwc_align_corners_matches_jax(shape, out_hw):
    """The same matrices in f32 (JAX at HIGHEST precision): 1e-6."""
    x = _rng(0).standard_normal(shape).astype(np.float32)
    ref = jax_resize_hwc(jnp.asarray(x), out_hw, align_corners=True,
                         precision=jax.lax.Precision.HIGHEST)
    out = resize_bilinear_hwc(torch.from_numpy(x), out_hw, align_corners=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    bf = resize_bilinear_hwc(torch.from_numpy(x).to(torch.bfloat16), out_hw, align_corners=True)
    assert bf.dtype == torch.bfloat16


def _load_head_part(module, head_tree, prefix):
    """Load a Flax head subtree (as it sits under downstream_head1) into a
    port submodule through the converter, stripping the torch key prefix."""
    sd = state_dict_from_jax({"downstream_head1": head_tree})
    prefix = "downstream_head1." + prefix
    assert all(k.startswith(prefix) for k in sd)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)


def test_feature_fusion_block_odd_grid_matches_flax():
    """The ×2 upsample overshoots an odd skip grid and is cropped to it
    (3×4 → 6×8 → 5×7), as the JAX block does: f32, 1e-5."""
    fd = 8
    x = _rng(1).standard_normal((2, 3, 4, fd)).astype(np.float32)
    skip = _rng(2).standard_normal((2, 3, 4, fd)).astype(np.float32)
    jblk = jheads._FeatureFusionBlock(fd)
    params = jblk.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(skip),
                       out_hw=(5, 7))["params"]
    ref = jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(skip), out_hw=(5, 7))
    blk = heads._FeatureFusionBlock(fd, torch.float32)
    _load_head_part(blk, {"dpt": {"refinenet3": jax.tree_util.tree_map(np.asarray, params)}},
                    "dpt.scratch.refinenet3.")
    with torch.no_grad():
        out = blk(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(skip).permute(0, 3, 1, 2), out_hw=(5, 7))
    assert out.shape == (2, fd, 5, 7)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)


_HEAD_CFG = dict(feature_dim=16, last_dim=8, dpt_layer_dims=(4, 8, 12, 16),
                 local_feat_dim=6)
_IN_DIMS = (32, 24, 24, 24)


def _hooks(grid, seed):
    rng = _rng(seed)
    s = grid[0] * grid[1]
    return [rng.standard_normal((2, s, d)).astype(np.float32) for d in _IN_DIMS]


@pytest.mark.parametrize("kind,two_confs", [("dpt", True), ("pts3d", True),
                                            ("catmlpdpt", True), ("catmlpdpt", False)])
def test_dpt_heads_match_flax(kind, two_confs):
    """DPTHead (raw map), DPTPts3dHead and CatMLPDPTHead (with desc and
    desc_conf, two confidences or one) on a 3×5 grid, which exercises the
    crops; f32, OUT_RTOL of each output's scale."""
    grid, p = (3, 5), 4
    hooks = _hooks(grid, seed=3)
    jh = [jnp.asarray(t) for t in hooks]
    jcfg = JaxHeadConfig(head_type="catmlpdpt", two_confs=two_confs, **_HEAD_CFG)
    tcfg = HeadConfig(head_type="catmlpdpt", two_confs=two_confs, **_HEAD_CFG)
    if kind == "dpt":
        jhead, args = jheads.DPTHead(jcfg, num_channels=4), (jh, grid)
        head = heads.DPTHead(tcfg, _IN_DIMS, 4, torch.float32)
    elif kind == "pts3d":
        jhead, args = jheads.DPTPts3dHead(jcfg), (jh, grid)
        head = heads.DPTPts3dHead(tcfg, _IN_DIMS, torch.float32)
    else:
        jhead, args = jheads.CatMLPDPTHead(p, jcfg), (jh, grid, jh[0], jh[-1])
        head = heads.CatMLPDPTHead(p, tcfg, _IN_DIMS, torch.float32)
    params = jax.tree_util.tree_map(np.asarray, jhead.init(jax.random.key(1), *args)["params"])
    ref = jhead.apply({"params": params}, *args)
    if kind == "dpt":  # the bare DPTHead sits at `dpt` in the head's tree
        _load_head_part(head, {"dpt": params}, "dpt.")
    else:
        _load_head_part(head, params, "")
    th = [torch.from_numpy(t) for t in hooks]
    with torch.no_grad():
        out = head(th, grid) if kind != "catmlpdpt" else head(th, grid, th[0], th[-1])
    if kind == "dpt":
        assert out.shape == (2, 16 * grid[0], 16 * grid[1], 4)  # 16× the token grid
        _close(out.numpy(), np.asarray(ref), OUT_RTOL, "dpt map")
        return
    keys = ("pts3d", "conf", "desc", "desc_conf") if kind == "catmlpdpt" else ("pts3d", "conf")
    assert sorted(out) == sorted(keys)
    for k in keys:
        _close(out[k].numpy(), np.asarray(ref[k]), OUT_RTOL, k)
    if kind == "catmlpdpt":
        with torch.no_grad():
            short = head(th, grid, th[0], th[-1], with_desc=False)
        assert sorted(short) == ["conf", "pts3d"]
        torch.testing.assert_close(short["pts3d"], out["pts3d"], rtol=0, atol=0)


def test_dpt_hook_indices_match_jax():
    for depth in (1, 2, 8, 12):
        assert heads.dpt_hook_indices(depth) == jheads.dpt_hook_indices(depth)


@pytest.mark.parametrize("head_type", ["catmlpdpt", "dpt"])
def test_from_jax_dpt_trees_match_export_and_load_strict(head_type):
    """The port's converter gives export_state_dict's keys and values for a
    tiny catmlpdpt / dpt tree (convT kernels flipped), and the state dict
    loads into the port strictly."""
    jcfg, tcfg = _configs(TINY_TRUNK, dict(TINY_HEAD, head_type=head_type))
    params = _params(jcfg)
    ref = export_state_dict(params, jcfg)
    sd = torch_state(params)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    AsymmetricCroCo3DStereo(tcfg).load_state_dict(sd, strict=True)


def test_model_forward_with_descriptors_matches_jax():
    """The full forward still computes desc/desc_conf (only the generator
    skips them): TINY catmlpdpt, two views, f32."""
    jcfg, tcfg = _configs(TINY_TRUNK, TINY_HEAD)
    params = _params(jcfg, seed=2)
    rgb1, rgb2 = (_rng(s).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for s in (4, 5))
    ref1, ref2 = JaxModel(jcfg).apply({"params": params}, jnp.asarray(rgb1), jnp.asarray(rgb2))
    model = AsymmetricCroCo3DStereo(tcfg)
    model.load_state_dict(torch_state(params), strict=True)
    with torch.no_grad():
        out1, out2 = model(torch.from_numpy(rgb1), torch.from_numpy(rgb2))
    assert sorted(out1) == sorted(ref1) and sorted(out2) == sorted(ref2)
    for ref, out in ((ref1, out1), (ref2, out2)):
        for k in ref:
            _close(out[k].numpy(), np.asarray(ref[k]), OUT_RTOL, k)


def test_nanmedian_midpoint_matches_numpy():
    """Even counts average the two middle values (torch.nanmedian would take
    the lower one); odd counts take the middle; nothing valid gives NaN."""
    rng = _rng(6)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    x[0, :4] = np.nan  # 6 valid: even
    x[1, :3] = np.nan  # 7 valid: odd
    x[3, :] = np.nan   # none valid
    out = nanmedian_midpoint(torch.from_numpy(x)).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        ref = np.nanmedian(x, axis=-1)
    np.testing.assert_allclose(out[:3], ref[:3], rtol=1e-6)
    assert np.isnan(out[3])
    assert out[0] != np.sort(x[0, 4:])[2]  # not the lower middle value


def _pointmaps(b, h, w, seed):
    rng = _rng(seed)
    pm = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    pm[..., 2] = rng.uniform(0.5, 3.0, (b, h, w)).astype(np.float32)
    return pm


def test_intrinsics_match_jax_even_valid_count():
    """Median focal fit with an even count of valid pixels (the two middle
    values are averaged): the same f32 arithmetic, 1e-6 relative."""
    pm = _pointmaps(3, 8, 10, seed=7)
    pm[0, :2, :, 2] = -1.0   # 60 valid
    pm[1, :, :3, 2] = 0.0    # 56 valid
    pm[2, 0, :5, 2] = -2.0   # 75 valid: odd
    ref = np.asarray(jax.vmap(jintr.estimate_camera_intrinsics_jit)(
        jnp.asarray(pm), jnp.asarray(pm[..., 2])))
    out = estimate_camera_intrinsics(torch.from_numpy(pm), torch.from_numpy(pm[..., 2]))
    assert out.shape == (3, 3, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


def test_relative_pose_matches_jax():
    """Weighted Umeyama over the valid points (both Z > 0, all finite), the
    Kabsch sign fix, and the identity for fewer than 10 valid points: f32
    SVDs of two libraries, 1e-4."""
    rng = _rng(8)
    pm1 = _pointmaps(3, 6, 7, seed=9)
    a = rng.standard_normal((3, 3))
    rot = np.linalg.qr(a)[0] * np.sign(np.linalg.det(np.linalg.qr(a)[0]))
    pm2 = (pm1 @ rot.T.astype(np.float32) + np.float32([0.1, -0.2, 1.5])
           + 0.01 * rng.standard_normal(pm1.shape).astype(np.float32)).astype(np.float32)
    pm1[0, 0, :3, 0] = np.nan       # invalid points, zeroed before the products
    pm2[1, 2, :4, 2] = -1.0
    pm1[2, :, :, 2] = -1.0          # view 1 of pair 2: fewer than 10 valid
    pm1[2, 0, :9, 2] = 1.0
    ref = np.asarray(jax.vmap(jume.extract_relative_pose_jit)(jnp.asarray(pm1),
                                                              jnp.asarray(pm2)))
    out = extract_relative_pose(torch.from_numpy(pm1), torch.from_numpy(pm2)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out[2], np.eye(4, dtype=np.float32))
    assert not np.allclose(out[0], np.eye(4))


def test_umeyama_alignment_host_api_matches_jax():
    rng = _rng(10)
    x = rng.standard_normal((3, 50))
    y = 1.7 * (np.linalg.qr(rng.standard_normal((3, 3)))[0] @ x) + 0.3
    for with_scale in (False, True):
        r, t, c = umeyama_alignment(x, y, with_scale)
        jr, jt, jc = jume.umeyama_alignment(x, y, with_scale)
        np.testing.assert_allclose(r, jr, atol=1e-4)
        np.testing.assert_allclose(t, jt, atol=1e-4)
        assert abs(c - jc) < 1e-4
    with pytest.raises(GeometryException):
        umeyama_alignment(x, y[:, :10])
    with pytest.raises(GeometryException):
        umeyama_alignment(np.zeros((3, 20)), np.zeros((3, 20)))


def _rotation(rng):
    q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    return q * np.sign(np.linalg.det(q))


def _covariances(kind, rng):
    """[n, 3, 3] float32 covariances of one kind for the Kabsch solve."""
    if kind == "random":
        return rng.standard_normal((64, 3, 3))
    if kind == "reflection":  # det C < 0
        sv = np.array([(3.0, 2.0, -1.0), (1.0, 0.5, -0.25), (4.0, 1.0, -0.999)])
        return np.stack([_rotation(rng) @ np.diag(sv[i % 3]) @ _rotation(rng).T
                         for i in range(24)])
    if kind == "planar":  # weighted covariances of point sets in a plane: rank 2
        out = []
        for _ in range(16):
            x = rng.standard_normal((3, 200))
            x[2] = 0.3 * x[0] - 0.7 * x[1] + 1.5
            y = 1.3 * _rotation(rng) @ x + rng.standard_normal((3, 1))
            w = rng.uniform(0.0, 1.0, 200)
            w /= w.sum()
            xc, yc = x - x @ w[:, None], y - y @ w[:, None]
            out.append((yc * w) @ xc.T)
        return np.stack(out)
    if kind == "repeated":  # equal singular values where R stays unique
        sv = [(2.0, 2.0, 1.0), (3.0, 1.0, 1.0), (1.0, 1.0, 1.0), (2.0, 2.0, -1.0),
              (5.0, 5.0, 5.0)]
        return np.stack([_rotation(rng) @ np.diag(sv[i % 5]) @ _rotation(rng).T
                         for i in range(20)])
    if kind == "rank1_zero":  # small whole numbers: exactly rank 1 in float32
        a, b = rng.integers(1, 5, (2, 12, 3)) * rng.choice([-1, 1], (2, 12, 3))
        return np.concatenate([a[:, :, None] * b[:, None, :], np.zeros((4, 3, 3))])
    assert kind == "scales"
    return np.stack([rng.standard_normal((3, 3)) * 10.0 ** k for k in np.linspace(-3, 3, 25)])


def _kabsch_f64(c):
    """numpy float64 SVD Kabsch of one covariance: (R, signed singular
    values, rank_ok by float32's eps)."""
    u, d, vt = np.linalg.svd(c.astype(np.float64))
    s = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    return (u @ np.diag([1.0, 1.0, s]) @ vt, d * [1.0, 1.0, s],
            (d > np.finfo(np.float32).eps).sum() >= 2)


@pytest.mark.parametrize("kind", ["random", "reflection", "planar", "repeated",
                                  "rank1_zero", "scales"])
def test_kabsch_plain_matches_float64_svd(kind):
    """The 3×3 solve of the pose (kernels/umeyama3x3.py, the CUDA kernel's
    sweeps in PyTorch) against numpy's float64 SVD with the Kabsch sign fix:
    R within 1e-5, the signed singular values within 1e-5 of the largest,
    rank_ok equal. Of rank 1 and zero covariances only rank_ok (false) is
    compared, R being any rotation there: it must be a finite one."""
    cov = _covariances(kind, _rng(11)).astype(np.float32)
    r, sig, rank_ok = (t.numpy() for t in kabsch3x3_plain(torch.from_numpy(cov)))
    assert r.dtype == sig.dtype == np.float32 and rank_ok.dtype == np.bool_
    assert np.isfinite(r).all() and np.isfinite(sig).all()
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)
    assert (sig[:, :2] >= 0).all()
    assert (np.diff(np.abs(sig), axis=1) <= 1e-6 * np.abs(sig[:, :1])).all()  # descending
    for i, c in enumerate(cov):
        ref_r, ref_sig, ref_ok = _kabsch_f64(c)
        assert rank_ok[i] == ref_ok, i
        if kind == "rank1_zero":
            assert not ref_ok
            continue
        np.testing.assert_allclose(r[i], ref_r, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sig[i], ref_sig, rtol=0, atol=1e-5 * np.abs(ref_sig).max())


def test_kabsch_launch_runs_on_its_tensors_device(monkeypatch):
    """The 3×3 solve's launch calls its library once, inside one
    torch.cuda.device block of its output's device, and counts one launch.
    A stand-in library and a recorder for torch.cuda.device, on CPU tensors;
    the wrapper itself takes the plain sweeps on the CPU and counts none."""
    events = []
    record_device_blocks(monkeypatch, events)
    monkeypatch.setattr(umeyama3x3, "_lib", lambda: StandInLibrary(events))
    cov = torch.zeros((8, 3, 3))
    r = torch.empty_like(cov)
    before = kabsch3x3.launches
    umeyama3x3._launch(cov, r, torch.empty((8, 3)), torch.empty((8,), dtype=torch.bool))
    assert events == [("enter", r.device), ("call", "t3d_umeyama3x3"), ("exit", r.device)]
    assert kabsch3x3.launches == before + 1
    kabsch3x3(cov)
    assert kabsch3x3.launches == before + 1


def test_kabsch_plain_mirrors_the_kernel_constants():
    """The plain sweeps use the kernel's number of sweeps and its least
    share of b2 left off u1 (kSweeps, kLeft in csrc/umeyama3x3.cu), so the
    CPU path is the card's arithmetic."""
    src = (Path(umeyama3x3.__file__).parent / "csrc" / "umeyama3x3.cu").read_text()
    sweeps = re.search(r"constexpr int kSweeps = (\d+);", src)
    left = re.search(r"constexpr double kLeft = ([0-9.eE+-]+);", src)
    assert sweeps and left
    assert umeyama3x3.SWEEPS == int(sweeps.group(1))
    assert umeyama3x3.LEFT == float(left.group(1))


def test_pose_needs_no_library_svd(monkeypatch):
    """umeyama_core solves without torch.linalg.svd or torch.linalg.det
    (torch's CUDA SVD waits for the device): with both made to raise, the
    pose still comes out, and equals the one before."""
    pm1 = _pointmaps(2, 6, 7, seed=12)
    pm2 = (pm1 @ _rotation(_rng(13)).T.astype(np.float32) + np.float32([0.1, 0.2, 4.0]))
    want = extract_relative_pose(torch.from_numpy(pm1), torch.from_numpy(pm2))
    assert not torch.allclose(want, torch.eye(4))

    def refuse(*args, **kwargs):
        raise AssertionError("a library SVD or determinant was called")

    monkeypatch.setattr(torch.linalg, "svd", refuse)
    monkeypatch.setattr(torch.linalg, "det", refuse)
    got = extract_relative_pose(torch.from_numpy(pm1), torch.from_numpy(pm2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_load_thermal_calibration_json(tmp_path):
    p = tmp_path / "t_calib.json"
    p.write_text(json.dumps({"intrinsic": [400.0, 410.0, 320.0, 240.0],
                             "rotation": np.eye(3).tolist(), "translation": [0.1, 0, 0]}))
    k, r, t = load_thermal_calibration(str(p))
    np.testing.assert_array_equal(k, [[400, 0, 320], [0, 410, 240], [0, 0, 1]])
    np.testing.assert_array_equal(r, np.eye(3))
    np.testing.assert_array_equal(t, [0.1, 0, 0])
    with pytest.raises(ValueError):
        load_thermal_calibration(str(tmp_path / "calib.txt"))
    gen = PseudoGTGenerator(DustrModelConfig(**TINY_TRUNK, head=HeadConfig(**TINY_HEAD)),
                            calib_file=str(p), device="cpu")
    np.testing.assert_array_equal(gen.calib_k, k)


def _both_generators(trunk, head, seed, port_impl="auto"):
    jcfg, tcfg = _configs(trunk, head)
    params = _params(jcfg, seed)
    jgen = JaxGenerator(jcfg, params=params, batch_size=2)
    tgen = PseudoGTGenerator(dataclasses.replace(tcfg, attention_impl=port_impl),
                             state_dict=torch_state(params), batch_size=2, device="cpu")
    return jgen, tgen


def _assert_pseudo_gt_close(out, ref):
    assert sorted(out) == sorted(OUTPUT_DIRS) == sorted(ref)
    for k in OUTPUT_DIRS:
        assert out[k].dtype == np.float32, k
        _close(out[k], np.asarray(ref[k]), OUT_RTOL, k)


@pytest.mark.parametrize("port_impl", ["auto", "pallas"])
def test_generator_tiny_matches_jax(port_impl):
    """All eight outputs of run_pairs at TINY_MASTR_KW in f32 against the JAX
    generator on the same pairs. The port runs 'auto' (fused K2/K3 plain
    versions) or 'pallas' (RoPE on the heads, then K4's plain version);
    the JAX side runs its CPU route (XLA attention) either way."""
    jgen, tgen = _both_generators(TINY_TRUNK, TINY_HEAD, seed=0, port_impl=port_impl)
    rgb1, rgb2 = (_rng(s).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for s in (11, 12))
    ref = jgen.run_pairs(rgb1, rgb2)
    out = tgen.run_pairs(rgb1, rgb2)
    _assert_pseudo_gt_close(out, ref)
    assert out["intrinsics"].shape == (2, 3, 3) and out["poses"].shape == (2, 4, 4)


def test_generator_production_width_matches_jax():
    """ViT-L / base-decoder widths with the real catmlpdpt head dims, one
    encoder block and a 2-block decoder, at 64×64, f32."""
    jgen, tgen = _both_generators(PROD_TRUNK, dict(head_type="catmlpdpt"), seed=1)
    rgb1, rgb2 = (_rng(s).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32) for s in (13, 14))
    _assert_pseudo_gt_close(tgen.run_pairs(rgb1, rgb2), jgen.run_pairs(rgb1, rgb2))


def test_generator_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DustrModelConfig(**TINY_TRUNK, head=HeadConfig(**TINY_HEAD))
    with pytest.raises(RuntimeError, match="CUDA"):
        PseudoGTGenerator(cfg)


@pytest.mark.parametrize("kw", [{"mesh": "over_processes"}])
def test_generator_jax_only_options_raise(kw):
    """Data-parallel generation takes a single-controller mesh
    (tests/test_torch_mesh.py); a mesh over processes is refused."""
    from tests.test_torch_engine import _mesh_over_processes

    cfg = DustrModelConfig(**TINY_TRUNK, head=HeadConfig(**TINY_HEAD))
    with pytest.raises(ValueError, match="single-controller"):
        PseudoGTGenerator(cfg, device="cpu", mesh=_mesh_over_processes())


@pytest.mark.parametrize("kw", [{"quantize_int8": True}, {"int8_only": ("fc1",)}])
def test_generator_int8_options(kw):
    """quantize_int8 (once refused here) quantizes the trunk and serves
    finite outputs; an int8_* option without it changes nothing, as in the
    JAX generator."""
    cfg = DustrModelConfig(**TINY_TRUNK, head=HeadConfig(**TINY_HEAD))
    gen = PseudoGTGenerator(cfg, device="cpu", seed=4, **kw)
    ref = PseudoGTGenerator(cfg, device="cpu", seed=4)
    rgb = _rng(16).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    rgb2 = np.ascontiguousarray(rgb[:, ::-1])
    out, want = gen.run_pairs(rgb, rgb2), ref.run_pairs(rgb, rgb2)
    int8 = [t for t in gen.model.state_dict().values() if t.dtype == torch.int8]
    assert bool(int8) == bool(kw.get("quantize_int8"))
    for k in want:
        assert np.isfinite(out[k]).all(), k
        if not int8:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def test_generator_split_programs_same_numerics():
    """split_programs only splits XLA's compile in the JAX package; the port
    accepts it and computes the same outputs."""
    cfg = DustrModelConfig(**TINY_TRUNK, head=HeadConfig(**TINY_HEAD))
    a = PseudoGTGenerator(cfg, device="cpu", seed=3)
    b = PseudoGTGenerator(cfg, device="cpu", seed=3, split_programs=True)
    rgb = _rng(15).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)
    oa, ob = a.run_pairs(rgb, rgb[:, ::-1].copy()), b.run_pairs(rgb, rgb[:, ::-1].copy())
    for k in OUTPUT_DIRS:
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
