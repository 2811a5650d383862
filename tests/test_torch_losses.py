"""Parity of the port's training losses (thermal3d_torch/losses/losses.py)
with the JAX losses (thermal3d/losses/losses.py) on the same seeded numpy
arrays: the port computes a batch with tensor ops, JAX one sample at a time
(vmap); per-sample losses and components within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_np  # noqa: F401  (sets threads, warms exp)
from thermal3d.core.config import LossConfig as JaxLossConfig
from thermal3d.losses import losses as jl
from thermal3d_torch.core.config import LossConfig
from thermal3d_torch.losses import losses as tl

RTOL = 1e-5


def _arrays(seed=0, b=3, h=24, w=20, rgb_thermal=False):
    rng = np.random.default_rng(seed)
    depth = 1.0 + rng.uniform(0, 4, (b, h, w, 1))
    pts = np.concatenate([rng.normal(size=(b, h, w, 2)), depth], -1).astype(np.float32)
    gt = (pts + 0.3 * rng.normal(size=pts.shape)).astype(np.float32)
    pts2 = (pts[:, ::-1] * 1.1).astype(np.float32).copy()
    gt2 = (gt[:, ::-1] + 0.1).astype(np.float32).copy()
    conf = (1.0 + rng.exponential(2.0, (b, h, w))).astype(np.float32)
    conf[0, 0, 0] = 20.0  # above the clamp
    conf2 = (1.0 + rng.exponential(1.0, (b, h, w))).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    t1 = (0.5 * xx + 0.3 * np.sin(8 * yy) + 0.2 * rng.uniform(size=(b, h, w))).astype(np.float32)
    t2 = np.clip(t1 + 0.05 * rng.normal(size=t1.shape), 0, 1).astype(np.float32)
    if rgb_thermal:
        t1, t2 = (np.repeat(t[..., None], 3, -1) for t in (t1, t2))
    return pts, pts2, gt, gt2, conf, conf2, t1, t2


def _jax_per_sample(fn, arrays, **kw):
    def one(*a):
        out = fn(*a, **kw)
        return out if isinstance(out, tuple) else (out, {})

    return jax.vmap(one)(*(jnp.asarray(a) for a in arrays))


def _close(got, want, what):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("with_conf", [True, False])
def test_confidence_weighted_regression_loss(with_conf):
    pts, pts2, gt, gt2, conf, conf2, _, _ = _arrays()
    arrays = (pts, pts2, gt, gt2) + ((conf, conf2) if with_conf else ())
    want, _ = _jax_per_sample(jl.confidence_weighted_regression_loss, arrays, alpha=0.2)
    got = tl.confidence_weighted_regression_loss(*(torch.from_numpy(a) for a in arrays),
                                                 alpha=0.2)
    _close(got, want, "basic loss")


@pytest.mark.parametrize("rgb_thermal", [False, True])
def test_thermal_aware_loss_v1(rgb_thermal):
    arrays = _arrays(1, rgb_thermal=rgb_thermal)
    kw = dict(alpha=0.2, edge_weight=0.5, smoothness_weight=0.3)
    want, want_c = _jax_per_sample(jl.thermal_aware_loss, arrays, **kw)
    got, got_c = tl.thermal_aware_loss(*(torch.from_numpy(a) for a in arrays), **kw)
    _close(got, want, "v1 total")
    assert sorted(got_c) == sorted(want_c)
    for k in want_c:
        _close(got_c[k], want_c[k], f"v1 {k}")
    # the duplicated reference term is kept
    assert torch.equal(got_c["edge_loss"], got_c["smoothness_loss"])


@pytest.mark.parametrize("multi_scale", [True, False])
@pytest.mark.parametrize("rgb_thermal", [False, True])
def test_enhanced_thermal_aware_loss_v2(multi_scale, rgb_thermal):
    arrays = _arrays(2, rgb_thermal=rgb_thermal)
    kw = dict(alpha=0.2, edge_weight=0.5, smoothness_weight=0.3, detail_weight=0.4,
              multi_scale=multi_scale)
    want, want_c = _jax_per_sample(jl.enhanced_thermal_aware_loss, arrays, **kw,
                                   cfg=JaxLossConfig())
    got, got_c = tl.enhanced_thermal_aware_loss(*(torch.from_numpy(a) for a in arrays), **kw,
                                                cfg=LossConfig())
    _close(got, want, "v2 total")
    assert sorted(got_c) == ["basic_loss", "detail_loss", "edge_loss", "smoothness_loss"]
    for k in want_c:
        _close(got_c[k], want_c[k], f"v2 {k}")


def test_v2_odd_sizes_and_scale_three():
    """Odd map sizes (the average pool drops the last row/column) and a
    third scale, through the config."""
    arrays = _arrays(3, b=2, h=23, w=17)
    jcfg, tcfg = JaxLossConfig(scales=(1, 2, 3)), LossConfig(scales=(1, 2, 3))
    want, want_c = _jax_per_sample(jl.enhanced_thermal_aware_loss, arrays, cfg=jcfg)
    got, got_c = tl.enhanced_thermal_aware_loss(*(torch.from_numpy(a) for a in arrays),
                                                cfg=tcfg)
    _close(got, want, "v2 total")
    for k in want_c:
        _close(got_c[k], want_c[k], f"v2 {k}")


def test_v2_without_thermal_is_basic():
    pts, pts2, gt, gt2, conf, conf2, _, _ = _arrays(4)
    got, comps = tl.enhanced_thermal_aware_loss(*(torch.from_numpy(a) for a in
                                                  (pts, pts2, gt, gt2, conf, conf2)))
    _close(got, to_np(comps["basic_loss"]), "no thermal: total = basic")
    assert float(comps["edge_loss"].abs().max()) == 0.0


def test_batched_enhanced_loss():
    arrays = _arrays(5)
    kw = dict(alpha=0.2, edge_weight=0.5, smoothness_weight=0.3, detail_weight=0.3,
              multi_scale=True)
    want, want_c = jl.batched_enhanced_loss(*(jnp.asarray(a) for a in arrays), **kw)
    got, got_c = tl.batched_enhanced_loss(*(torch.from_numpy(a) for a in arrays), **kw)
    _close(got, want, "batched total")
    for k in want_c:
        _close(got_c[k], want_c[k], f"batched {k}")
