"""The plain PyTorch versions of the port's kernels (K1 percentile enhance,
K2/K3 fused RoPE attention) against the JAX Pallas kernels they replace, run
in interpret mode on the CPU. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_common  # noqa: F401  (torch thread count)
from thermal3d.kernels.flash_attention import (fused_rope_attention as jax_fused_rope_attention,
                                               fused_rope_cross_attention as jax_fused_rope_xattn)
from thermal3d.kernels.image_ops import percentile_enhance_pallas
from thermal3d.models.rope import make_grid_positions as jax_grid
from thermal3d.models.rope import rope_tables as jax_rope_tables
from thermal3d_torch.kernels.flash_attention import (fused_rope_attention,
                                                     fused_rope_attention_plain,
                                                     fused_rope_cross_attention,
                                                     rope_attention_plain)
from thermal3d_torch.kernels.image_ops import (GRID, percentile_enhance,
                                               percentile_enhance_plain, percentile_radix_plain,
                                               search_target)


def _frames(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == "flat":
        return np.full(shape, 0.4, np.float32)
    # bimodal: two clusters far apart, the p2/p98 ranks inside each
    x = np.where(rng.uniform(size=shape) < 0.5, rng.normal(0.2, 0.01, shape),
                 rng.normal(0.8, 0.01, shape))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "flat", "bimodal"])
def test_k1_plain_matches_pallas_interpret(kind):
    """Same search on the same grid: bit-identical up to 1 float32 ulp of the
    [0, 1] output (1.2e-7)."""
    x = _frames(kind, (3, 64, 80))
    ref = np.asarray(percentile_enhance_pallas(jnp.asarray(x), interpret=True))
    out = percentile_enhance_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.2e-7)


def test_k1_plain_matches_pallas_interpret_serving_shape():
    """One [2, 224, 224] batch, the serving image size."""
    x = _frames("random", (2, 224, 224), seed=3)
    ref = np.asarray(percentile_enhance_pallas(jnp.asarray(x), interpret=True))
    out = percentile_enhance_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("kind", ["random", "bimodal"])
def test_k1_search_is_kthvalue(kind):
    """The binary search returns the k-th smallest grid value, k =
    ceil(target): the torch.kthvalue formulation (the yardstick chip_smoke
    times) gives the same output exactly."""
    x = torch.from_numpy(_frames(kind, (4, 50, 60), seed=5))
    b, h, w = x.shape
    n = h * w
    q = torch.floor(x.reshape(b, n) * GRID)
    p = [torch.kthvalue(q, math.ceil(search_target(f, n)), dim=1).values / GRID
         for f in (2.0, 98.0)]
    scale = 1.0 / torch.clamp(p[1] - p[0], min=1e-12)
    ref = torch.clamp((x.reshape(b, n) - p[0][:, None]) * scale[:, None], 0, 1)
    torch.testing.assert_close(percentile_enhance_plain(x), ref.reshape(b, h, w),
                               rtol=0, atol=0)


def test_k1_wrapper_uses_plain_version_on_cpu():
    x = torch.from_numpy(_frames("random", (2, 16, 16)))
    before = percentile_enhance.launches
    torch.testing.assert_close(percentile_enhance(x), percentile_enhance_plain(x),
                               rtol=0, atol=0)
    assert percentile_enhance.launches == before  # only kernel launches count


@pytest.mark.parametrize("kind", ["random", "flat", "bimodal"])
@pytest.mark.parametrize("shape", [
    (2, 512, 640),  # a full Freiburg frame, over the one-block kernel's old limit
    (3, 37, 53),    # odd sizes: ragged tiles
    (1, 1, 1),
])
def test_k1_radix_select_equals_search(kind, shape):
    """The CUDA kernel's two-level radix select, restated in PyTorch, gives
    the binary search's order statistics: its output is bit-equal to the
    plain search. Against the Pallas kernel in interpret mode, whose
    clip-rescale XLA's CPU arithmetic rounds differently (up to 3 float32
    ulps on the [2,512,640] bimodal frame, for the plain search as well),
    it is within 2.4e-7, while a percentile one grid step off would move
    every unclipped output by at least 1/65535 (1.5e-5)."""
    x = _frames(kind, shape, seed=sum(shape))
    out = percentile_radix_plain(torch.from_numpy(x))
    assert out.shape == shape and out.dtype == torch.float32
    torch.testing.assert_close(out, percentile_enhance_plain(torch.from_numpy(x)),
                               rtol=0, atol=0)
    ref = np.asarray(percentile_enhance_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2.4e-7)


@pytest.mark.parametrize("lo,hi", [(0.0, 100.0), (50.0, 50.0), (99.99, 1e-3)])
def test_k1_radix_select_equals_search_at_edge_ranks(lo, hi):
    """Ranks at the ends of the grid and equal ranks, on an image with ties:
    the radix select and the search agree bit for bit."""
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 5, (2, 30, 30)) / 4.0).float()
    torch.testing.assert_close(percentile_radix_plain(x, lo, hi),
                               percentile_enhance_plain(x, lo, hi), rtol=0, atol=0)


def _attn_inputs(b, hg, wg, nh, d, n_tensors, seed):
    rng = np.random.default_rng(seed)
    s, c = hg * wg, nh * d
    cos, sin = (np.array(t) for t in jax_rope_tables(jax_grid(hg, wg), d, 100.0))
    xs = [rng.standard_normal((b, s, c * (3 if n_tensors == 1 else 1))).astype(np.float32)
          for _ in range(n_tensors)]
    return xs, cos, sin


# Tolerance: both sides compute the same f32 arithmetic (RoPE from the same
# tables, f32 scores and softmax, division after PV) in different summation
# orders, which alone differs by < 1e-6 on outputs of size ~1. Interpret
# mode runs the Pallas dots through XLA's CPU dot, which has once differed
# by up to 6e-5 on the tiny case (the JAX suite bounds interpret-mode
# attention at 5e-3), hence 1e-4.
ATTN_ATOL = 1e-4


@pytest.mark.parametrize("b,hg,wg,nh,d", [
    (2, 4, 6, 2, 16),     # tiny
    (1, 14, 14, 16, 64),  # encoder at the serving shape: S=196
    (1, 14, 14, 12, 64),  # decoder at the serving shape
])
def test_k2_plain_matches_pallas_interpret(b, hg, wg, nh, d):
    (qkv,), cos, sin = _attn_inputs(b, hg, wg, nh, d, 1, seed=nh)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jax_fused_rope_attention(jnp.asarray(qkv), jnp.asarray(cos),
                                              jnp.asarray(sin), nh, scale, 4, True))
    t = [torch.from_numpy(a) for a in (qkv, cos, sin)]
    out = fused_rope_attention_plain(t[0], t[1], t[2], nh, scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_ATOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(fused_rope_attention(*t, nh, scale).numpy(), out)


@pytest.mark.parametrize("b,hg,wg,nh,d", [
    (2, 4, 6, 2, 16),
    (1, 14, 14, 12, 64),  # decoder cross-attention at the serving shape
])
def test_k3_plain_matches_pallas_interpret(b, hg, wg, nh, d):
    (q, k, v), cos, sin = _attn_inputs(b, hg, wg, nh, d, 3, seed=7)
    scale = 1.0 / math.sqrt(d)
    ref = np.asarray(jax_fused_rope_xattn(*(jnp.asarray(a) for a in (q, k, v, cos, sin)),
                                          nh, scale, 4, True))
    t = [torch.from_numpy(a) for a in (q, k, v, cos, sin)]
    out = rope_attention_plain(*t, nh, scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_array_equal(fused_rope_cross_attention(*t, nh, scale).numpy(), out)


def test_k2_plain_bf16_rounds_like_the_kernel():
    """In bf16 the plain version rounds roped q/k and p to bf16 before their
    products and accumulates in f32 — the same as running the f32 arithmetic
    on those rounded values, which is what the Pallas kernel does with bf16
    inputs. Checked against an f64 restatement of that recipe."""
    (qkv,), cos, sin = _attn_inputs(2, 4, 6, 2, 16, 1, seed=11)
    nh, d = 2, 16
    scale = 1.0 / math.sqrt(d)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    out = fused_rope_attention_plain(x, torch.from_numpy(cos), torch.from_numpy(sin),
                                     nh, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 24, 32)
    xf = x.to(torch.float64).reshape(2, 24, 3, nh, d).permute(2, 0, 3, 1, 4)
    c64, s64 = torch.from_numpy(cos).double(), torch.from_numpy(sin).double()

    def rope(t):
        from thermal3d_torch.kernels.flash_attention import rot_lanes
        return (t * c64 + rot_lanes(t) * s64).to(torch.bfloat16).double()

    sc = rope(xf[0]) @ rope(xf[1]).transpose(-1, -2) * scale
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    ref = (p.to(torch.bfloat16).double() @ xf[2]) / p.sum(-1, keepdim=True)
    ref = ref.transpose(1, 2).reshape(2, 24, 32)
    # one bf16 ulp at |x| <= 2 (the f32-vs-f64 rounding can flip the last bit)
    torch.testing.assert_close(out.double(), ref, rtol=0, atol=2 ** -7)
