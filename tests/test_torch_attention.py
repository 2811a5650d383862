"""K4/K5/K6 (softmax attention on roped q/k) and K2/K3 at S=1024: the plain
PyTorch versions of the port against the JAX Pallas kernels they replace, in
interpret mode on the CPU, and the port's flash_attention / attention_bshd
routes; the key-tile recipe of the tiled kernels, and the K2/K3 kernel
route. The CUDA kernels are held against these plain versions on the card
by chip_smoke.py."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import StandInLibrary, record_device_blocks
from thermal3d.models.rope import make_grid_positions as jax_grid
from thermal3d.models.rope import rope_tables as jax_rope_tables

# the modules (each kernels package re-exports its flash_attention function)
jfa = importlib.import_module("thermal3d.kernels.flash_attention")
tfa = importlib.import_module("thermal3d_torch.kernels.flash_attention")

# f32 against the plain softmax reference (division before PV, one-shot):
# the same products, other summation orders and one division moved
REF_ATOL = 1e-5
# against interpret mode: the JAX suite's own bound for the Pallas attention
# kernels on the CPU (tests/test_flash_attention.py: interpret mode models
# the MXU's operand precision)
INTERPRET_ATOL = 5e-3
# the fused RoPE kernels in interpret mode, as tests/test_torch_kernels.py
FUSED_ATOL = 1e-4


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


@pytest.mark.parametrize("n,sq,sk,d", [
    (3, 196, 196, 64),   # the serving S, D: neither a multiple of 128 in S
    (2, 100, 100, 32),
    (2, 100, 300, 16),   # Sq != Sk
    (2, 256, 64, 32),
])
def test_k4_plain_matches_pallas_interpret(n, sq, sk, d):
    q, k, v = _qkv((n, sq, d), (n, sk, d), seed=sq + sk)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    interp = np.asarray(jfa._flash_attention_fwd_pallas(jq, jk, jv, scale=scale, interpret=True))
    ref = np.asarray(jfa._attention_reference(jq, jk, jv, scale))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = tfa.attention_plain(*t, scale).numpy()
    assert out.shape == (n, sq, d)
    np.testing.assert_allclose(out, ref, rtol=0, atol=REF_ATOL)
    np.testing.assert_allclose(out, interp, rtol=0, atol=INTERPRET_ATOL)
    # the K4 wrapper takes the plain version for CPU tensors and counts nothing
    before = tfa.flash_attention_pallas.launches
    np.testing.assert_array_equal(tfa.flash_attention_pallas(*t, scale).numpy(), out)
    assert tfa.flash_attention_pallas.launches == before


@pytest.mark.parametrize("impl,wrapper", [
    ("pallas_grouped2", "flash_attention_grouped"),
    ("pallas_grouped", "flash_attention_grouped"),
    ("pallas_multihead", "flash_attention_multihead"),
    ("pallas", "flash_attention_pallas"),
])
@pytest.mark.parametrize("s", [100, 196])
def test_k5_k6_plain_match_pallas_interpret(impl, wrapper, s):
    """flash_attention on [B,H,S,D] per impl name: the plain version against
    the JAX kernel of that name in interpret mode, and against the reference."""
    b, h, d = 2, 4, 16
    q, k, v = _qkv((b, h, s, d), (b, h, s, d), seed=s)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    interp = np.asarray(jfa.flash_attention(jq, jk, jv, impl=impl, interpret=True))
    ref = np.asarray(jfa.flash_attention(jq, jk, jv, impl="xla"))
    fn = getattr(tfa, wrapper)
    before = fn.launches
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), impl=impl).numpy()
    assert fn.launches == before
    np.testing.assert_allclose(out, ref, rtol=0, atol=REF_ATOL)
    np.testing.assert_allclose(out, interp, rtol=0, atol=INTERPRET_ATOL)


@pytest.mark.parametrize("impl", ["pallas", "pallas_grouped4", "pallas_multihead", "torch"])
def test_attention_bshd_matches_jax(impl):
    """[B,S,H,D] in and out, q/k as a view of one packed projection (the
    layer's layout): the JAX attention_bshd (its f32 XLA path) gives the
    same function; the output is contiguous."""
    b, s, h, d = 2, 24, 3, 16
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)
    c = h * d
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, s, h, d) for i in range(3))
    ref = np.asarray(jfa.attention_bshd(*(jnp.asarray(a) for a in (q, k, v)), impl="xla"))
    t = torch.from_numpy(qkv)
    tq, tk, tv = (t[..., i * c:(i + 1) * c].reshape(b, s, h, d) for i in range(3))
    out = tfa.attention_bshd(tq, tk, tv, impl=impl)
    assert out.shape == (b, s, h, d) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=REF_ATOL)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas_grouped0", "pallas_fused4", "flash"])
def test_flash_attention_rejects_unknown_impl(impl):
    x = torch.zeros((1, 1, 4, 4))
    with pytest.raises(ValueError, match="attention impl"):
        tfa.flash_attention(x, x, x, impl=impl)


def _rope_inputs(b, hg, wg, nh, d, n_tensors, seed):
    rng = np.random.default_rng(seed)
    s, c = hg * wg, nh * d
    cos, sin = (np.array(t) for t in jax_rope_tables(jax_grid(hg, wg), d, 100.0))
    xs = [rng.standard_normal((b, s, c * (3 if n_tensors == 1 else 1))).astype(np.float32)
          for _ in range(n_tensors)]
    return xs, cos, sin


def test_k2_plain_matches_pallas_interpret_s1024():
    """MASt3R-512's S=1024 (a 32×32 grid) at a narrow width: the plain K2
    against the fused Pallas kernel in interpret mode."""
    (qkv,), cos, sin = _rope_inputs(1, 32, 32, 2, 16, 1, seed=1)
    scale = 1.0 / math.sqrt(16)
    ref = np.asarray(jfa.fused_rope_attention(jnp.asarray(qkv), jnp.asarray(cos),
                                              jnp.asarray(sin), 2, scale, 4, True))
    t = [torch.from_numpy(a) for a in (qkv, cos, sin)]
    out = tfa.fused_rope_attention_plain(*t, 2, scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_array_equal(tfa.fused_rope_attention(*t, 2, scale).numpy(), out)


def test_k3_plain_matches_pallas_interpret_s1024():
    (q, k, v), cos, sin = _rope_inputs(1, 32, 32, 2, 16, 3, seed=2)
    scale = 1.0 / math.sqrt(16)
    ref = np.asarray(jfa.fused_rope_cross_attention(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), 2, scale, 4, True))
    t = [torch.from_numpy(a) for a in (q, k, v, cos, sin)]
    out = tfa.rope_attention_plain(*t, 2, scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_array_equal(tfa.fused_rope_cross_attention(*t, 2, scale).numpy(), out)


def _online_softmax_recipe(q, k, v, scale, tile, mask="every", exp2=False):
    """The key-tile kernels' arithmetic (csrc/attention_common.cuh, and the
    tensor-core csrc/key_tile_attention.cuh) restated in PyTorch: K/V padded
    with zero rows to whole tiles, score columns past the sequence masked
    to -inf (on every tile, or with mask="last" only on a ragged last tile,
    as the K4-K6 kernel does); per tile, p = exp(s - running max) rounded to
    the storage type before PV; the f32 sum and accumulator rescaled when
    the max moves; the division after PV. With exp2, the K4-K6 kernel's
    fold (csrc/attention_tc.cu): the running max m of the raw scores s,
    p = 2^(s*c - m*c) with c = scale*log2(e) and s*c - m*c in one rounding
    (a float64 product and difference rounded once, as an FMA), alpha =
    2^((m_old - m_new)*c)."""
    dt = q.dtype
    sk = k.shape[-2]
    pad = -sk % tile
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for j0 in range(0, sk + pad, tile):
        s = qf @ kf[..., j0:j0 + tile, :].transpose(-1, -2)
        if not exp2:
            s = s * scale
        if mask == "every" or j0 + tile > sk:
            s = s.masked_fill(torch.arange(j0, j0 + tile) >= sk, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if exp2:
            alpha = torch.exp2((m - m_new) * c)
            e = torch.exp2((s.double() * c.double() - (m_new * c).double()).float())
        else:
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + e.to(dt).to(torch.float32) @ vf[..., j0:j0 + tile, :]
        m = m_new
    return (acc / l).to(dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(196, 196), (196, 1024), (1024, 196), (1024, 1024)])
def test_key_tile_recipe_masked_on_the_last_tile_only(sq, sk, dtype):
    """Masking only the ragged last key tile (the K4-K6 kernel's template
    flag) changes no bit of the 64-key online softmax: a full tile has no
    column past Sk to mask."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv((1, 2, sq, 64), (1, 2, sk, 64), seed=sq + 5 * sk))
    every = _online_softmax_recipe(q, k, v, 0.125, tile=64)
    assert torch.equal(_online_softmax_recipe(q, k, v, 0.125, tile=64, mask="last"), every)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("tile,seq,head_dim", [
    pytest.param(128, 1024, 64, id="128-1024"),  # 128-key tiles at MASt3R-512's S
    pytest.param(64, 1024, 64, id="64-1024"),    # the tensor-core kernel's 64-key tiles
    pytest.param(64, 196, 64, id="64-196"),      # ... at the serving S: the last tile holds 4 keys
    # the tensor-core kernels' other head dims, against the JAX kernel in
    # interpret mode at small S
    pytest.param(64, 196, 16, id="64-196-d16"),
    pytest.param(64, 196, 32, id="64-196-d32"),
    pytest.param(64, 100, 128, id="64-100-d128"),
    # the packed route: zero-padded to widths 32, 128 and (unpadded) 256
    pytest.param(64, 196, 24, id="64-196-d24"),
    pytest.param(64, 100, 80, id="64-100-d80"),
    pytest.param(64, 100, 256, id="64-100-d256"),
])
def test_key_tile_recipe_within_kernel_limits(dtype, limit, tile, seq, head_dim):
    """The online softmax rounds p against a running max, so in bf16 it is
    not bit-equal to the one-shot plain version; with each kernel's key
    tile, at S=1024 and at a ragged S=196, it stays within the limits
    chip_smoke.py holds the tiled kernels to (2e-5 f32: summation order;
    2^-6 bf16: an output ulp plus a flipped rounding of p). At the other
    head dims (one head, S <= 196) it is held to the same limits against
    the JAX K4 it replaces, in interpret mode on the same rounded inputs, as
    well as against the plain version; at a head dim the packed route serves
    (24, 80, 256) the recipe runs as that route does, on q, k and v
    zero-padded to padded_width(head_dim), the output's first head_dim
    columns kept."""
    heads = 2 if head_dim == 64 else 1
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv((2, heads, seq, head_dim), (2, heads, seq, head_dim), 9))
    scale = 1.0 / math.sqrt(head_dim)
    lanes = tfa.padded_width(head_dim) - head_dim

    def padded(t):
        return torch.nn.functional.pad(t, (0, lanes))

    out = _online_softmax_recipe(padded(q), padded(k), padded(v), scale, tile=tile)
    out = out[..., :head_dim]
    ref = tfa.attention_plain(q, k, v, scale)
    err = (out.to(torch.float32) - ref.to(torch.float32)).abs().max().item()
    assert err <= limit, err
    if head_dim != 64:
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jref = _jax_softmax_attention(
            "pallas", *(jnp.asarray(t.to(torch.float32).numpy()).astype(jdt) for t in (q, k, v)),
            scale)
        jerr = np.abs(out.to(torch.float32).numpy() - np.asarray(jref.astype(jnp.float32))).max()
        assert jerr <= limit, jerr


@pytest.mark.parametrize("dtype,seq,head_dim,want", [
    (torch.bfloat16, 196, 64, tfa.TENSOR_CORE),   # serving
    (torch.bfloat16, 1024, 64, tfa.TENSOR_CORE),  # pseudo-GT
    (torch.bfloat16, 4096, 64, tfa.TENSOR_CORE),  # any S
    (torch.float32, 196, 64, tfa.TF32X3),         # float32: 3xTF32 on tensor cores
    (torch.float32, 1024, 64, tfa.TF32X3),
    (torch.bfloat16, 196, 32, tfa.TENSOR_CORE),   # a 512-wide decoder of 16 heads
    (torch.bfloat16, 1024, 32, tfa.TENSOR_CORE),
    (torch.float32, 196, 32, tfa.TF32X3),
    (torch.float32, 1024, 32, tfa.TF32X3),
    (torch.bfloat16, 196, 16, tfa.TENSOR_CORE),   # the tensor cores' other head dims
    (torch.bfloat16, 1024, 128, tfa.TENSOR_CORE),
    (torch.float32, 196, 16, tfa.TF32X3),
    (torch.float32, 1024, 128, tfa.TF32X3),
    (torch.bfloat16, 196, 24, tfa.TENSOR_CORE),   # any other head_dim: the packed route
    (torch.bfloat16, 1024, 160, tfa.TENSOR_CORE),
    (torch.float32, 196, 24, tfa.TF32X3),
    (torch.float32, 1024, 160, tfa.TF32X3),
])
def test_rope_attention_route(dtype, seq, head_dim, want):
    """The K2/K3 kernel family by shape, decided without the library: bf16
    on tensor cores and float32 3xTF32 on tensor cores, at every S and every
    head dim (outside 16, 32, 64, 128 through the packed route)."""
    assert tfa.attention_route(dtype, head_dim) == want


@pytest.mark.parametrize("pointers,row_stride_bytes", [
    ((0x1000, 0x1008, 0x2000), 6144),  # a base pointer 8 bytes off
    ((0x1000, 0x1010, 0x2000), 6152),  # a row stride of 3076 bf16
])
def test_tensor_core_alignment_check_raises(pointers, row_stride_bytes):
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.check_alignment("fused_rope_attention", pointers, row_stride_bytes)
    tfa.check_alignment("fused_rope_attention", (0x1000, 0x1010, 0x2000), 6144)


def test_cpu_bf16_k2_k3_do_not_count_tensor_core_launches():
    """On CPU tensors K2/K3 run the plain version even where the route is
    the tensor-core kernel, and no kernel count moves."""
    (q, k, v), cos, sin = _rope_inputs(1, 14, 14, 2, 64, 3, seed=4)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    tc = [torch.from_numpy(a) for a in (cos, sin)]
    counts = (tfa.rope_attention_tc.launches, tfa.fused_rope_cross_attention.launches)
    out = tfa.fused_rope_cross_attention(*t, *tc, 2, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 196, 128)
    assert torch.equal(out, tfa.rope_attention_plain(*t, *tc, 2, 0.125))
    assert (tfa.rope_attention_tc.launches, tfa.fused_rope_cross_attention.launches) == counts


def _jax_softmax_attention(impl, q, k, v, scale):
    """The JAX K4/K5/K6 kernels in interpret mode on [B, H, S, D] arrays."""
    if impl == "pallas":  # K4 works on [BH, S, D]
        b, h, sq, d = q.shape
        out = jfa._flash_attention_fwd_pallas(
            q.reshape(b * h, sq, d), k.reshape(b * h, -1, d), v.reshape(b * h, -1, d),
            scale=scale, interpret=True)
        return out.reshape(b, h, sq, d)
    return jfa.flash_attention(q, k, v, scale=scale, impl=impl, interpret=True)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("sq,sk", [
    (196, 1024),  # Sq != Sk, both ragged against the 64-key tile and 128-row block
    (1024, 196),
    (196, 196),   # the serving S
])
@pytest.mark.parametrize("impl", ["pallas", "pallas_grouped4", "pallas_multihead"])
def test_key_tile_recipe_matches_k4_k5_k6_interpret(impl, sq, sk, dtype, limit):
    """The tensor-core K4-K6 kernel's arithmetic (the 64-key online softmax
    with the exp2 fold, masked on the last tile only, csrc/attention_tc.cu)
    against the JAX kernels it replaces, in interpret mode, on the same
    rounded inputs in the same dtype: within the limits chip_smoke.py holds
    the kernel to (2e-5 f32: summation order; 2^-6 bf16: an output ulp plus
    a flipped rounding of p)."""
    q, k, v = _qkv((1, 2, sq, 64), (1, 2, sk, 64), seed=sq + 3 * sk)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_softmax_attention(impl, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), 0.125)
    out = _online_softmax_recipe(*t, 0.125, tile=64, mask="last", exp2=True)
    assert out.shape == (1, 2, sq, 64)
    err = np.abs(out.to(torch.float32).numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= limit, err


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, tfa.TENSOR_CORE),  # every 'pallas*' call of DUSt3R / MASt3R
    (torch.float32, 64, tfa.TF32X3),        # float32: 3xTF32 on tensor cores
    (torch.bfloat16, 32, tfa.TENSOR_CORE),  # the tensor cores' other head dims
    (torch.bfloat16, 128, tfa.TENSOR_CORE),
    (torch.float32, 16, tfa.TF32X3),
    (torch.float32, 32, tfa.TF32X3),
    (torch.float16, 64, None),              # no family (the wrappers refuse it)
    (torch.bfloat16, 16, tfa.TENSOR_CORE),
    (torch.float32, 128, tfa.TF32X3),
    (torch.bfloat16, 24, tfa.TENSOR_CORE),  # any other head_dim: the packed route
    (torch.bfloat16, 160, tfa.TENSOR_CORE),
    (torch.float32, 24, tfa.TF32X3),
    (torch.float32, 160, tfa.TF32X3),
])
def test_attention_route(dtype, head_dim, want):
    """The K4/K5/K6 kernel family by shape, decided without the library."""
    assert tfa.attention_route(dtype, head_dim) == want


@pytest.mark.parametrize("head_dim", range(4, 257, 4))
def test_every_accepted_head_dim_has_one_route(head_dim):
    """Every head dim the wrappers accept (a multiple of 4 up to 256) has a
    family in both dtypes, the same for K2/K3 and K4-K6: the tensor cores
    in bf16, 3xTF32 on the tensor cores in float32; float16 has none. The
    direct entries serve exactly DIRECT_HEAD_DIMS (16, 32, 64, 128;
    csrc/attention_tc.cuh's serves_head_dim), the packed ones the rest."""
    assert tfa.DIRECT_HEAD_DIMS == (16, 32, 64, 128)
    assert tfa.attention_route(torch.bfloat16, head_dim) == tfa.TENSOR_CORE
    assert tfa.attention_route(torch.float32, head_dim) == tfa.TF32X3
    assert tfa.attention_route(torch.float16, head_dim) is None


def _built_widths_in_source():
    """kBuiltWidths as csrc/attention_tc.cuh defines it."""
    import re
    from pathlib import Path

    src = (Path(tfa.__file__).parent / "csrc" / "attention_tc.cuh").read_text()
    found = re.search(r"constexpr int kBuiltWidths\[\] = \{([0-9, ]+)\};", src)
    return tuple(int(w) for w in found.group(1).split(","))


@pytest.mark.parametrize("head_dim", range(4, 257, 4))
def test_padded_width_mirrors_the_library(head_dim):
    """padded_width, the mirror of csrc/attention_tc.cuh's padded_width
    (which chip_smoke.py holds against both libraries' own query at every
    head dim): the smallest of the widths the source builds (kBuiltWidths,
    read from it) at least as wide; a direct head dim and 256 run at their
    own width; no lane of the padding reaches past 256."""
    widths = _built_widths_in_source()
    assert widths == tfa.BUILT_WIDTHS
    dp = tfa.padded_width(head_dim)
    assert dp == min(w for w in widths if w >= head_dim)
    assert head_dim <= dp <= 256 and dp in widths
    assert (dp == head_dim) == (head_dim in tfa.DIRECT_HEAD_DIMS + (256,))
    assert [tfa.padded_width(d) for d in (0, 2, 6, 258, 260, -4)] == [0] * 6


def _strided_operands(sq=8, sk=8):
    """bf16 [B=2, H=2, S, 64] q/k/v/out with 16-byte aligned strides, as
    attention_bshd hands them over: views of [B, S, H, D] buffers."""
    def bshd(s):
        return torch.zeros((2, s, 2, 64), dtype=torch.bfloat16).transpose(1, 2)
    return bshd(sq), bshd(sk), bshd(sk), bshd(sq)


def _misaligned(t, axis):
    """t with the stride of `axis` (0 batch, 1 head, 2 row) one element
    longer: the same shape, read from a larger buffer."""
    strides = list(t.stride())
    strides[axis] += 1
    size = 1 + sum((n - 1) * st for n, st in zip(t.shape, strides))
    return torch.zeros(size, dtype=t.dtype).as_strided(t.shape, strides)


@pytest.mark.parametrize("operand", range(4))  # q, k, v, out
@pytest.mark.parametrize("what", ["pointer", "batch", "head", "row"])
def test_tensor_core_attention_alignment_check_raises(operand, what):
    """The tensor-core K4-K6 wrapper raises ValueError (before it needs the
    library) on a base pointer or any batch/head/row stride that is not a
    multiple of 16 bytes; it never falls back to the CUDA-core kernel."""
    ops = list(_strided_operands())
    if what == "pointer":
        ops[operand] = torch.zeros(ops[operand].numel() + 1,
                                   dtype=torch.bfloat16)[1:].view(ops[operand].shape)
    else:
        ops[operand] = _misaligned(ops[operand], ["batch", "head", "row"].index(what))
    before = tfa.softmax_attention_tc.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.softmax_attention_tc(*ops, 0.125, stream=0)
    assert tfa.softmax_attention_tc.launches == before


def test_tensor_core_attention_launch_arguments(monkeypatch):
    """What the tensor-core K4-K6 launcher hands the library, checked with
    a stand-in for it: the (batch, head, row) strides of q, k, v, out in
    elements, 0 for an axis of size 1 (never stepped along, so never
    checked: here q's batch and row axes have odd strides), Sq and Sk apart,
    and one count per launch."""
    calls = []

    class Lib:
        @staticmethod
        def t3d_softmax_attention_tc(*args):
            calls.append(args)
            return 0

    record_device_blocks(monkeypatch, [])
    monkeypatch.setattr(tfa, "_attention_tc_lib", lambda: Lib)
    q = torch.zeros(2 * 64 + 7, dtype=torch.bfloat16).as_strided((1, 2, 1, 64), (3, 64, 5, 1))
    _, k, v, _ = _strided_operands(sk=40)
    out = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)
    before = tfa.softmax_attention_tc.launches
    tfa.softmax_attention_tc(q, k[:1], v[:1], out, 0.125, stream=0)
    assert tfa.softmax_attention_tc.launches == before + 1
    (args,) = calls
    assert list(args[4]) == [0, 64, 0, 0, 64, 128, 0, 64, 128, 0, 64, 0]
    assert args[5:11] == (1, 2, 1, 40, 64, 0.125)


def test_softmax_attention_tc_with_another_library(monkeypatch):
    """softmax_attention_tc(..., lib=L) (another build, as chip_smoke.py
    --compare-k4k6 passes it) calls L's entry once, inside one
    torch.cuda.device block of the output's device, with the arguments the
    default library gets, and moves the count once."""
    events, args = [], {}

    class Recording:
        def __init__(self, name):
            self.name = name

        def t3d_softmax_attention_tc(self, *a):
            events.append(("call", self.name))
            args[self.name] = a
            return 0

    record_device_blocks(monkeypatch, events)
    monkeypatch.setattr(tfa, "_attention_tc_lib", lambda: Recording("default"))
    q, k, v, out = _strided_operands(sq=12, sk=40)
    before = tfa.softmax_attention_tc.launches
    tfa.softmax_attention_tc(q, k, v, out, 0.125, stream=0, lib=Recording("other"))
    assert events == [("enter", out.device), ("call", "other"), ("exit", out.device)]
    assert tfa.softmax_attention_tc.launches == before + 1
    tfa.softmax_attention_tc(q, k, v, out, 0.125, stream=0)
    assert tfa.softmax_attention_tc.launches == before + 2
    other, default = args["other"], args["default"]
    assert other[:4] == default[:4] and list(other[4]) == list(default[4])
    assert other[5:] == default[5:]


def _map_stride_operands(case):
    """q, k, v, out of a tc_map_strides case."""
    def bshd(b, h, s):  # a [B,S,H,D] buffer read as [B,H,S,D] (attention_bshd)
        return torch.zeros((b, s, h, 64), dtype=torch.bfloat16).transpose(1, 2)

    if case == "bshd":
        return bshd(2, 2, 12), bshd(2, 2, 40), bshd(2, 2, 40), bshd(2, 2, 12)
    if case == "bhsd":
        q, k = (torch.zeros((2, 3, s, 64), dtype=torch.bfloat16) for s in (12, 40))
        return q, k, k.clone(), q.clone()
    if case == "size_one":
        return bshd(1, 1, 1), bshd(1, 1, 40), bshd(1, 1, 40), bshd(1, 1, 1)
    # test_tensor_core_attention_launch_arguments' operands: q's size-1
    # batch and row axes have odd strides
    q = torch.zeros(2 * 64 + 7, dtype=torch.bfloat16).as_strided((1, 2, 1, 64), (3, 64, 5, 1))
    return q, bshd(1, 2, 40), bshd(1, 2, 40), torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16)


@pytest.mark.parametrize("case,want", [
    # [B,S,H,D] views: rows H*128 bytes apart, heads 128, items S*H*128
    ("bshd", [3072, 128, 256, 10240, 128, 256, 10240, 128, 256, 3072, 128, 256]),
    # contiguous [B,H,S,D]
    ("bhsd", [4608, 1536, 128, 15360, 5120, 128, 15360, 5120, 128, 4608, 1536, 128]),
    # one item, one head, one query row: each size-1 axis takes one row's bytes
    ("size_one", [128] * 12),
    ("odd_size_one", [128, 128, 128, 128, 128, 256, 128, 128, 256, 128, 128, 128]),
])
def test_tensor_core_map_strides(case, want):
    """The byte strides of the K4-K6 kernel's four tensor maps
    (tc_map_strides, the mirror of csrc/attention_tc.cu's
    t3d_softmax_attention_tc_map_strides) from the element strides
    softmax_attention_tc passes: 2 bytes an element, and
    size_one_stride_bytes(64) for an axis of size 1, whose stride the wrapper
    sends as 0 whatever the tensor's own."""
    q, k, v, out = _map_stride_operands(case)
    strides = [t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in range(3)]
    b, h, sq, _ = q.shape
    got = tfa.tc_map_strides(strides, b, h, sq, k.shape[2])
    assert got == want
    assert all(x % 16 == 0 and x > 0 for x in got)
    assert tfa.size_one_stride_bytes(64) == 128


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("case", ["bshd", "size_one"])
def test_tensor_core_map_strides_at_head_dims(case, head_dim):
    """tc_map_strides at each head dim the kernel serves: [B,S,H,D] views
    (rows H*D*2 bytes apart, heads D*2, items S*H*D*2) and size-1 axes, which
    take one row's bytes (size_one_stride_bytes: 2*D), each a multiple of 16
    bytes as a tensor map needs."""
    def bshd(bb, hh, ss):
        return torch.zeros((bb, ss, hh, head_dim), dtype=torch.bfloat16).transpose(1, 2)

    if case == "bshd":
        q, k, v, out = bshd(2, 3, 12), bshd(2, 3, 40), bshd(2, 3, 40), bshd(2, 3, 12)
        row, head = 3 * head_dim * 2, head_dim * 2
        want = [12 * row, head, row, 40 * row, head, row, 40 * row, head, row,
                12 * row, head, row]
    else:
        q, k, v, out = bshd(1, 1, 1), bshd(1, 1, 40), bshd(1, 1, 40), bshd(1, 1, 1)
        one = 2 * head_dim
        want = [one, one, one, one, one, head_dim * 2, one, one, head_dim * 2, one, one, one]
    strides = [t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in range(3)]
    got = tfa.tc_map_strides(strides, q.shape[0], q.shape[1], q.shape[2], k.shape[2], head_dim)
    assert got == want
    assert tfa.size_one_stride_bytes(head_dim) == 2 * head_dim
    assert all(x % 16 == 0 and x > 0 for x in got)


def _launch_k2k3(dtype, width=128, heads=2):
    x = torch.zeros((1, 4, 3 * width), dtype=dtype)
    out = torch.empty((1, 4, width), dtype=dtype)
    cos, sin = torch.zeros(4, width // heads), torch.zeros(4, width // heads)
    base, es = x.data_ptr(), x.element_size()
    tfa._launch(x, base, base + width * es, base + 2 * width * es, 3 * width, cos, sin, out,
                heads, 0.125, "K2")
    return out


def _launch_rope_attention_tc():
    x = torch.zeros((1, 4, 384), dtype=torch.bfloat16)
    out = torch.empty((1, 4, 128), dtype=torch.bfloat16)
    cos = sin = torch.zeros(4, 64)
    tfa.rope_attention_tc(x.data_ptr(), x.data_ptr() + 256, x.data_ptr() + 512, 384, cos, sin,
                          out, 2, 0.125, stream=0)
    return out


def _launch_k4k6(dtype, d=64):
    q, k, v = (torch.zeros((1, 2, 4, d), dtype=dtype) for _ in range(3))
    return tfa._attend("K4", q, k, v, 0.125)


def _launch_softmax_attention_tc():
    q, k, v = (torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16) for _ in range(3))
    out = torch.empty_like(q)
    tfa.softmax_attention_tc(q, k, v, out, 0.125, stream=0)
    return out


# launch function → (the library loader it calls, the entry it launches,
# the call on CPU tensors)
LAUNCHES = {
    "k2k3_packed_d24": ("_packed_lib", "t3d_attention_tc_packed",
                        lambda: _launch_k2k3(torch.bfloat16, width=96, heads=4)),
    "k2k3_3xtf32_packed_d20": ("_packed_lib", "t3d_attention_3xtf32_packed",
                               lambda: _launch_k2k3(torch.float32, width=60, heads=3)),
    "k2k3_3xtf32_d32": ("_3xtf32_lib", "t3d_rope_attention_3xtf32",
                        lambda: _launch_k2k3(torch.float32, heads=4)),
    "k2k3_tensor_core_d32": ("_tc_lib", "t3d_rope_attention_tc",
                             lambda: _launch_k2k3(torch.bfloat16, heads=4)),
    "k2k3_3xtf32": ("_3xtf32_lib", "t3d_rope_attention_3xtf32",
                    lambda: _launch_k2k3(torch.float32)),
    "k2k3_tensor_core": ("_tc_lib", "t3d_rope_attention_tc",
                         lambda: _launch_k2k3(torch.bfloat16)),
    "rope_attention_tc": ("_tc_lib", "t3d_rope_attention_tc", _launch_rope_attention_tc),
    "k4k6_packed_d24": ("_packed_lib", "t3d_attention_tc_packed",
                        lambda: _launch_k4k6(torch.bfloat16, d=24)),
    "k4k6_tensor_core_d32": ("_attention_tc_lib", "t3d_softmax_attention_tc",
                             lambda: _launch_k4k6(torch.bfloat16, d=32)),
    "k4k6_3xtf32_d128": ("_3xtf32_lib", "t3d_softmax_attention_3xtf32",
                         lambda: _launch_k4k6(torch.float32, d=128)),
    "k4k6_3xtf32": ("_3xtf32_lib", "t3d_softmax_attention_3xtf32",
                    lambda: _launch_k4k6(torch.float32)),
    "k4k6_tensor_core": ("_attention_tc_lib", "t3d_softmax_attention_tc",
                         lambda: _launch_k4k6(torch.bfloat16)),
    "softmax_attention_tc": ("_attention_tc_lib", "t3d_softmax_attention_tc",
                             _launch_softmax_attention_tc),
}


@pytest.mark.parametrize("case", list(LAUNCHES))
def test_attention_launches_run_on_their_tensors_device(monkeypatch, case):
    """Each K2-K6 launch function (`_launch`, `rope_attention_tc`, `_attend`,
    `softmax_attention_tc`, and through them the 3xTF32 launchers) calls
    its library once, inside one
    torch.cuda.device block of its output's device (so a call on cuda:1
    runs there whichever card is current), never before or after it. Stand-in
    libraries and a recorder for torch.cuda.device, on CPU tensors."""
    loader, entry, launch = LAUNCHES[case]
    events = []
    record_device_blocks(monkeypatch, events)
    lib = StandInLibrary(events)
    monkeypatch.setattr(tfa, loader, lambda *name: lib)
    out = launch()
    assert events == [("enter", out.device), ("call", entry), ("exit", out.device)]


@pytest.mark.parametrize("impl", ["pallas", "pallas_grouped4", "pallas_multihead"])
def test_cpu_bf16_k4_k6_do_not_count_tensor_core_launches(impl):
    """On CPU tensors K4-K6 run the plain version even where the route is
    the tensor-core kernel, and no kernel count moves."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 2, 196, 64), (1, 2, 100, 64), seed=6))
    counters = (tfa.softmax_attention_tc, tfa.flash_attention_pallas,
                tfa.flash_attention_grouped, tfa.flash_attention_multihead)
    counts = [c.launches for c in counters]
    out = tfa.flash_attention(q, k, v, impl=impl)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 196, 64)
    assert torch.equal(out, tfa.attention_plain(q, k, v, 0.125))
    assert [c.launches for c in counters] == counts


# ---------------------------------------------------------------------------
# the tensor-core K2/K3 kernel's two schedules (csrc/rope_attention_tc.cu)
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("batch,heads,seq,want", [
    # the serving and training shapes: B*H items fill the card whole
    (32, 16, 196, (tfa.ONE_PASS, 1)), (32, 12, 196, (tfa.ONE_PASS, 1)),
    (8, 16, 196, (tfa.ONE_PASS, 2)),     # a training step's encoder: 128 heads
    (4, 12, 196, (tfa.ONE_PASS, 4)),     # its decoder: 48 heads
    # tensor-parallel ranks: 12-64 heads, a part a 64-row tile
    (8, 8, 196, (tfa.ONE_PASS, 4)), (4, 6, 196, (tfa.ONE_PASS, 4)),
    (8, 4, 196, (tfa.ONE_PASS, 4)), (4, 3, 196, (tfa.ONE_PASS, 4)),
    (1, 1, 1, (tfa.ONE_PASS, 1)), (32, 16, 1, (tfa.ONE_PASS, 1)),
    (1, 16, 64, (tfa.ONE_PASS, 1)), (4, 16, 64, (tfa.ONE_PASS, 1)),
    (32, 16, 256, (tfa.ONE_PASS, 1)), (2, 16, 256, (tfa.ONE_PASS, 4)),
    (4, 12, 256, (tfa.ONE_PASS, 4)), (8, 12, 256, (tfa.ONE_PASS, 2)),
    # past 256 keys: the 64-key online softmax (the pseudo-GT's S=1024)
    (32, 16, 257, (tfa.KEY_TILE, 1)), (8, 16, 1024, (tfa.KEY_TILE, 1)),
    (4, 12, 1024, (tfa.KEY_TILE, 1)), (1, 1, 1024, (tfa.KEY_TILE, 1)),
])
def test_tensor_core_schedule(batch, heads, seq, want):
    """The schedule and the query-row split as a pure function of (B, H, S,
    SM count): one pass up to 256 keys, where each head's rows are cut into
    the fewest parts (1, 2 tiles, 1 tile) that give the card's 132 SMs an
    item each; the key-tile kernel above."""
    assert tfa.tc_schedule(batch, heads, seq, H100_SMS) == want
    kind, parts = want
    if kind == tfa.ONE_PASS:
        row_tiles = -(-seq // 64)
        assert 1 <= parts <= row_tiles and (parts == 1 or batch * heads * parts >= H100_SMS
                                            or parts == row_tiles)


@pytest.mark.parametrize("head_dim", [16, 32, 128])
@pytest.mark.parametrize("batch,heads,seq", [(32, 16, 196), (1, 1, 1), (8, 8, 1024)])
def test_tensor_core_schedule_at_other_head_dims(batch, heads, seq, head_dim):
    """At head_dims 16, 32 and 128 the tensor-core K2/K3 kernel takes the
    RoPE prologue and the key tiles at every S (the one-pass schedule is
    head_dim 64's), as csrc/rope_attention_tc.cu's schedule query answers;
    head_dim 64 keeps its schedule."""
    assert tfa.tc_schedule(batch, heads, seq, H100_SMS, head_dim) == (tfa.KEY_TILE, 1)
    assert tfa.tc_schedule(batch, heads, seq, H100_SMS, 64) == tfa.tc_schedule(
        batch, heads, seq, H100_SMS)


@pytest.mark.parametrize("sms", [1, 66, 132, 264, 100000])
@pytest.mark.parametrize("seq", [1, 64, 196, 256])
def test_tensor_core_schedule_fills_the_card(seq, sms):
    """Whatever the card, the one-pass split is 1, two tiles or one tile a
    part, and no coarser than that would leave an SM without an item."""
    row_tiles = -(-seq // 64)
    for batch, heads in ((32, 16), (8, 8), (4, 3), (1, 1)):
        kind, parts = tfa.tc_schedule(batch, heads, seq, sms)
        assert kind == tfa.ONE_PASS and parts in (1, -(-row_tiles // 2), row_tiles)
        assert all(batch * heads * coarser < sms
                   for coarser in (1, -(-row_tiles // 2)) if coarser < parts)


class _RecordingTcLibrary:
    """A stand-in tensor-core K2/K3 library that records the entry's
    arguments, with the scratch query of csrc/rope_attention_tc.cu."""

    def __init__(self, events):
        self.events = events
        self.args = []

    def t3d_rope_attention_tc_scratch_bytes(self, batch, seq, heads, head_dim):
        return StandInLibrary(self.events).t3d_rope_attention_tc_scratch_bytes(
            batch, seq, heads, head_dim)

    def t3d_rope_attention_tc(self, *args):
        self.events.append(("call", "t3d_rope_attention_tc"))
        self.args.append(args)
        return 0


@pytest.mark.parametrize("seq,scratch", [
    (196, False),   # one pass: no scratch
    (256, False),
    (257, True),    # key tiles: the roped-K scratch
    (1024, True),
])
def test_rope_attention_tc_scratch(monkeypatch, seq, scratch):
    """rope_attention_tc allocates the roped scratch, a bf16 [B, H, S, 64]
    of K and one of Q after it, only where the library asks for it, and
    calls the same C entry once, inside one torch.cuda.device block of the
    output's device, with a null scratch pointer otherwise."""
    events, sizes = [], []
    record_device_blocks(monkeypatch, events)
    empty = torch.empty

    def recording_empty(*shape, **kw):
        if kw.get("dtype") == torch.bfloat16 and len(shape) == 1:
            sizes.append(shape[0])
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    lib = _RecordingTcLibrary(events)
    b, heads = 2, 3
    x = empty((b, seq, 3 * 64 * heads), dtype=torch.bfloat16)
    out = empty((b, seq, 64 * heads), dtype=torch.bfloat16)
    cos = sin = empty((seq, 64))
    before = tfa.rope_attention_tc.launches
    tfa.rope_attention_tc(x.data_ptr(), x.data_ptr() + 384, x.data_ptr() + 768, 3 * 64 * heads,
                          cos, sin, out, heads, 0.125, stream=0, lib=lib)
    assert events == [("enter", out.device), ("call", "t3d_rope_attention_tc"),
                      ("exit", out.device)]
    assert tfa.rope_attention_tc.launches == before + 1
    (args,) = lib.args
    assert args[8:12] == (b, seq, heads, 64)
    assert (args[6] != 0) == scratch
    assert sizes == ([2 * b * heads * seq * 64] if scratch else [])


@pytest.mark.parametrize("seq,head_dim,key_tile", [
    (196, 64, False),   # one pass: a serving call
    (256, 64, False),
    (257, 64, True),    # key tiles at head_dim 64: the ping-pong schedule
    (1024, 64, True),
    (196, 32, True),    # key tiles at every S at the other head dims
    (1024, 128, True),
])
def test_rope_attention_tc_counts_key_tile_calls(monkeypatch, seq, head_dim, key_tile):
    """rope_attention_tc counts every call in `launches` and a call that
    takes the key-tile schedule (tc_schedule's KEY_TILE) also in
    `key_tile_launches`: 0 for a serving-shaped call, 1 for each key-tile
    call. Through the stand-in library."""
    events = []
    record_device_blocks(monkeypatch, events)
    lib = _RecordingTcLibrary(events)
    b, heads = 2, 3
    c = head_dim * heads
    x = torch.empty((b, seq, 3 * c), dtype=torch.bfloat16)
    out = torch.empty((b, seq, c), dtype=torch.bfloat16)
    cos = sin = torch.empty((seq, head_dim))
    before = (tfa.rope_attention_tc.launches, tfa.rope_attention_tc.key_tile_launches)
    for _ in range(2):
        tfa.rope_attention_tc(x.data_ptr(), x.data_ptr() + 2 * c, x.data_ptr() + 4 * c, 3 * c,
                              cos, sin, out, heads, 0.125, stream=0, lib=lib)
    assert tfa.rope_attention_tc.launches == before[0] + 2
    assert tfa.rope_attention_tc.key_tile_launches == before[1] + 2 * key_tile
    assert (tfa.tc_schedule(b, heads, seq, 132, head_dim)[0] == tfa.KEY_TILE) == key_tile


@pytest.mark.parametrize("head_dim", [16, 32, 128])
@pytest.mark.parametrize("seq", [1, 196, 1024])
def test_rope_attention_tc_scratch_at_other_head_dims(monkeypatch, seq, head_dim):
    """At head_dims 16, 32 and 128 rope_attention_tc allocates the roped-K
    scratch, a bf16 [B, H, S, D], at every S (the key tiles run at every S),
    of the size the library's query gives for the head_dim, and hands the
    library the head_dim."""
    events, sizes = [], []
    record_device_blocks(monkeypatch, events)
    empty = torch.empty

    def recording_empty(*shape, **kw):
        if kw.get("dtype") == torch.bfloat16 and len(shape) == 1:
            sizes.append(shape[0])
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    lib = _RecordingTcLibrary(events)
    b, heads = 2, 3
    c = head_dim * heads
    x = empty((b, seq, 3 * c), dtype=torch.bfloat16)
    out = empty((b, seq, c), dtype=torch.bfloat16)
    cos = sin = empty((seq, head_dim))
    tfa.rope_attention_tc(x.data_ptr(), x.data_ptr() + 2 * c, x.data_ptr() + 4 * c, 3 * c, cos,
                          sin, out, heads, 0.125, stream=0, lib=lib)
    (args,) = lib.args
    assert args[8:12] == (b, seq, heads, head_dim) and args[6] != 0
    assert sizes == [b * heads * seq * head_dim]


class _PackedLibrary(StandInLibrary):
    """A stand-in library that records the arguments of the packed entries
    (csrc/attention_tc.cu, csrc/attention_3xtf32.cu)."""

    def __init__(self, events):
        super().__init__(events)
        self.args = []

    def _packed(self, name, *args):
        self.events.append(("call", name))
        self.args.append(args)
        return 0

    def t3d_attention_tc_packed(self, *args):
        return self._packed("t3d_attention_tc_packed", *args)

    def t3d_attention_3xtf32_packed(self, *args):
        return self._packed("t3d_attention_3xtf32_packed", *args)


@pytest.mark.parametrize("dtype,entry,counter", [
    (torch.bfloat16, "t3d_attention_tc_packed", "rope_attention_tc"),
    (torch.float32, "t3d_attention_3xtf32_packed", "rope_attention_3xtf32"),
])
@pytest.mark.parametrize("heads,head_dim", [(3, 20), (16, 24), (2, 80), (4, 256)])
def test_k2k3_packed_launch_arguments(monkeypatch, dtype, entry, counter, heads, head_dim):
    """K2 at a head dim outside 16, 32, 64, 128 takes its family's packed
    entry once (its family's count moving once), inside one torch.cuda.device
    block of the output's device: q, k, v as the base pointers of the packed
    projection's thirds (any alignment: at bf16 head_dim 20 with 3 heads the
    rows are 360 bytes apart), the (batch, head, row) strides of the [B, S,
    3C] rows and of the [B, S, C] output, the cos/sin tables, a scratch of
    the library's size, Sq = Sk = S and the head_dim."""
    events, sizes = [], []
    record_device_blocks(monkeypatch, events)
    lib = _PackedLibrary(events)
    monkeypatch.setattr(tfa, "_packed_lib", lambda name: lib)
    empty = torch.empty

    def recording_empty(*shape, **kw):
        if kw.get("dtype") == torch.uint8:
            sizes.append(shape[0])
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    b, s, c = 2, 9, heads * head_dim
    qkv = torch.zeros((b, s, 3 * c), dtype=dtype)
    cos, sin = torch.zeros(s, head_dim), torch.zeros(s, head_dim)
    before = getattr(tfa, counter).launches
    out = torch.empty((b, s, c), dtype=dtype)
    es = qkv.element_size()
    tfa._launch(qkv, qkv.data_ptr(), qkv.data_ptr() + c * es, qkv.data_ptr() + 2 * c * es,
                3 * c, cos, sin, out, heads, 0.125, "K2")
    assert getattr(tfa, counter).launches == before + 1
    assert events == [("enter", out.device), ("call", entry), ("exit", out.device)]
    (args,) = lib.args
    assert args[0] == qkv.data_ptr() and args[2] == qkv.data_ptr() + 2 * c * es
    assert list(args[4]) == [s * 3 * c, head_dim, 3 * c] * 3 + [s * c, head_dim, c]
    assert args[5:7] == (cos.data_ptr(), sin.data_ptr())
    assert args[8:13] == (b, heads, s, s, head_dim)
    scratch_query = getattr(StandInLibrary([]), f"{entry}_scratch_bytes")
    assert sizes == [scratch_query(b, heads, s, s, head_dim)]


@pytest.mark.parametrize("dtype,entry,counter", [
    (torch.bfloat16, "t3d_attention_tc_packed", "softmax_attention_tc"),
    (torch.float32, "t3d_attention_3xtf32_packed", "softmax_attention_3xtf32"),
])
@pytest.mark.parametrize("misaligned", [False, True])
def test_k4k6_packed_takes_any_alignment(monkeypatch, dtype, entry, counter, misaligned):
    """K4 at head_dim 20 on [B,S,H,D] views takes its family's packed entry
    with the (batch, head, row) strides of q, k, v and out (0 for an axis of
    size 1), null tables, Sq and Sk apart: also where a view starts one
    element into its buffer and its rows are 3*20 elements apart, which the
    direct entries refuse (16-byte aligned pointers and strides) and the
    packed route reads an element at a time."""
    events = []
    record_device_blocks(monkeypatch, events)
    lib = _PackedLibrary(events)
    monkeypatch.setattr(tfa, "_packed_lib", lambda name: lib)
    d, h = 20, 3

    def view(s):
        buf = torch.zeros(1 + 2 * s * h * d, dtype=dtype)
        start = 1 if misaligned else 0
        return buf[start:start + 2 * s * h * d].view(2, s, h, d).transpose(1, 2)

    q, k, v = view(12), view(40), view(40)
    before = getattr(tfa, counter).launches
    out = tfa._attend("K4", q, k, v, 0.125)
    assert getattr(tfa, counter).launches == before + 1
    assert events == [("enter", out.device), ("call", entry), ("exit", out.device)]
    (args,) = lib.args
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert list(args[4]) == [12 * h * d, d, h * d, 40 * h * d, d, h * d, 40 * h * d, d,
                             h * d, 12 * h * d, d, h * d]
    assert args[5:7] == (0, 0) and args[8:13] == (2, h, 12, 40, d)
    if misaligned:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._attend("K4", *(view(s)[..., :16] for s in (12, 40, 40)), 0.125)


def _one_pass_recipe(q, k, v, scale):
    """The one-pass tensor-core kernel's arithmetic (csrc/rope_attention_tc.cu
    at S <= 256) restated in PyTorch on roped [..., S, D] operands: keys
    padded with zero rows to whole 64-key tiles (the kernel's n64 products),
    every score of a row at once with the columns past S masked to -inf, one
    max a row over the whole padded row, p = exp(s - max) with its f32 sum,
    p rounded to the storage type before PV, the division after PV. The
    padded keys carry p = 0 exactly (against zero V rows), so the sum and PV
    run over the S real keys."""
    dt = q.dtype
    s = k.shape[-2]
    pad = -s % 64
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    scores = (qf @ kf.transpose(-1, -2) * scale).masked_fill(torch.arange(s + pad) >= s,
                                                             -math.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    assert not p[..., s:].any()
    p = p[..., :s]
    return ((p.to(dt).to(torch.float32) @ vf) / p.sum(-1, keepdim=True)).to(dt)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_one_pass_recipe_matches_pallas_interpret(kernel, dtype, limit):
    """At the serving S=196 (a 14×14 grid, D=64): the one-pass recipe on the
    roped q/k against the fused Pallas kernel it replaces, in interpret mode
    on the same inputs rounded to the same dtype, within the limits
    chip_smoke.py holds the kernel to (2e-5 f32: summation order; 2^-6 bf16:
    an output ulp plus a flipped rounding of p); and bit-equal to the plain
    version the card checks the kernel against."""
    nh, d = 2, 64
    xs, cos, sin = _rope_inputs(2, 14, 14, nh, d, 1 if kernel == "K2" else 3, seed=13)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(a).astype(jdt) for a in xs]
    scale = 1.0 / math.sqrt(d)
    tx = [torch.from_numpy(a).to(dtype) for a in xs]
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    if kernel == "K2":
        ref = jfa.fused_rope_attention(jx[0], jnp.asarray(cos), jnp.asarray(sin), nh, scale, 4,
                                       True)
        c = nh * d
        q, k, v = (tx[0][..., i * c:(i + 1) * c] for i in range(3))
    else:
        ref = jfa.fused_rope_cross_attention(*jx, jnp.asarray(cos), jnp.asarray(sin), nh,
                                             scale, 4, True)
        q, k, v = tx
    b, s, c = q.shape

    def heads(t):
        return t.reshape(b, s, nh, d).transpose(1, 2).to(torch.float32)

    def rope(t):
        return (t * tc + tfa.rot_lanes(t) * ts).to(dtype)

    out = _one_pass_recipe(rope(heads(q)), rope(heads(k)), heads(v).to(dtype), scale)
    out = out.transpose(1, 2).reshape(b, s, c)
    err = np.abs(out.to(torch.float32).numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= limit, err
    assert torch.equal(out, tfa.rope_attention_plain(q, k, v, tc, ts, nh, scale))


@pytest.mark.parametrize("head_dim,side", [(16, 14), (32, 14), (64, 17), (128, 10)])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_exp2_key_tile_recipe_matches_k2_k3_interpret(kernel, head_dim, side):
    """bf16 K2/K3 on the key tiles, with K4-K6's exp2 step masked on the last
    tile (csrc/rope_attention_tc.cu): at head_dims 16, 32 and 128 at every S,
    at head_dim 64 past S = 256 (here S = 289: five tiles, the last of 33
    keys), on the roped q/k, against the fused Pallas kernel it replaces in
    interpret mode on the same inputs rounded to bf16, one head at small S:
    within the 2^-6 chip_smoke.py holds the kernel to (an output ulp plus a
    flipped rounding of p)."""
    nh, d = 1, head_dim
    xs, cos, sin = _rope_inputs(2, side, side, nh, d, 1 if kernel == "K2" else 3, seed=d)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in xs]
    scale = 1.0 / math.sqrt(d)
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in xs]
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    if kernel == "K2":
        ref = jfa.fused_rope_attention(jx[0], jnp.asarray(cos), jnp.asarray(sin), nh, scale, 4,
                                       True)
        q, k, v = (tx[0][..., i * d:(i + 1) * d] for i in range(3))
    else:
        ref = jfa.fused_rope_cross_attention(*jx, jnp.asarray(cos), jnp.asarray(sin), nh,
                                             scale, 4, True)
        q, k, v = tx
    b, s, _ = q.shape

    def heads(t):
        return t.reshape(b, s, nh, d).transpose(1, 2).to(torch.float32)

    def rope(t):
        return (t * tc + tfa.rot_lanes(t) * ts).to(torch.bfloat16)

    out = _online_softmax_recipe(rope(heads(q)), rope(heads(k)), heads(v).to(torch.bfloat16),
                                 scale, tile=64, mask="last", exp2=True)
    out = out.transpose(1, 2).reshape(b, s, d)
    err = np.abs(out.to(torch.float32).numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= 2.0 ** -6, err
    plain = tfa.rope_attention_plain(q, k, v, tc, ts, nh, scale)
    assert (out.to(torch.float32) - plain.to(torch.float32)).abs().max().item() <= 2.0 ** -6


# ---------------------------------------------------------------------------
# the 3xTF32 float32 kernels (csrc/attention_3xtf32.cu)
# ---------------------------------------------------------------------------

# the limit chip_smoke.py holds float32 kernels to against the plain version
F32_LIMIT = 2e-5


def test_tf32_round_is_nearest_ties_away():
    """tf32_round (the kernels' cvt.rna.tf32.f32) against a float64
    restatement: 11 significant bits, to nearest, ties away from zero; with
    exact ties of both signs and values that round up into the next binade."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -20, 20, 4096).astype(np.float32)
    tie = np.float32(1.0 + 2.0 ** -11)  # halfway between two tf32 values
    x = np.concatenate([x, [tie, -tie, np.float32(2.0 - 2.0 ** -12), 0.0]]).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    scaled = m * 2.0 ** 11
    want = np.ldexp(np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) / 2.0 ** 11, e)
    got = tfa.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert got[-4] == np.float32(1.0 + 2.0 ** -10) and got[-3] == -got[-4]
    assert got[-2] == 2.0


def _3xtf32_case(kernel, seq, products, d=64):
    """One K2/K3/K4 call at head_dim d (64: two heads; else one) with a batch
    of one: the 3xTF32 emulation with `products` tf32 passes, and the JAX
    kernel in interpret mode, on the same float32 inputs."""
    side = int(math.isqrt(seq))
    nh = 2 if d == 64 else 1
    scale = 1.0 / math.sqrt(d)
    if kernel == "K4":
        q, k, v = _qkv((1, nh, seq, d), (1, nh, seq, d), seed=seq + 7)
        ref = _jax_softmax_attention("pallas", *(jnp.asarray(a) for a in (q, k, v)), scale)
        out = tfa.attention_3xtf32_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                                         products)
        return out, ref
    xs, cos, sin = _rope_inputs(1, side, side, nh, d, 1 if kernel == "K2" else 3, seed=seq)
    jx = [jnp.asarray(a) for a in xs]
    tx = [torch.from_numpy(a) for a in xs]
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    if kernel == "K2":
        ref = jfa.fused_rope_attention(jx[0], jnp.asarray(cos), jnp.asarray(sin), nh, scale, 4,
                                       True)
        c = nh * d
        q, k, v = (tx[0][..., i * c:(i + 1) * c] for i in range(3))
    else:
        ref = jfa.fused_rope_cross_attention(*jx, jnp.asarray(cos), jnp.asarray(sin), nh,
                                             scale, 4, True)
        q, k, v = tx
    out = tfa.rope_attention_3xtf32_plain(q, k, v, tc, ts, nh, scale, products)
    return out, ref


@pytest.mark.parametrize("seq,head_dim", [
    pytest.param(196, 64, id="196"), pytest.param(1024, 64, id="1024"),
    # the 3xTF32 kernels' other head dims, one head at small S
    pytest.param(196, 16, id="196-d16"), pytest.param(144, 32, id="144-d32"),
    pytest.param(100, 128, id="100-d128"),
    # the packed route (widths 32 and 128) and width 256
    pytest.param(196, 24, id="196-d24"), pytest.param(100, 80, id="100-d80"),
    pytest.param(100, 256, id="100-d256"),
])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_3xtf32_arithmetic_matches_pallas_interpret(kernel, seq, head_dim):
    """The float32 kernels' 3xTF32 products (tf32 hi and lo by mantissa
    masking, hi*lo + lo*hi + hi*hi in float32), restated in PyTorch, against
    the JAX kernel they replace in interpret mode, at the serving S=196 and
    the pseudo-GT's S=1024, and at head_dims 16, 32, 128, 24, 80 and 256:
    within the 2e-5 chip_smoke.py holds the kernel to against the float32
    plain version."""
    out, ref = _3xtf32_case(kernel, seq, products=3, d=head_dim)
    err = np.abs(out.numpy() - np.asarray(ref)).max()
    assert err <= F32_LIMIT, err


@pytest.mark.parametrize("kernel,seq", [("K2", 196), ("K4", 1024)])
def test_one_tf32_product_exceeds_the_float32_limit(kernel, seq):
    """Why three products: one tf32 pass (hi*hi alone, 11 significant bits an
    operand) misses the 2e-5 float32 limit on the same inputs that the three
    passes meet."""
    out, ref = _3xtf32_case(kernel, seq, products=1)
    err = np.abs(out.numpy() - np.asarray(ref)).max()
    assert err > F32_LIMIT, err


@pytest.mark.parametrize("impl", ["pallas", "pallas_grouped4", "pallas_multihead", "fused"])
def test_cpu_f32_attention_does_not_count_3xtf32_launches(impl):
    """On CPU tensors float32 K2-K6 run the plain version although their
    route is the 3xTF32 kernel, and no kernel count moves."""
    counters = (tfa.rope_attention_3xtf32, tfa.softmax_attention_3xtf32,
                tfa.fused_rope_attention, tfa.flash_attention_pallas,
                tfa.flash_attention_grouped, tfa.flash_attention_multihead)
    counts = [c.launches for c in counters]
    if impl == "fused":
        (qkv,), cos, sin = _rope_inputs(1, 14, 14, 2, 64, 1, seed=8)
        t = [torch.from_numpy(a) for a in (qkv, cos, sin)]
        out = tfa.fused_rope_attention(*t, 2, 0.125)
        assert torch.equal(out, tfa.fused_rope_attention_plain(*t, 2, 0.125))
    else:
        q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 196, 64), (1, 2, 100, 64), seed=9))
        out = tfa.flash_attention(q, k, v, impl=impl)
        assert torch.equal(out, tfa.attention_plain(q, k, v, 0.125))
    assert out.dtype == torch.float32
    assert [c.launches for c in counters] == counts


def test_3xtf32_launch_arguments(monkeypatch):
    """What the 3xTF32 K4-K6 launcher hands the library, with a stand-in:
    the strides as the bf16 launcher passes them (0 for an axis of size 1),
    a float32 scratch of the library's own size for Sk keys, and one count
    per launch; K2/K3's launcher the same scratch for S."""
    calls, sizes = [], []

    class Lib:
        @staticmethod
        def t3d_attention_3xtf32_scratch_bytes(batch, heads, seq, head_dim):
            sizes.append((batch, heads, seq, head_dim))
            return StandInLibrary([]).t3d_attention_3xtf32_scratch_bytes(batch, heads, seq,
                                                                        head_dim)

        @staticmethod
        def t3d_softmax_attention_3xtf32(*args):
            calls.append(args)
            return 0

        @staticmethod
        def t3d_rope_attention_3xtf32(*args):
            calls.append(args)
            return 0

    record_device_blocks(monkeypatch, [])
    monkeypatch.setattr(tfa, "_3xtf32_lib", lambda: Lib)
    q = torch.zeros((1, 12, 2, 64)).transpose(1, 2)   # [B,S,H,D] views
    k = torch.zeros((1, 40, 2, 64)).transpose(1, 2)
    out = torch.zeros_like(q)
    before = tfa.softmax_attention_3xtf32.launches
    tfa.softmax_attention_3xtf32(q, k, k, out, 0.125, stream=0)
    assert tfa.softmax_attention_3xtf32.launches == before + 1
    (args,) = calls
    assert list(args[4]) == [0, 64, 128, 0, 64, 128, 0, 64, 128, 0, 64, 128]
    assert args[6:12] == (1, 2, 12, 40, 64, 0.125) and sizes == [(1, 2, 40, 64)]
    x = torch.zeros((2, 9, 3 * 128))
    before = tfa.rope_attention_3xtf32.launches
    tfa._launch(x, x.data_ptr(), x.data_ptr() + 512, x.data_ptr() + 1024, 384,
                torch.zeros(9, 64), torch.zeros(9, 64), torch.empty((2, 9, 128)), 2, 0.125, "K2")
    assert tfa.rope_attention_3xtf32.launches == before + 1
    assert calls[1][8:12] == (2, 9, 2, 64) and sizes[1] == (2, 2, 9, 64)


def test_every_csrc_source_is_built():
    """Each CUDA source under kernels/csrc/ is one of the libraries the
    build compiles (_build.SOURCES), and each of those has its source."""
    from thermal3d_torch.kernels import _build

    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.SOURCES)
