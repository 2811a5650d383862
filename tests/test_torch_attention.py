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

import tests.test_torch_common  # noqa: F401  (torch thread count)
from thermal3d.models.rope import make_grid_positions as jax_grid
from thermal3d.models.rope import rope_tables as jax_rope_tables
from thermal3d_torch.kernels import flash_attention as tfa

# the module (thermal3d.kernels re-exports its flash_attention function)
jfa = importlib.import_module("thermal3d.kernels.flash_attention")

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


def _online_softmax_recipe(q, k, v, scale, tile):
    """The key-tile kernels' arithmetic (csrc/attention_common.cuh, and the
    tensor-core csrc/rope_attention_tc.cu) restated in PyTorch: K/V padded
    with zero rows to whole tiles, score columns past the sequence masked
    to -inf; per tile, p = exp(s - running max) rounded to the storage type
    before PV; the f32 sum and accumulator rescaled when the max moves; the
    division after PV."""
    dt = q.dtype
    sk = k.shape[-2]
    pad = -sk % tile
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kf, vf))
    m = torch.full(q.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape)
    for j0 in range(0, sk + pad, tile):
        s = qf @ kf[..., j0:j0 + tile, :].transpose(-1, -2) * scale
        s = s.masked_fill(torch.arange(j0, j0 + tile) >= sk, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        acc = acc * alpha + e.to(dt).to(torch.float32) @ vf[..., j0:j0 + tile, :]
        m = m_new
    return (acc / l).to(dt)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("tile,seq", [
    (128, 1024),  # the CUDA-core key-tile loop at MASt3R-512's S
    (64, 1024),   # the tensor-core kernel's 64-key tiles
    (64, 196),    # ... at the serving S (14×14): the last tile holds 4 keys
])
def test_key_tile_recipe_within_kernel_limits(dtype, limit, tile, seq):
    """The online softmax rounds p against a running max, so in bf16 it is
    not bit-equal to the one-shot plain version; with each kernel's key
    tile, at S=1024 and at a ragged S=196, it stays within the limits
    chip_smoke.py holds the tiled kernels to (2e-5 f32: summation order;
    2^-6 bf16: an output ulp plus a flipped rounding of p)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv((2, 2, seq, 64), (2, 2, seq, 64), 9))
    scale = 1.0 / 8.0
    out = _online_softmax_recipe(q, k, v, scale, tile=tile)
    ref = tfa.attention_plain(q, k, v, scale)
    err = (out.to(torch.float32) - ref.to(torch.float32)).abs().max().item()
    assert err <= limit, err


@pytest.mark.parametrize("dtype,seq,head_dim,want", [
    (torch.bfloat16, 196, 64, tfa.TENSOR_CORE),   # serving
    (torch.bfloat16, 1024, 64, tfa.TENSOR_CORE),  # pseudo-GT
    (torch.bfloat16, 4096, 64, tfa.TENSOR_CORE),  # any S
    (torch.float32, 196, 64, tfa.CUDA_CORE),      # float32: CUDA cores
    (torch.float32, 1024, 64, tfa.CUDA_CORE),
    (torch.bfloat16, 196, 32, tfa.CUDA_CORE),     # another head_dim: CUDA cores
    (torch.bfloat16, 1024, 32, tfa.CUDA_CORE),
])
def test_rope_attention_route(dtype, seq, head_dim, want):
    """The K2/K3 kernel family by shape, decided without the library: bf16
    with head_dim 64 on tensor cores at every S, the rest on CUDA cores."""
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
    """The tensor-core K4-K6 kernel's arithmetic (the 64-key online softmax,
    csrc/attention_tc.cu) against the JAX kernels it replaces, in interpret
    mode, on the same rounded inputs in the same dtype: within the limits
    chip_smoke.py holds the kernel to (2e-5 f32: summation order; 2^-6
    bf16: an output ulp plus a flipped rounding of p)."""
    q, k, v = _qkv((1, 2, sq, 64), (1, 2, sk, 64), seed=sq + 3 * sk)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax_softmax_attention(impl, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), 0.125)
    out = _online_softmax_recipe(*t, 0.125, tile=64)
    assert out.shape == (1, 2, sq, 64)
    err = np.abs(out.to(torch.float32).numpy() - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= limit, err


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, tfa.TENSOR_CORE),  # every 'pallas*' call of DUSt3R / MASt3R
    (torch.float32, 64, tfa.CUDA_CORE),     # float32: CUDA cores
    (torch.bfloat16, 32, tfa.CUDA_CORE),    # another head_dim: CUDA cores
    (torch.bfloat16, 128, tfa.CUDA_CORE),
    (torch.float32, 16, tfa.CUDA_CORE),
])
def test_attention_route(dtype, head_dim, want):
    """The K4/K5/K6 kernel family by shape, decided without the library."""
    assert tfa.attention_route(dtype, head_dim) == want


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
