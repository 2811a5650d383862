"""Attention kernels (counterpart of thermal3d/kernels/flash_attention.py).

K2 + K3, fused 2-D RoPE + attention: `fused_rope_attention` (K2,
self-attention on the packed [B,S,3C] qkv projection) and
`fused_rope_cross_attention` (K3, separate [B,S,C] q/k/v projections sharing
one position grid) return [B,S,C]. `attention_route` picks their CUDA
kernel by shape: bf16 with head_dim 64 runs on the tensor cores
(csrc/rope_attention_tc.cu, counted by `rope_attention_tc.launches`); other
dtypes and head dims run the CUDA-core kernels of csrc/rope_attention.cu.

K4 + K5 + K6, softmax attention on q/k that are already roped:
`flash_attention_pallas` (K4, [N,S,D] or [B,H,S,D]),
`flash_attention_grouped` (K5) and `flash_attention_multihead` (K6, both
[B,H,S,D]) launch one kernel for the three functions the TPU tiled three
ways; each keeps its own entry and launch count. `attention_route` picks
the kernel by shape as for K2/K3: bf16 with head_dim 64 runs on the tensor
cores (csrc/attention_tc.cu, counted by `softmax_attention_tc.launches`),
other dtypes and head dims on the CUDA cores (csrc/attention.cu).
`flash_attention` ([B,H,S,D]) and `attention_bshd` ([B,S,H,D]) pick one of
them by `impl` name, as the JAX functions do.

Every wrapper launches its CUDA kernel for CUDA tensors and runs the plain
PyTorch version of the same arithmetic for CPU tensors. Where autograd needs
a gradient (grad mode on and an input that requires grad), the wrapper runs
through a torch.autograd.Function: its forward is the same kernel launch
(or the plain version on the CPU) and saves what the JAX custom_vjp
residuals hold; its backward restates the JAX backward, which is plain jnp
there (no Pallas kernel), in plain PyTorch: `rope_attention_bwd` for K2/K3
(`_rope_attn_bwd_core`), `attention_bwd` for K4-K6 (`_core_bwd`). The CPU
runs the same Function, so the CPU tests hold the backward the card runs.
Under torch.no_grad the wrappers launch exactly as without autograd.
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import Optional

import torch

from thermal3d_torch.kernels import _build

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel families, by the name attention_route gives them
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"


def rot_lanes(t: torch.Tensor) -> torch.Tensor:
    """RoPE rotation companion over the last axis:
    [-t[d4:2d4], t[:d4], -t[3d4:], t[2d4:3d4]] (matches rope.rope_tables)."""
    d4 = t.shape[-1] // 4
    return torch.cat([-t[..., d4:2 * d4], t[..., :d4],
                      -t[..., 3 * d4:], t[..., 2 * d4:3 * d4]], dim=-1)


def rope_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                         scale: float) -> torch.Tensor:
    """q/k/v: [B, S, C] (views allowed) → [B, S, C], the kernel's arithmetic:
    RoPE in f32, q/k/p rounded to the storage dtype before their products,
    f32 accumulation, f32 softmax, division after PV."""
    b, s, c = q.shape
    d = c // num_heads
    dt = q.dtype

    def heads(t):  # [B, S, C] → [B, H, S, D] in f32
        return t.reshape(b, s, num_heads, d).transpose(1, 2).to(torch.float32)

    def rope(t):
        return (t * cos + rot_lanes(t) * sin).to(dt)

    out = attention_plain(rope(heads(q)), rope(heads(k)), heads(v).to(dt), scale)
    return out.to(dt).transpose(1, 2).reshape(b, s, c)


def fused_rope_attention_plain(qkv, cos, sin, num_heads, scale):
    """Plain version of K2 on the packed [B, S, 3C] projection."""
    c = qkv.shape[-1] // 3
    return rope_attention_plain(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                cos, sin, num_heads, scale)


def fused_rope_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """K2: RoPE + self-attention on the packed [B, S, 3C] qkv projection;
    differentiable in qkv (no gradient for the tables, as in JAX)."""
    if _needs_grad(qkv):
        return _FusedRopeAttention.apply(qkv, cos, sin, num_heads, scale)
    return _fused_rope_attention_fwd(qkv, cos, sin, num_heads, scale)


def _fused_rope_attention_fwd(qkv, cos, sin, num_heads, scale):
    if qkv.device.type == "cpu":
        return fused_rope_attention_plain(qkv, cos, sin, num_heads, scale)
    b, s, three_c = qkv.shape
    c = three_c // 3
    _check("fused_rope_attention", (qkv,), cos, sin, num_heads, c, s)
    out = torch.empty((b, s, c), dtype=qkv.dtype, device=qkv.device)
    es = qkv.element_size()
    base = qkv.data_ptr()
    _launch(qkv, base, base + c * es, base + 2 * c * es, three_c, cos, sin, out,
            num_heads, scale, "fused_rope_attention")
    fused_rope_attention.launches += 1
    return out


fused_rope_attention.launches = 0


def fused_rope_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K3: RoPE + cross-attention on separate [B, S, C] projections. Needs
    Sq == Sk and one shared position grid (DUSt3R's dual decoder).
    Differentiable in q, k and v."""
    if _needs_grad(q, k, v):
        return _FusedRopeCrossAttention.apply(q, k, v, cos, sin, num_heads, scale)
    return _fused_rope_cross_attention_fwd(q, k, v, cos, sin, num_heads, scale)


def _fused_rope_cross_attention_fwd(q, k, v, cos, sin, num_heads, scale):
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("fused_rope_cross_attention needs q, k, v of one shape "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    if q.device.type == "cpu":
        return rope_attention_plain(q, k, v, cos, sin, num_heads, scale)
    b, s, c = q.shape
    _check("fused_rope_cross_attention", (q, k, v), cos, sin, num_heads, c, s)
    out = torch.empty((b, s, c), dtype=q.dtype, device=q.device)
    _launch(q, q.data_ptr(), k.data_ptr(), v.data_ptr(), c, cos, sin, out,
            num_heads, scale, "fused_rope_cross_attention")
    fused_rope_cross_attention.launches += 1
    return out


fused_rope_cross_attention.launches = 0


def smem_bytes(seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the one-shot K2/K3 kernel needs (K/V of one
    head, whole sequence). Needs the built library."""
    fn = _lib().t3d_rope_attention_smem_bytes
    return int(fn(seq, head_dim, torch.tensor([], dtype=dtype).element_size()))


def attention_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel family of an attention call (K2-K6), by dtype and head
    dim: TENSOR_CORE (wgmma: csrc/rope_attention_tc.cu for K2/K3,
    csrc/attention_tc.cu for K4-K6) for bf16 with head_dim 64 at any S,
    which is every call of the configured models (DUSt3R-224, MASt3R-512);
    otherwise CUDA_CORE (csrc/rope_attention.cu, where `_launch` picks
    one-shot or key-tile, and csrc/attention.cu). A dispatch by shape: a
    kernel that fails to build or launch raises."""
    return TENSOR_CORE if dtype == torch.bfloat16 and head_dim == 64 else CUDA_CORE


def check_alignment(what: str, pointers, *stride_bytes: int) -> None:
    """Raise ValueError unless every base pointer and every stride (in
    bytes) is a multiple of 16 (the tensor-core kernels read rows in 16-byte
    vectors and copies)."""
    bad = [hex(p) for p in pointers if p % 16]
    bad_strides = [st for st in stride_bytes if st % 16]
    if bad or bad_strides:
        raise ValueError(f"{what}: the tensor-core kernel needs 16-byte aligned base "
                         f"pointers and strides (misaligned pointers: {bad}, strides in "
                         f"bytes: {bad_strides})")


def _check(what, tensors, cos, sin, num_heads, c, s):
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous, of one dtype, "
                             "on one device")
    if c % num_heads:
        raise ValueError(f"{what}: width {c} not divisible by {num_heads} heads")
    d = c // num_heads
    if d % 4 or d > 256:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 4 and <= 256")
    for t in (cos, sin):
        if (t.shape != (s, d) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: cos/sin must be contiguous float32 [{s}, {d}] "
                             f"on {x.device}")


def _launch(x, q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale, what):
    b, s, c = out.shape
    if b == 0 or s == 0:
        return
    d = c // num_heads
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if attention_route(x.dtype, d) == TENSOR_CORE:
        rope_attention_tc(q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale,
                          stream, what)
        return
    lib = _lib()
    # The switch between the two CUDA-core kernels: the one-shot kernel
    # holds K/V of a head in shared memory; where they do not fit (float32
    # D=64 past S=411, bf16 D=32 past S=865; so MASt3R-512's S=1024) the
    # key-tile loop runs instead.
    one_shot = smem_bytes(s, d, x.dtype) <= SMEM_LIMIT
    fn = lib.t3d_rope_attention if one_shot else lib.t3d_rope_attention_tiled
    rc = fn(_DTYPE_CODE[x.dtype], q_ptr, k_ptr, v_ptr, row_stride, cos.data_ptr(),
            sin.data_ptr(), out.data_ptr(), b, s, num_heads, d, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")


def rope_attention_tc(q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale,
                      stream, what="rope_attention_tc", lib=None):
    """Launch the tensor-core K2/K3 kernel (bf16, head_dim 64) on base
    pointers with a common row stride in elements; out [B, S, C] bf16. The
    library call launches the RoPE prologue of K into a [B, H, S, 64] bf16
    scratch, then the attention kernel, on `stream`. `lib`: another build
    of csrc/rope_attention_tc.cu, loaded by `bind_tc_lib` (this checkout's
    by default). Counts its own calls in `rope_attention_tc.launches`."""
    b, s, c = out.shape
    k_roped = torch.empty((b, num_heads, s, c // num_heads), dtype=out.dtype, device=out.device)
    ptrs = (q_ptr, k_ptr, v_ptr, cos.data_ptr(), sin.data_ptr(), k_roped.data_ptr(),
            out.data_ptr())
    check_alignment(what, ptrs, row_stride * out.element_size())
    lib = lib or _tc_lib()
    rc = lib.t3d_rope_attention_tc(*ptrs[:3], row_stride, *ptrs[3:], b, s, num_heads,
                                   c // num_heads, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    rope_attention_tc.launches += 1


rope_attention_tc.launches = 0


def _tc_lib() -> ctypes.CDLL:
    return bind_tc_lib(_build.library("rope_attention_tc"))


def bind_tc_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a rope_attention_tc library's entry."""
    fn = lib.t3d_rope_attention_tc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = _build.library("rope_attention")
    for fn in (lib.t3d_rope_attention, lib.t3d_rope_attention_tiled):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    sm = lib.t3d_rope_attention_smem_bytes
    sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sm.restype = ctypes.c_ulonglong
    return lib


# --------------------------------------------------------------------------
# K4 / K5 / K6: softmax attention on q/k that are already roped
# --------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q: [..., Sq, D], k/v: [..., Sk, D] → [..., Sq, D] in q's dtype, the
    arithmetic of the Pallas `_attention_kernel`: QK on the storage-type
    values accumulated in f32, times scale; f32 exp and sum; p rounded to
    the storage type before PV; the division after PV."""
    dt = q.dtype
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dt).to(torch.float32), v.to(torch.float32)) / denom
    return out.to(dt)


def flash_attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """K4 (`_flash_attention_fwd_pallas`): q [N, Sq, D], k/v [N, Sk, D], or
    the same with a [B, H] lead (what `flash_attention` hands it, so the
    head split needs no copy). Sq and Sk may differ."""
    return _softmax_attention(flash_attention_pallas, q, k, v, scale)


flash_attention_pallas.launches = 0


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """K5 (`_flash_attention_fwd_grouped`): q [B, H, Sq, D], k/v
    [B, H, Sk, D]. The TPU kernel ran G heads a program; on the card every
    head gets its own blocks, so G shapes nothing here."""
    return _softmax_attention(flash_attention_grouped, q, k, v, scale)


flash_attention_grouped.launches = 0


def flash_attention_multihead(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """K6 (`_flash_attention_fwd_multihead`): q [B, H, Sq, D], k/v
    [B, H, Sk, D]; the TPU kernel ran all heads of a batch item in one
    program."""
    return _softmax_attention(flash_attention_multihead, q, k, v, scale)


flash_attention_multihead.launches = 0


def _softmax_attention(entry, q, k, v, scale):
    """K4/K5/K6 by their entry (whose launch count moves): through the
    autograd Function where a gradient is needed, else straight to the
    kernel (the plain version on the CPU)."""
    if _needs_grad(q, k, v):
        return _SoftmaxAttention.apply(q, k, v, scale, entry)
    return _softmax_attention_fwd(entry, q, k, v, scale)


def _softmax_attention_fwd(entry, q, k, v, scale):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.dim() == 3:
        return _softmax_attention_fwd(entry, q[None], k[None], v[None], scale)[0]
    out = _attend(entry.__name__, q, k, v, scale)
    entry.launches += 1
    return out


# --------------------------------------------------------------------------
# gradients: torch.autograd.Functions whose backwards restate the JAX ones
# --------------------------------------------------------------------------

def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rope_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, scale: float):
    """The VJP of RoPE + attention (JAX `_rope_attn_bwd_core`): q, k, v (the
    projections before RoPE) and the output gradient g [B, S, H, D] →
    (dq, dk, dv) float32 [B, S, H, D]. The roped q and k are recomputed;
    every operand of a product is rounded to the storage dtype (bf16 for bf16
    inputs, else float32) and every product accumulates in float32 (the
    operands are up-cast, so the sums are float32 sums of exact products);
    the probabilities, dP and dS are stored in the storage dtype, the scores,
    the softmax and rowsum(dP∘P) stay float32; then the RoPE transpose,
    Rᵀ = −R."""
    sdtype = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32

    def stored(t):  # rounded to the storage dtype, held in float32 for the products
        return t.to(sdtype).to(torch.float32)

    def bh(t):  # [B, S, H, D] → [B, H, S, D]
        return t.transpose(1, 2)

    qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, g))
    cb, sb = cos[None, :, None, :], sin[None, :, None, :]
    qr = stored(bh(qf * cb + rot_lanes(qf) * sb))
    kr = stored(bh(kf * cb + rot_lanes(kf) * sb))
    gs, vs = stored(bh(gf)), stored(bh(vf))
    scores = torch.matmul(qr, kr.transpose(-1, -2)) * scale
    p = stored(torch.softmax(scores, dim=-1))
    dv = torch.matmul(p.transpose(-1, -2), gs)
    dp = stored(torch.matmul(gs, vs.transpose(-1, -2)))
    rowcorr = (dp * p).sum(dim=-1, keepdim=True)
    ds = stored(p * (dp - rowcorr))
    dqr = bh(torch.matmul(ds, kr) * scale)
    dkr = bh(torch.matmul(ds.transpose(-1, -2), qr) * scale)
    # qr = q cos + R(q) sin  ⇒  dq = dqr cos + Rᵀ(dqr sin), Rᵀ = −R
    dq = dqr * cb - rot_lanes(dqr * sb)
    dk = dkr * cb - rot_lanes(dkr * sb)
    return dq, dk, bh(dv)


class _FusedRopeAttention(torch.autograd.Function):
    """K2 with a gradient; residuals (qkv, cos, sin) as in JAX `_fused_fwd`."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, num_heads, scale):
        ctx.save_for_backward(qkv, cos, sin)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _fused_rope_attention_fwd(qkv, cos, sin, num_heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        qkv, cos, sin = ctx.saved_tensors
        b, s, three_c = qkv.shape
        c = three_c // 3
        h = ctx.num_heads
        grads = rope_attention_bwd(*(qkv[..., i * c:(i + 1) * c].reshape(b, s, h, c // h)
                                     for i in range(3)),
                                   g.reshape(b, s, h, c // h), cos, sin, ctx.scale)
        dqkv = torch.cat([t.reshape(b, s, c) for t in grads], dim=-1).to(qkv.dtype)
        return dqkv, None, None, None, None


class _FusedRopeCrossAttention(torch.autograd.Function):
    """K3 with a gradient; residuals (q, k, v, cos, sin) as in JAX `_xattn_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, num_heads, scale):
        ctx.save_for_backward(q, k, v, cos, sin)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _fused_rope_cross_attention_fwd(q, k, v, cos, sin, num_heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, cos, sin = ctx.saved_tensors
        b, s, c = q.shape
        h = ctx.num_heads
        grads = rope_attention_bwd(*(t.reshape(b, s, h, c // h) for t in (q, k, v, g)),
                                   cos, sin, ctx.scale)
        dq, dk, dv = (t.reshape(b, s, c).to(q.dtype) for t in grads)
        return dq, dk, dv, None, None, None, None


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  scale: float):
    """The VJP of softmax attention (JAX `_core_bwd`): q [..., Sq, D], k/v
    [..., Sk, D] and g [..., Sq, D] → (dq, dk, dv) in the inputs' dtype, the
    attention recomputed and differentiated in float32."""
    qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _SoftmaxAttention(torch.autograd.Function):
    """K4/K5/K6 with a gradient; residuals (q, k, v) as in JAX `_core_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, entry):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _softmax_attention_fwd(entry, q, k, v, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, g, ctx.scale), None, None)


_GROUPED = re.compile(r"pallas_grouped([1-9][0-9]*)?")
_FUSED = re.compile(r"pallas_fused([1-9][0-9]*)?")
ATTENTION_IMPLS = ("pallas", "pallas_grouped", "pallas_groupedN", "pallas_multihead", "torch")


def is_fused_impl(impl: str) -> bool:
    """The model-level names of the fused K2/K3 route: 'auto' and the JAX
    model's explicit 'pallas_fused' / 'pallas_fusedN' (N, the TPU's head
    group, shapes nothing on the card). The JAX 'xla' / 'xla_*' names are
    TPU policy and are not taken."""
    return impl == "auto" or _FUSED.fullmatch(impl) is not None


def check_attention_impl(impl: str) -> None:
    """Raise ValueError for an `impl` that flash_attention does not know."""
    if impl not in ("pallas", "pallas_multihead", "torch") and not _GROUPED.fullmatch(impl):
        raise ValueError(f"attention impl {impl!r} not in {ATTENTION_IMPLS} "
                         "(N a positive head-group size)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, impl: str = "pallas") -> torch.Tensor:
    """Multi-head attention, q [B, H, Sq, D], k/v [B, H, Sk, D] → [B, H, Sq, D].

    impl: 'pallas' (K4), 'pallas_grouped' / 'pallas_groupedN' (K5),
    'pallas_multihead' (K6) or 'torch' (the plain version). The JAX
    function's 'auto' and 'xla' are TPU dispatch policy and are not taken:
    the port's 'auto' attention is the fused K2/K3 of models/layers.py."""
    check_attention_impl(impl)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "torch":
        return attention_plain(q, k, v, scale)
    if impl.startswith("pallas_grouped"):
        return flash_attention_grouped(q, k, v, scale)
    if impl == "pallas_multihead":
        return flash_attention_multihead(q, k, v, scale)
    return flash_attention_pallas(q, k, v, scale)


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: Optional[float] = None, impl: str = "pallas") -> torch.Tensor:
    """Attention in the [B, S, H, D] layout of the projections: q
    [B, Sq, H, D], k/v [B, Sk, H, D] → [B, Sq, H, D], contiguous, so the
    caller's reshape to [B, Sq, H*D] is free. The head axes are swapped as
    views; the kernels read the strides and write their output in q's
    layout, so on the card `.contiguous()` copies nothing."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          scale=scale, impl=impl)
    return out.transpose(1, 2).contiguous()


def _attend(what, q, k, v, scale):
    """Check [B, H, S, D] operands and launch the K4-K6 kernel that
    attention_route names. The output is laid out as q is (so a
    [B, S, H, D] view in gives one out)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: want q [B,H,Sq,D] and k, v [B,H,Sk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(f"{what}: q, k, v must be of one dtype, on one device, "
                             "with a contiguous last axis")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d % 4 or d > 256:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 4 and <= 256")
    if sk == 0:
        raise ValueError(f"{what}: no keys")
    order = sorted(range(4), key=lambda i: q.stride(i), reverse=True)
    out = torch.empty([q.shape[i] for i in order], dtype=q.dtype, device=q.device)
    out = out.permute([order.index(i) for i in range(4)])
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if attention_route(q.dtype, d) == TENSOR_CORE:
        softmax_attention_tc(q, k, v, out, scale, stream, what)
        return out
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    lib = _attention_lib()
    rc = lib.t3d_attention(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), strides, b, h, sq, sk, d, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    return out


def softmax_attention_tc(q, k, v, out, scale, stream, what="softmax_attention_tc"):
    """Launch the tensor-core K4-K6 kernel (bf16, head_dim 64) on checked
    [B, H, S, D] operands and out. Strides of axes of size 1 are never
    read and go to the kernel as 0; every other batch, head and row stride,
    and every base pointer, must be a multiple of 16 bytes. Counts its own
    calls in `softmax_attention_tc.launches`."""
    b, h, sq, d = q.shape
    strides = [t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in range(3)]
    es = q.element_size()
    check_alignment(what, [t.data_ptr() for t in (q, k, v, out)], *(st * es for st in strides))
    lib = _attention_tc_lib()
    rc = lib.t3d_softmax_attention_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      (ctypes.c_longlong * 12)(*strides), b, h, sq, k.shape[2],
                                      d, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    softmax_attention_tc.launches += 1


softmax_attention_tc.launches = 0


def _attention_tc_lib() -> ctypes.CDLL:
    lib = _build.library("attention_tc")
    fn = lib.t3d_softmax_attention_tc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _attention_lib() -> ctypes.CDLL:
    lib = _build.library("attention")
    fn = lib.t3d_attention
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
