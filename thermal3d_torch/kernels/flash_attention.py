"""Attention kernels (counterpart of thermal3d/kernels/flash_attention.py).

K2 + K3, fused 2-D RoPE + attention: `fused_rope_attention` (K2,
self-attention on the packed [B,S,3C] qkv projection) and
`fused_rope_cross_attention` (K3, separate [B,S,C] q/k/v projections sharing
one position grid) return [B,S,C]. K4 + K5 + K6, softmax attention on q/k
that are already roped: `flash_attention_pallas` (K4, [N,S,D] or
[B,H,S,D]), `flash_attention_grouped` (K5) and `flash_attention_multihead`
(K6, both [B,H,S,D]) launch one kernel for the three functions the TPU tiled
three ways; each keeps its own entry and launch count.

`attention_route` names the kernel family of a call by its dtype: bf16 runs
wgmma on the tensor cores (TENSOR_CORE), float32 3xTF32 on the tensor cores
(TF32X3), at every head dim the wrappers accept (a multiple of 4 up to 256),
all on the key-tile loop of csrc/key_tile_attention.cuh. Within a family the
head dim picks the entry:
  * head dims of DIRECT_HEAD_DIMS (16, 32, 64, 128) read their operands in
    place: K2/K3 csrc/rope_attention_tc.cu (bf16; at head_dim 64 one pass over
    each head's whole rows at S <= 256, else a RoPE prologue and a 64-key
    online softmax with K4-K6's exp2 step, `tc_schedule`; at head_dim 64 the
    prologue ropes Q beside K and the key tiles run a producer warpgroup and
    three consumers in ping-pong), K4-K6 csrc/attention_tc.cu
    (bf16, 4-D tensor maps of each operand's strides, `tc_map_strides`), and
    csrc/attention_3xtf32.cu (float32: a prologue that ropes K for K2/K3 and
    splits K and V into tf32 hi and lo, then the key tiles);
  * every other head dim takes the packed entries (t3d_attention_tc_packed in
    csrc/attention_tc.cu, t3d_attention_3xtf32_packed in
    csrc/attention_3xtf32.cu) at `padded_width(head_dim)`, the smallest of
    BUILT_WIDTHS (16, 32, 64, 128, 256) at least as wide: a prologue reads q,
    k and v by their strides at any alignment (roping q and k for K2/K3) into
    a scratch zero-padded to that width, so QK^T is exact and no lane of
    another head is read; the key-tile kernel at that width runs K4-K6's
    softmax step (exp2 in bf16, the expf step in float32) and its threads
    store each row's head_dim columns.
Counts: `rope_attention_tc.launches` (bf16 K2/K3), of which
`rope_attention_tc.key_tile_launches` took the key-tile schedule,
`softmax_attention_tc.launches` (bf16 K4-K6), `rope_attention_3xtf32.launches`
and `softmax_attention_3xtf32.launches` (float32), at every head dim. A kernel
that fails to build or launch raises; float16 has no family and is refused.

`attention_3xtf32_plain` and `rope_attention_3xtf32_plain` restate the
3xTF32 arithmetic in PyTorch (tf32 rounding by masking the mantissa), for
the tests to hold it against the JAX kernels; the wrappers' plain versions
stay the float32 ones.
`flash_attention` ([B,H,S,D]) and `attention_bshd` ([B,S,H,D]) pick one of
them by `impl` name, as the JAX functions do.

Every wrapper launches its CUDA kernel for CUDA tensors and runs the plain
PyTorch version of the same arithmetic for CPU tensors. A launch runs on its
tensors' card: the library call is made inside `torch.cuda.device(out.device)`
on that card's current stream, whichever card is current. Where autograd needs
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

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel families, by the name attention_route gives them
TENSOR_CORE, TF32X3 = "tensor_core", "tensor_core_3xtf32"
# the head dims whose kernels read the operands in place (csrc/attention_tc.cuh,
# serves_head_dim); every other accepted head dim takes the packed entries
DIRECT_HEAD_DIMS = (16, 32, 64, 128)
# the widths the key-tile loop is built at (csrc/attention_tc.cuh, kBuiltWidths)
BUILT_WIDTHS = (16, 32, 64, 128, 256)


def padded_width(head_dim: int) -> int:
    """The width a call of head dim `head_dim` runs at: the smallest of
    BUILT_WIDTHS at least as wide (head_dim itself for DIRECT_HEAD_DIMS and
    256), as csrc/attention_tc.cuh's padded_width computes it (the libraries'
    t3d_attention_tc_padded_width / t3d_attention_3xtf32_padded_width); 0 for
    a head dim the kernels do not take (not a positive multiple of 4, or
    above 256)."""
    if head_dim <= 0 or head_dim % 4:
        return 0
    return next((w for w in BUILT_WIDTHS if head_dim <= w), 0)


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
    differentiable in qkv (no gradient for the tables, as in JAX). Under
    tracing, the op thermal3d_torch::fused_rope_attention (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from thermal3d_torch.kernels import ops

        return ops.fused_rope_attention(qkv, cos, sin, num_heads, scale)
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
    _build.count_launch(fused_rope_attention)
    return out


fused_rope_attention.launches = 0


def fused_rope_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K3: RoPE + cross-attention on separate [B, S, C] projections. Needs
    Sq == Sk and one shared position grid (DUSt3R's dual decoder).
    Differentiable in q, k and v. Under tracing, the op
    thermal3d_torch::fused_rope_cross_attention (kernels/ops.py)."""
    if torch.compiler.is_compiling():
        from thermal3d_torch.kernels import ops

        return ops.fused_rope_cross_attention(q, k, v, cos, sin, num_heads, scale)
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
    _build.count_launch(fused_rope_cross_attention)
    return out


fused_rope_cross_attention.launches = 0


def attention_route(dtype: torch.dtype, head_dim: int) -> Optional[str]:
    """The kernel family of an attention call (K2-K6), by dtype, at any S
    and at every head dim the wrappers accept (a multiple of 4 up to 256;
    64 is every call of the configured models, DUSt3R-224 and MASt3R-512):
      * TENSOR_CORE for bf16: wgmma, csrc/rope_attention_tc.cu for K2/K3 and
        csrc/attention_tc.cu for K4-K6 at DIRECT_HEAD_DIMS, the packed entry
        of csrc/attention_tc.cu at every other head dim;
      * TF32X3 for float32: 3xTF32 on the tensor cores
        (csrc/attention_3xtf32.cu): each operand split into tf32 hi and lo,
        each product hi*hi + hi*lo + lo*hi in float32, about 2^-21 relative
        a product, so its products are no longer IEEE float32 ones;
      * None for any other dtype (float16) or head dim: no kernel takes it,
        and the wrappers refuse it.
    A dispatch by shape: a kernel that fails to build or launch raises."""
    if padded_width(head_dim) == 0:
        return None
    return {torch.bfloat16: TENSOR_CORE, torch.float32: TF32X3}.get(dtype)


def check_alignment(what: str, pointers, *stride_bytes: int) -> None:
    """Raise ValueError unless every base pointer and every stride (in
    bytes) is a multiple of 16 (the direct tensor-core kernels read rows in
    16-byte vectors and copies)."""
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
    if x.dtype not in _DTYPES:
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launcher = rope_attention_tc if x.dtype == torch.bfloat16 else rope_attention_3xtf32
    launcher(q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale, stream, what)


def _rope_strides(row_stride: int, seq: int, head_dim: int, width: int) -> list:
    """The 12 (batch, head, row) element strides the packed entries take for
    a K2/K3 call: q, k and v rows `row_stride` apart (head h at column
    h*head_dim), then the [B, S, C] output's."""
    rows = [seq * row_stride, head_dim, row_stride]
    return rows * 3 + [seq * width, head_dim, width]


def _packed_lib(name: str) -> ctypes.CDLL:
    """This checkout's build of csrc/<name>.cu (attention_tc or
    attention_3xtf32) with its packed entry t3d_<name>_packed and scratch
    query t3d_<name>_packed_scratch_bytes declared."""
    lib = _build.library(name)
    query = getattr(lib, f"t3d_{name}_packed_scratch_bytes")
    query.argtypes = [ctypes.c_int] * 5
    query.restype = ctypes.c_ulonglong
    fn = getattr(lib, f"t3d_{name}_packed")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_packed(name: str, q_ptr: int, k_ptr: int, v_ptr: int, strides, cos, sin,
                   out: torch.Tensor, batch: int, heads: int, sq: int, sk: int, head_dim: int,
                   scale: float, stream, what: str) -> None:
    """One call of csrc/<name>.cu's packed entry, t3d_<name>_packed (the pack
    prologue and the key-tile kernel at padded_width(head_dim)): q, k, v by
    their 12 (batch, head, row) element strides at any alignment, out
    16-byte aligned, cos/sin (K2/K3) or None (K4-K6), a scratch of the
    library's own size (t3d_<name>_packed_scratch_bytes) allocated here.
    The library call runs with out's card current."""
    lib = _packed_lib(name)
    fn = getattr(lib, f"t3d_{name}_packed")
    nbytes = int(getattr(lib, f"t3d_{name}_packed_scratch_bytes")(batch, heads, sq, sk,
                                                                   head_dim))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=out.device)
    check_alignment(what, (out.data_ptr(), scratch.data_ptr()))
    tables = (0, 0) if cos is None else (cos.data_ptr(), sin.data_ptr())
    with torch.cuda.device(out.device):
        rc = fn(q_ptr, k_ptr, v_ptr, out.data_ptr(), (ctypes.c_longlong * 12)(*strides),
                *tables, scratch.data_ptr(), batch, heads, sq, sk, head_dim, float(scale),
                stream)
    _build.check(lib, rc, f"{what} launch")


def rope_attention_tc(q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale,
                      stream, what="rope_attention_tc", lib=None):
    """Launch the tensor-core K2/K3 kernel (bf16) on base pointers with a
    common row stride in elements; out [B, S, C] bf16. At DIRECT_HEAD_DIMS
    the library call launches, on `stream`, the one-pass kernel at head_dim
    64 and S <= 256, else the RoPE prologue (of K, and of Q at head_dim 64)
    plus the key-tile kernel (`tc_schedule`); only the latter gets a roped
    scratch (of the library's t3d_rope_attention_tc_scratch_bytes: 0 at
    head_dim 64 and S <= ONE_PASS_MAX_SEQ, else a bf16 [B, H, S, D] of roped
    K, and one of roped Q after it at head_dim 64), and every pointer and the
    row stride must be 16-byte aligned. `lib`: another build of
    csrc/rope_attention_tc.cu, loaded by `bind_tc_lib` (this checkout's by
    default). Every other head
    dim takes csrc/attention_tc.cu's packed entry (any alignment;
    `_launch_packed`). The library call runs with out's card current.
    Counts its own calls in `rope_attention_tc.launches`, and those that
    take the key-tile schedule also in `rope_attention_tc.key_tile_launches`."""
    b, s, c = out.shape
    d = c // num_heads
    if d not in DIRECT_HEAD_DIMS:
        _launch_packed("attention_tc", q_ptr, k_ptr, v_ptr,
                       _rope_strides(row_stride, s, d, c), cos, sin, out, b, num_heads, s, s, d,
                       scale, stream, what)
        _build.count_launch(rope_attention_tc)
        return
    lib = lib or _tc_lib()
    nbytes = int(lib.t3d_rope_attention_tc_scratch_bytes(b, s, num_heads, d))
    k_roped = (torch.empty(nbytes // out.element_size(), dtype=out.dtype, device=out.device)
               if nbytes else None)
    ptrs = (q_ptr, k_ptr, v_ptr, cos.data_ptr(), sin.data_ptr(),
            0 if k_roped is None else k_roped.data_ptr(), out.data_ptr())
    check_alignment(what, ptrs, row_stride * out.element_size())
    with torch.cuda.device(out.device):
        rc = lib.t3d_rope_attention_tc(*ptrs[:3], row_stride, *ptrs[3:], b, s, num_heads, d,
                                       float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    _build.count_launch(rope_attention_tc)
    if d != 64 or s > ONE_PASS_MAX_SEQ:  # tc_schedule's KEY_TILE
        _build.count_launch(rope_attention_tc, "key_tile_launches")


rope_attention_tc.launches = 0
rope_attention_tc.key_tile_launches = 0

# the longest S the one-pass schedule of the tensor-core K2/K3 kernel holds
# whole (csrc/rope_attention_tc.cu, one_pass::kMaxSeq)
ONE_PASS_MAX_SEQ = 256
ONE_PASS, KEY_TILE = "one_pass", "key_tile"


def tc_schedule(batch: int, heads: int, seq: int, sms: int, head_dim: int = 64):
    """The schedule the tensor-core K2/K3 kernel takes for a call on a card
    of `sms` SMs, as csrc/rope_attention_tc.cu's
    t3d_rope_attention_tc_schedule chooses it: (KEY_TILE, 1) at a head_dim
    other than 64 and past ONE_PASS_MAX_SEQ (the 64-key online softmax: at
    head_dim 64 over 192 query rows at a time, a producer warpgroup and three
    consumers in ping-pong, else over 128); else (ONE_PASS, parts), the parts
    each head's query rows are cut into: 1 where the B*H heads alone give
    every SM an item, else parts of two 64-row tiles if that does, else of
    one tile."""
    if head_dim != 64 or seq > ONE_PASS_MAX_SEQ:
        return KEY_TILE, 1
    row_tiles = -(-seq // 64)
    for tiles in (4, 2):
        parts = -(-row_tiles // tiles)
        if batch * heads * parts >= sms:
            return ONE_PASS, parts
    return ONE_PASS, row_tiles


def _tc_lib() -> ctypes.CDLL:
    return bind_tc_lib(_build.library("rope_attention_tc"))


def bind_tc_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a rope_attention_tc library's entry and
    its scratch and schedule queries."""
    fn = lib.t3d_rope_attention_tc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.t3d_rope_attention_tc_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.t3d_rope_attention_tc_scratch_bytes.restype = ctypes.c_ulonglong
    lib.t3d_rope_attention_tc_schedule.argtypes = [ctypes.c_int] * 5
    lib.t3d_rope_attention_tc_schedule.restype = ctypes.c_int
    return lib


def rope_attention_3xtf32(q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale,
                          stream, what="rope_attention_3xtf32"):
    """Launch the 3xTF32 K2/K3 kernel (float32) on base pointers with a
    common row stride in elements; out [B, S, C] float32. At DIRECT_HEAD_DIMS
    the library call launches, on `stream`, the prologue (K roped, K and V
    split into tf32 hi and lo in a scratch allocated here, `_tf32x3_scratch`)
    and the key-tile kernel, every pointer and the row stride 16-byte
    aligned; every other head dim takes the library's packed entry (any
    alignment; `_launch_packed`). The library call runs with out's card
    current. Counts its own calls in `rope_attention_3xtf32.launches`."""
    b, s, c = out.shape
    d = c // num_heads
    if d not in DIRECT_HEAD_DIMS:
        _launch_packed("attention_3xtf32", q_ptr, k_ptr, v_ptr,
                       _rope_strides(row_stride, s, d, c), cos, sin, out, b, num_heads, s, s, d,
                       scale, stream, what)
        _build.count_launch(rope_attention_3xtf32)
        return
    check_alignment(what, (q_ptr, k_ptr, v_ptr, cos.data_ptr(), sin.data_ptr(),
                           out.data_ptr()), row_stride * out.element_size())
    lib = _3xtf32_lib()
    scratch = _tf32x3_scratch(lib, b, num_heads, s, d, out.device)
    ptrs = (q_ptr, k_ptr, v_ptr, cos.data_ptr(), sin.data_ptr(), scratch.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(out.device):
        rc = lib.t3d_rope_attention_3xtf32(*ptrs[:3], row_stride, *ptrs[3:], b, s, num_heads,
                                           d, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    _build.count_launch(rope_attention_3xtf32)


rope_attention_3xtf32.launches = 0


def _tf32x3_scratch(lib, batch, heads, seq, head_dim, device) -> torch.Tensor:
    """The scratch a 3xTF32 call takes, of the library's own size
    (t3d_attention_3xtf32_scratch_bytes): K's tf32 hi and lo [B*H, S, D]
    and V's, transposed, [B*H, D, S rounded up to 8]; S is Sk for K4-K6."""
    nbytes = int(lib.t3d_attention_3xtf32_scratch_bytes(batch, heads, seq, head_dim))
    return torch.empty(nbytes // 4, dtype=torch.float32, device=device)


def _3xtf32_lib() -> ctypes.CDLL:
    lib = _build.library("attention_3xtf32")
    fn = lib.t3d_rope_attention_3xtf32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.t3d_softmax_attention_3xtf32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.t3d_attention_3xtf32_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.t3d_attention_3xtf32_scratch_bytes.restype = ctypes.c_ulonglong
    return lib


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 (10 mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32 does: half a tf32 ulp added to the
    magnitude's bits, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a @ b in float32 the way the 3xTF32 kernels take it: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), then hi@lo + lo@hi, then
    hi@hi, summed in float32 (tf32 products are exact in float32).
    products=1 takes hi@hi alone (one TF32 pass)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if products == 1:
        return ah @ bh
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           products: int = 3) -> torch.Tensor:
    """float32 q [..., Sq, D], k/v [..., Sk, D] → [..., Sq, D], the 3xTF32
    kernels' arithmetic (matmul_3xtf32 for QK^T and PV, the rest as
    attention_plain: scores times scale, float32 softmax, p in float32, the
    division after PV)."""
    scores = matmul_3xtf32(q, k.transpose(-1, -2), products) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return matmul_3xtf32(p, v, products) / p.sum(dim=-1, keepdim=True)


def rope_attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                                scale: float, products: int = 3) -> torch.Tensor:
    """float32 q/k/v [B, S, C] → [B, S, C]: RoPE in float32 as
    rope_attention_plain, then attention_3xtf32_plain."""
    b, s, c = q.shape
    d = c // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    def rope(t):
        return heads(t) * cos + rot_lanes(heads(t)) * sin

    out = attention_3xtf32_plain(rope(q), rope(k), heads(v), scale, products)
    return out.transpose(1, 2).reshape(b, s, c)


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
    kernel (the plain version on the CPU); under tracing, the op
    thermal3d_torch::softmax_attention (kernels/ops.py) with the entry's
    name."""
    if torch.compiler.is_compiling():
        from thermal3d_torch.kernels import ops

        return ops.softmax_attention(q, k, v, scale, entry.__name__)
    if _needs_grad(q, k, v):
        return _SoftmaxAttention.apply(q, k, v, scale, entry)
    return _softmax_attention_fwd(entry, q, k, v, scale)


def _softmax_attention_fwd(entry, q, k, v, scale):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.dim() == 3:
        return _softmax_attention_fwd(entry, q[None], k[None], v[None], scale)[0]
    out = _attend(entry.__name__, q, k, v, scale)
    _build.count_launch(entry)
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
    if q.dtype not in _DTYPES:
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
    launcher = softmax_attention_tc if q.dtype == torch.bfloat16 else softmax_attention_3xtf32
    launcher(q, k, v, out, scale, stream, what)
    return out


def _head_strides(q, k, v, out) -> list:
    """The (batch, head, row) element strides of q, k, v and out that the
    K4-K6 entries take: 0 for an axis of size 1 (never stepped along)."""
    return [t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in range(3)]


def softmax_attention_tc(q, k, v, out, scale, stream, what="softmax_attention_tc", lib=None):
    """Launch the tensor-core K4-K6 kernel (bf16) on checked [B, H, S, D]
    operands and out. At DIRECT_HEAD_DIMS: one block per 128 query rows of a
    (batch item, head), K/V in 64-key tiles by TMA through the key-tile loop
    that K2/K3 share, each operand read and out written through a 4-D tensor
    map of its own strides (`tc_map_strides`); strides of axes of size 1 are
    never read and go to the kernel as 0; every other batch, head and row
    stride, and every base pointer, must be a multiple of 16 bytes. `lib`:
    another build of csrc/attention_tc.cu, loaded by `bind_attention_tc_lib`
    (this checkout's by default). Every other head dim takes the library's
    packed entry (any alignment; `_launch_packed`). The library call runs
    with out's card current. Counts its own calls in
    `softmax_attention_tc.launches`."""
    b, h, sq, d = q.shape
    strides = _head_strides(q, k, v, out)
    if d not in DIRECT_HEAD_DIMS:
        _launch_packed("attention_tc", q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
                       None, None, out, b, h, sq, k.shape[2], d, scale, stream, what)
        _build.count_launch(softmax_attention_tc)
        return
    es = q.element_size()
    check_alignment(what, [t.data_ptr() for t in (q, k, v, out)], *(st * es for st in strides))
    lib = lib or _attention_tc_lib()
    with torch.cuda.device(out.device):
        rc = lib.t3d_softmax_attention_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), (ctypes.c_longlong * 12)(*strides),
                                          b, h, sq, k.shape[2], d, float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    _build.count_launch(softmax_attention_tc)


softmax_attention_tc.launches = 0


def softmax_attention_3xtf32(q, k, v, out, scale, stream, what="softmax_attention_3xtf32"):
    """Launch the 3xTF32 K4-K6 kernel (float32) on checked [B, H, S, D]
    operands and out. At DIRECT_HEAD_DIMS the prologue splits K and V (read
    by their strides) into tf32 hi and lo in a scratch allocated here, then
    the key-tile kernel reads q and writes out through 4-D tensor maps of
    their strides; strides of axes of size 1 go to the kernel as 0; every
    other stride, and every base pointer, must be a multiple of 16 bytes.
    Every other head dim takes the library's packed entry (any alignment;
    `_launch_packed`). The library call runs with out's card current. Counts
    its own calls in `softmax_attention_3xtf32.launches`."""
    b, h, sq, d = q.shape
    strides = _head_strides(q, k, v, out)
    if d not in DIRECT_HEAD_DIMS:
        _launch_packed("attention_3xtf32", q.data_ptr(), k.data_ptr(), v.data_ptr(), strides,
                       None, None, out, b, h, sq, k.shape[2], d, scale, stream, what)
        _build.count_launch(softmax_attention_3xtf32)
        return
    check_alignment(what, [t.data_ptr() for t in (q, k, v, out)],
                    *(st * q.element_size() for st in strides))
    lib = _3xtf32_lib()
    scratch = _tf32x3_scratch(lib, b, h, k.shape[2], d, out.device)
    with torch.cuda.device(out.device):
        rc = lib.t3d_softmax_attention_3xtf32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              out.data_ptr(), (ctypes.c_longlong * 12)(*strides),
                                              scratch.data_ptr(), b, h, sq, k.shape[2], d,
                                              float(scale), stream)
    _build.check(lib, rc, f"{what} launch")
    _build.count_launch(softmax_attention_3xtf32)


softmax_attention_3xtf32.launches = 0


def size_one_stride_bytes(head_dim: int) -> int:
    """The byte stride the tensor-core K4-K6 kernel's tensor maps take for an
    axis of size 1 (csrc/attention_tc.cu, size_one_stride_bytes): one bf16
    row, 2 * head_dim bytes (128 at head_dim 64)."""
    return 2 * head_dim


def tc_map_strides(strides, batch: int, heads: int, sq: int, sk: int, head_dim: int = 64):
    """The byte strides of the tensor-core K4-K6 kernel's four tensor maps,
    as csrc/attention_tc.cu's t3d_softmax_attention_tc_map_strides computes
    them from the 12 element strides `softmax_attention_tc` passes ((batch,
    head, row) of q, k, v, out): 2 bytes an element, and
    size_one_stride_bytes(head_dim) for an axis of size 1 (whose stride
    arrives as 0, which a tensor map need not take; the kernel never steps
    along it)."""
    out = []
    for i, st in enumerate(strides):
        rows = sk if i // 3 in (1, 2) else sq
        extent = (batch, heads, rows)[i % 3]
        out.append(size_one_stride_bytes(head_dim) if extent == 1 else 2 * st)
    return out


def _attention_tc_lib() -> ctypes.CDLL:
    return bind_attention_tc_lib(_build.library("attention_tc"))


def bind_attention_tc_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of an attention_tc library's entry and its
    map-stride query (the packed entry: `_packed_lib`)."""
    fn = lib.t3d_softmax_attention_tc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    query = lib.t3d_softmax_attention_tc_map_strides
    query.argtypes = [ctypes.POINTER(ctypes.c_longlong)] + \
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    query.restype = None
    return lib
