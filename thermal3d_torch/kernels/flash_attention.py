"""K2 + K3: fused 2-D RoPE + attention (counterpart of the fused kernels in
thermal3d/kernels/flash_attention.py).

`fused_rope_attention` (K2, self-attention on the packed [B,S,3C] qkv
projection) and `fused_rope_cross_attention` (K3, separate [B,S,C] q/k/v
projections sharing one position grid) launch the CUDA kernel in
csrc/rope_attention.cu for CUDA tensors and run the plain PyTorch version of
the same arithmetic for CPU tensors. Both return [B,S,C]. Forward only: a
CUDA input that requires grad raises (the backward kernel comes with
training).
"""

from __future__ import annotations

import ctypes

import torch

from thermal3d_torch.kernels import _build

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
        return (t * cos + rot_lanes(t) * sin).to(dt).to(torch.float32)

    qr, kr, vf = rope(heads(q)), rope(heads(k)), heads(v)
    scores = torch.matmul(qr, kr.transpose(-1, -2)) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(dt).to(torch.float32), vf) / denom
    return out.to(dt).transpose(1, 2).reshape(b, s, c)


def fused_rope_attention_plain(qkv, cos, sin, num_heads, scale):
    """Plain version of K2 on the packed [B, S, 3C] projection."""
    c = qkv.shape[-1] // 3
    return rope_attention_plain(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                cos, sin, num_heads, scale)


def fused_rope_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """K2: RoPE + self-attention on the packed [B, S, 3C] qkv projection."""
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
    Sq == Sk and one shared position grid (DUSt3R's dual decoder)."""
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
    """Shared memory one block of the kernel needs (K/V of one head, whole
    sequence). Needs the built library."""
    fn = _lib().t3d_rope_attention_smem_bytes
    return int(fn(seq, head_dim, torch.tensor([], dtype=dtype).element_size()))


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
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{what}: the CUDA kernel is forward only")
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
    need = smem_bytes(s, d, x.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"{what}: S={s}, head_dim={d} needs {need} B of shared "
                         f"memory for K/V, over the {SMEM_LIMIT} B a block has "
                         "(longer sequences need the key-tile loop)")


def _launch(x, q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale, what):
    b, s, c = out.shape
    if b == 0 or s == 0:
        return
    lib = _lib()
    rc = lib.t3d_rope_attention(
        _DTYPE_CODE[x.dtype], q_ptr, k_ptr, v_ptr, row_stride, cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), b, s, num_heads, c // num_heads, float(scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, f"{what} launch")


def _lib() -> ctypes.CDLL:
    lib = _build.library("rope_attention")
    fn = lib.t3d_rope_attention
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sm = lib.t3d_rope_attention_smem_bytes
    sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    sm.restype = ctypes.c_ulonglong
    return lib
