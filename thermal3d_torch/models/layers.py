"""Transformer layers of the DUSt3R family (counterpart of
thermal3d/models/layers.py).

Pre-norm ViT encoder blocks with RoPE'd self-attention, and croco decoder
blocks that add RoPE'd cross-attention to the other view's tokens. Module and
parameter names follow the torch/dust3r checkpoint layout (`attn.qkv`,
`cross_attn.projq`, `norm_y`, `mlp.fc1`, ...), so a converted state dict loads
with strict=True.

Parameters are stored in whatever dtype the engine gives them (float32, or
bfloat16 for `params_dtype='bfloat16'`) and cast to the compute dtype where
they are used, as the JAX modules do. GEMMs, LayerNorm, GELU and the patch
conv are plain PyTorch (the conv in IEEE float32 when it computes in
float32: no TF32); attention goes through the kernels of
kernels/flash_attention.py, by `attention_impl`: 'auto' or 'pallas_fused[N]'
the fused RoPE kernels K2/K3; 'pallas' / 'pallas_grouped[N]' /
'pallas_multihead' RoPE on the [B,S,H,D] heads (apply_rope_2d_bshd), then K4
/ K5 / K6; 'torch' the plain version of K2/K3.

Tensor parallelism (core/mesh.py::shard_model_): once a model is sharded,
`tp_group` of each Attention, CrossAttention and Mlp is the 'model' process
group, and the module holds this rank's share: its input passes
copy_to_model_parallel (identity forward, all-reduce backward), the column-
split projections give this rank's H/tp heads (the packed qkv split by
heads) or hidden features, the row-split proj / fc2 multiply without their
bias, reduce_from_model_parallel sums the parts over the group, and the bias
is added once after the sum (core/collectives.py, Megatron's recipe).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from thermal3d_torch.core.collectives import copy_to_model_parallel, reduce_from_model_parallel
from thermal3d_torch.core.device import exact_float32_convs
from thermal3d_torch.kernels.flash_attention import (
    attention_bshd, check_attention_impl, fused_rope_attention, fused_rope_attention_plain,
    fused_rope_cross_attention, is_fused_impl, rope_attention_plain)
from thermal3d_torch.kernels.quant import int8_dense
from thermal3d_torch.models.rope import apply_rope_2d_bshd


class Rope(NamedTuple):
    """The position encoding of one patch grid: (cos, sin) tables [S, head_dim]
    for the fused kernels, and the (y, x) positions [S, 2] with the base
    frequency for apply_rope_2d_bshd (the 'pallas*' routes)."""

    cos: torch.Tensor
    sin: torch.Tensor
    positions: Optional[torch.Tensor] = None
    base: float = 100.0


class Dense(nn.Module):
    """y = x W^T + b in the compute dtype (the JAX QuantDense).

    After kernels.quant.quantize_model_int8 (set_int8) the weight is int8
    [N, K] beside its float32 `weight_scale` and an optional static
    `act_scale`, and the product runs through kernels.quant.int8_dense by
    the route `int8_impl`; the bias is added in the compute dtype after the
    dequant, as the JAX module adds it. Without scales the buffers are None
    (and absent from the state dict)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.register_buffer("weight_scale", None)
        self.register_buffer("act_scale", None)
        self.int8_impl = "int_mm"
        self.dtype = dtype

    def set_int8(self, wq: torch.Tensor, ws: torch.Tensor, act_scale: Optional[torch.Tensor],
                 impl: str) -> None:
        """Install the int8 weight, its scales and the product's route."""
        dev = self.bias.device
        self.weight = nn.Parameter(wq.to(dev), requires_grad=False)
        self.weight_scale = ws.to(dev)
        self.act_scale = None if act_scale is None else act_scale.to(dev)
        self.int8_impl = impl

    def forward(self, x):
        if self.weight_scale is not None:
            y = int8_dense(x, self.weight, self.weight_scale, self.dtype,
                           act_scale=self.act_scale, impl=self.int8_impl)
            return y + self.bias.to(self.dtype)
        if self.weight.dtype == torch.int8:
            raise ValueError("int8-quantized weight applied without its scales: quantize "
                             "with kernels.quant.quantize_model_int8 or load them with "
                             "load_int8_state_dict; quantized weights are serving-only and "
                             "cannot be trained")
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-6 unless given), output in the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        x = x.to(self.dtype)
        return F.layer_norm(x, x.shape[-1:], self.weight.to(self.dtype),
                            self.bias.to(self.dtype), self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)
        # exact erf GELU in float32; the tanh form in bfloat16, as the JAX
        # model does (its error is below bfloat16's rounding)
        self.approximate = "tanh" if dtype == torch.bfloat16 else "none"
        self.tp_group = None

    def forward(self, x):
        x = copy_to_model_parallel(x, self.tp_group)
        return row_parallel(self.fc2, F.gelu(self.fc1(x), approximate=self.approximate),
                            self.tp_group)


def row_parallel(dense: Dense, x: torch.Tensor, group) -> torch.Tensor:
    """dense(x) for a row-split Dense: the partial product of this rank's
    input features, summed over `group`, then the bias (once). Without a
    group, dense(x)."""
    if group is None:
        return dense(x)
    y = F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype))
    return reduce_from_model_parallel(y, group) + dense.bias.to(dense.dtype)


def _check_impl(impl: str) -> None:
    if not is_fused_impl(impl):
        check_attention_impl(impl)


def _split_attention(q, k, v, num_heads, rope: Rope, impl):
    """The 'pallas*' routes: [B, S, C] projections → heads [B, S, H, D], RoPE
    on q and k in their dtype, attention through K4/K5/K6 → [B, S, C]."""
    b, s, c = q.shape

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, c // num_heads)

    qh = apply_rope_2d_bshd(heads(q), rope.positions, rope.base)
    kh = apply_rope_2d_bshd(heads(k), rope.positions, rope.base)
    return attention_bshd(qh, kh, heads(v), impl=impl).reshape(b, s, c)


class Attention(nn.Module):
    """Self-attention on the packed qkv projection with 2-D RoPE on q/k."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attention_impl: str = "auto"):
        super().__init__()
        _check_impl(attention_impl)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(dim // num_heads)
        self.attention_impl = attention_impl
        self.tp_group = None

    def forward(self, x, rope: Rope):
        qkv = self.qkv(copy_to_model_parallel(x, self.tp_group))
        impl = self.attention_impl
        if impl == "torch" or is_fused_impl(impl):
            attend = fused_rope_attention_plain if impl == "torch" else fused_rope_attention
            out = attend(qkv, rope[0], rope[1], self.num_heads, self.scale)
        else:
            c = qkv.shape[-1] // 3
            out = _split_attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                                   self.num_heads, rope, impl)
        return row_parallel(self.proj, out, self.tp_group)


class CrossAttention(nn.Module):
    """Cross-attention: queries from x, keys/values from y; both views share
    one patch grid, so one RoPE table pair serves q and k."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attention_impl: str = "auto"):
        super().__init__()
        _check_impl(attention_impl)
        self.projq = Dense(dim, dim, dtype)
        self.projk = Dense(dim, dim, dtype)
        self.projv = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(dim // num_heads)
        self.attention_impl = attention_impl
        self.tp_group = None

    def forward(self, x, y, rope: Rope):
        x = copy_to_model_parallel(x, self.tp_group)
        y = copy_to_model_parallel(y, self.tp_group)
        q, k, v = self.projq(x), self.projk(y), self.projv(y)
        impl = self.attention_impl
        if impl == "torch" or is_fused_impl(impl):
            attend = rope_attention_plain if impl == "torch" else fused_rope_cross_attention
            out = attend(q, k, v, rope[0], rope[1], self.num_heads, self.scale)
        else:
            out = _split_attention(q, k, v, self.num_heads, rope, impl)
        return row_parallel(self.proj, out, self.tp_group)


class EncoderBlock(nn.Module):
    """x += attn(norm1(x)); x += mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype, attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype, attention_impl)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, rope: Rope):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """croco DecoderBlock:
        x = x + attn(norm1(x));  y_ = norm_y(y)
        x = x + cross_attn(norm2(x), y_);  x = x + mlp(norm3(x))"""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 dtype: torch.dtype, attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype, attention_impl)
        self.norm_y = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.cross_attn = CrossAttention(dim, num_heads, dtype, attention_impl)
        self.norm3 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x, y, rope: Rope):
        x = x + self.attn(self.norm1(x), rope)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rope)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    """16×16 conv patchifier: NHWC image → [B, h*w, C] tokens (row-major)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.dtype = dtype

    def forward(self, img):
        with exact_float32_convs(self.dtype):
            x = F.conv2d(img.to(self.dtype).permute(0, 3, 1, 2),
                         self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype),
                         stride=self.proj.stride)
        b, c, h, w = x.shape
        return x.flatten(2).transpose(1, 2), (h, w)
