"""The kernels K1-K6 as torch.library custom ops, so that a traced program
(torch.export, torch.compile) carries them as single nodes:

  thermal3d_torch::percentile_enhance          K1
  thermal3d_torch::fused_rope_attention        K2
  thermal3d_torch::fused_rope_cross_attention  K3
  thermal3d_torch::softmax_attention           K4, K5, K6 (`entry` names which)

Each op's implementation is its wrapper's launch (kernels/image_ops.py,
kernels/flash_attention.py): the CUDA kernel, counted by the wrapper's own
launch count, for CUDA tensors, the plain PyTorch version for CPU tensors.
Its fake implementation gives the output's shape, dtype and layout to the
tracer, with any batch size. The wrappers route to these ops only while a
trace runs (torch.compiler.is_compiling()); an eager call launches directly,
with no dispatcher work per call. Importing this module registers the ops;
a saved program that holds them needs it imported before it is loaded
(infer/export.py does that). Forward only: no autograd formula is
registered, and an artifact serves forward passes.
"""

from __future__ import annotations

import importlib

import torch
from torch.library import custom_op

from thermal3d_torch.kernels.image_ops import launch_percentile_enhance

# the module (the package re-exports its function flash_attention)
fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")

SOFTMAX_ENTRIES = {f.__name__: f for f in (fa.flash_attention_pallas, fa.flash_attention_grouped,
                                           fa.flash_attention_multihead)}


@custom_op("thermal3d_torch::percentile_enhance", mutates_args=())
def percentile_enhance(gray: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """K1 on [B, H, W] float32 in [0, 1] (kernels/image_ops.py)."""
    return launch_percentile_enhance(gray, lo, hi)


@percentile_enhance.register_fake
def _(gray, lo, hi):
    return torch.empty_like(gray)


@custom_op("thermal3d_torch::fused_rope_attention", mutates_args=())
def fused_rope_attention(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """K2 on the packed [B, S, 3C] projection → [B, S, C]."""
    return fa._fused_rope_attention_fwd(qkv, cos, sin, num_heads, scale)


@fused_rope_attention.register_fake
def _(qkv, cos, sin, num_heads, scale):
    b, s, three_c = qkv.shape
    return qkv.new_empty((b, s, three_c // 3))


@custom_op("thermal3d_torch::fused_rope_cross_attention", mutates_args=())
def fused_rope_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K3 on separate [B, S, C] projections → [B, S, C]."""
    return fa._fused_rope_cross_attention_fwd(q, k, v, cos, sin, num_heads, scale)


@fused_rope_cross_attention.register_fake
def _(q, k, v, cos, sin, num_heads, scale):
    return q.new_empty(q.shape)


@custom_op("thermal3d_torch::softmax_attention", mutates_args=())
def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      entry: str) -> torch.Tensor:
    """K4/K5/K6 on roped q [N, Sq, D] or [B, H, Sq, D] and k/v of Sk rows;
    `entry` is the wrapper whose count moves: flash_attention_pallas (K4),
    flash_attention_grouped (K5) or flash_attention_multihead (K6)."""
    if entry not in SOFTMAX_ENTRIES:
        raise ValueError(f"softmax_attention: unknown entry {entry!r} "
                         f"(not in {tuple(SOFTMAX_ENTRIES)})")
    out = fa._softmax_attention_fwd(SOFTMAX_ENTRIES[entry], q, k, v, scale)
    like_q = torch.empty_like(q)
    # the plain version returns a contiguous result; a traced program was
    # told (below) that it has q's layout
    return out if out.stride() == like_q.stride() else like_q.copy_(out)


@softmax_attention.register_fake
def _(q, k, v, scale, entry):
    # the kernels write the output in q's layout (a [B, S, H, D] view in
    # gives one out), which empty_like keeps for a dense q
    return torch.empty_like(q)
