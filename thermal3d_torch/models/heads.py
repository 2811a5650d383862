"""Linear pointmap head (counterpart of the linear subset of
thermal3d/models/heads.py). The DPT and catmlpdpt heads are not ported yet.

Activation contract (dust3r postprocess):
  pts3d = unit(xyz) * expm1(|xyz|)        depth_mode ('exp', -inf, inf)
  conf  = 1 + exp(c)                      conf_mode  ('exp', 1, inf)
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from thermal3d_torch.core.config import HeadConfig


def reg_dense_pts3d(xyz: torch.Tensor,
                    mode=("exp", float("-inf"), float("inf"))) -> torch.Tensor:
    """dust3r reg_dense_depth: direction * expm1(norm)."""
    kind, vmin, vmax = mode
    if kind != "exp":
        raise NotImplementedError(f"depth mode {kind}")
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    unit = xyz / torch.clamp(d, min=1e-8)
    if vmin == float("-inf") and vmax == float("inf"):
        return unit * torch.expm1(d)
    return unit * torch.clamp(torch.expm1(d), vmin, vmax)


def reg_dense_conf(x: torch.Tensor, mode=("exp", 1.0, float("inf"))) -> torch.Tensor:
    """dust3r reg_dense_conf: vmin + min(exp(x), vmax - vmin)."""
    kind, vmin, vmax = mode
    if kind != "exp":
        raise NotImplementedError(f"conf mode {kind}")
    e = torch.exp(x)
    if vmax != float("inf"):
        e = torch.clamp(e, max=vmax - vmin)
    return vmin + e


def pixel_shuffle_tokens(feat: torch.Tensor, grid: Tuple[int, int], p: int) -> torch.Tensor:
    """[B, S, C*p*p] tokens → [B, h*p, w*p, C]; the per-token channel layout
    is (c, dy, dx), as torch's view + F.pixel_shuffle(p) reads it."""
    b, s, cpp = feat.shape
    h, w = grid
    c = cpp // (p * p)
    feat = feat.reshape(b, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3)  # b,h,dy,w,dx,c
    return feat.reshape(b, h * p, w * p, c)


class LinearPts3dHead(nn.Module):
    """dust3r LinearPts3d: proj to 4·p² per token, pixel shuffle, activations.
    Always float32: bfloat16 weights are up-cast after their rounding."""

    def __init__(self, dim: int, patch_size: int, cfg: HeadConfig):
        super().__init__()
        self.proj = nn.Linear(dim, 4 * patch_size * patch_size)
        self.patch_size = patch_size
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, grid: Tuple[int, int]):
        feat = F.linear(tokens.to(torch.float32), self.proj.weight.to(torch.float32),
                        self.proj.bias.to(torch.float32))
        fmap = pixel_shuffle_tokens(feat, grid, self.patch_size)  # [B, H, W, 4]
        return {
            "pts3d": reg_dense_pts3d(fmap[..., 0:3], self.cfg.depth_mode),
            "conf": reg_dense_conf(fmap[..., 3], self.cfg.conf_mode),
        }
