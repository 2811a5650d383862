"""Downstream heads (counterpart of thermal3d/models/heads.py): the linear
pointmap head, the DPT head and the MASt3R cat-MLP + DPT head.

Activation contract (dust3r postprocess):
  pts3d = unit(xyz) * expm1(|xyz|)        depth_mode ('exp', -inf, inf)
  conf  = 1 + exp(c)                      conf_mode  ('exp', 1, inf)
  desc  = x / |x|                         (catmlpdpt local features)

The DPT heads take and return NHWC maps ([B,H,W,C]), as the JAX heads do.
Inside, the pyramid runs as NCHW tensors in channels-last memory (a token
map [B,h,w,C] permuted to NCHW is already that layout), which cuDNN's convs
take without a copy. The convs are nn.Conv2d / nn.ConvTranspose2d (cuDNN on
the card), computing in the head dtype from weights stored in any dtype, in
IEEE float32 (no TF32) when that dtype is float32. Module names follow the torch/dust3r checkpoint layout (`dpt.act_postprocess`,
`dpt.scratch.layer*_rn`, `dpt.scratch.refinenet*`, `dpt.head`,
`head_local_features.fc1/fc2`), so a converted state dict loads strictly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from thermal3d_torch.core.config import HeadConfig
from thermal3d_torch.core.device import exact_float32_convs
from thermal3d_torch.models.layers import Dense
from thermal3d_torch.preprocess.resize import resize_bilinear_hwc


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


def reg_desc(x: torch.Tensor, mode: str = "norm") -> torch.Tensor:
    if mode != "norm":
        raise NotImplementedError(f"desc mode {mode}")
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


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


# ---------------------------------------------------------------------------
# DPT head (croco dpt_block.DPTOutputAdapter via dust3r PixelwiseTaskWithDPT)
# ---------------------------------------------------------------------------

class _Conv(nn.Conv2d):
    """nn.Conv2d computing in `dtype` from weights stored in any dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        with exact_float32_convs(self.dtype):
            return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), bias)


class _ConvT(nn.ConvTranspose2d):
    """Non-overlapping transposed conv (kernel = stride) in `dtype`."""

    def __init__(self, channels: int, factor: int, dtype: torch.dtype):
        super().__init__(channels, channels, factor, stride=factor)
        self.dtype = dtype

    def forward(self, x):
        with exact_float32_convs(self.dtype):
            return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                      self.bias.to(self.dtype), stride=self.stride)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """×2 bilinear upsample with align_corners=True (DPT's Interpolate) of an
    NCHW map, in float32 and cast back, as the matmul resize of the JAX head."""
    h, w = x.shape[-2:]
    y = resize_bilinear_hwc(x.permute(0, 2, 3, 1), (2 * h, 2 * w), align_corners=True)
    return y.permute(0, 3, 1, 2)


class _Upsample2x(nn.Module):
    def forward(self, x):
        return _upsample2x(x)


class _ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = _Conv(features, features, 3, dtype, padding=1)
        self.conv2 = _Conv(features, features, 3, dtype, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class _FeatureFusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock_custom (no deconv, bn or expand,
    align_corners=True). `out_hw` crops the ×2 upsample to the next skip
    branch's size, as croco's DPTOutputAdapter does; that matters for odd
    patch grids, where act4's stride-2 conv gives ceil(h/2) rows. The block
    that takes no skip (refinenet4) has no resConfUnit1."""

    def __init__(self, features: int, dtype: torch.dtype, has_skip: bool = True):
        super().__init__()
        if has_skip:
            self.resConfUnit1 = _ResidualConvUnit(features, dtype)
        self.resConfUnit2 = _ResidualConvUnit(features, dtype)
        self.out_conv = _Conv(features, features, 1, dtype)

    def forward(self, x, skip: Optional[torch.Tensor] = None,
                out_hw: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = _upsample2x(self.resConfUnit2(x))
        if out_hw is not None:
            x = x[:, :, :out_hw[0], :out_hw[1]]
        return self.out_conv(x)


class _Scratch(nn.Module):
    def __init__(self, dims: Sequence[int], features: int, dtype: torch.dtype):
        super().__init__()
        for i, d in enumerate(dims, start=1):
            setattr(self, f"layer{i}_rn", _Conv(d, features, 3, dtype, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", _FeatureFusionBlock(features, dtype, has_skip=i < 4))


class DPTHead(nn.Module):
    """DPT regression head over 4 hooked token sets [encoder_out, dec[L/2],
    dec[3L/4], dec[L]] of widths `in_dims`; returns [B, H, W, num_channels]
    at full image resolution in the head dtype."""

    def __init__(self, cfg: HeadConfig, in_dims: Sequence[int], num_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        dims = cfg.dpt_layer_dims
        fd = cfg.feature_dim
        self.dtype = dtype
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(_Conv(in_dims[0], dims[0], 1, dtype), _ConvT(dims[0], 4, dtype)),
            nn.Sequential(_Conv(in_dims[1], dims[1], 1, dtype), _ConvT(dims[1], 2, dtype)),
            nn.Sequential(_Conv(in_dims[2], dims[2], 1, dtype)),
            nn.Sequential(_Conv(in_dims[3], dims[3], 1, dtype),
                          _Conv(dims[3], dims[3], 3, dtype, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(dims, fd, dtype)
        self.head = nn.Sequential(
            _Conv(fd, fd // 2, 3, dtype, padding=1), _Upsample2x(),
            _Conv(fd // 2, cfg.last_dim, 3, dtype, padding=1), nn.ReLU(),
            _Conv(cfg.last_dim, num_channels, 1, dtype))

    def forward(self, hooked_tokens: Sequence[torch.Tensor], grid: Tuple[int, int]):
        h, w = grid
        maps = [t.to(self.dtype).reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2)
                for t in hooked_tokens]
        sc = self.scratch
        layers = [post(m) for post, m in zip(self.act_postprocess, maps)]
        r1, r2, r3, r4 = (rn(x) for rn, x in zip(
            (sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn), layers))
        p4 = sc.refinenet4(r4, out_hw=r3.shape[2:])
        p3 = sc.refinenet3(p4, r3, out_hw=r2.shape[2:])
        p2 = sc.refinenet2(p3, r2, out_hw=r1.shape[2:])
        p1 = sc.refinenet1(p2, r1)
        return self.head(p1).permute(0, 2, 3, 1)


class DPTPts3dHead(nn.Module):
    """PixelwiseTaskWithDPT: DPT → (pts3d, conf), activations in float32."""

    def __init__(self, cfg: HeadConfig, in_dims: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dpt = DPTHead(cfg, in_dims, 4, dtype)

    def forward(self, hooked_tokens: Sequence[torch.Tensor], grid: Tuple[int, int]
                ) -> Dict[str, torch.Tensor]:
        fmap = self.dpt(hooked_tokens, grid).to(torch.float32)
        return {"pts3d": reg_dense_pts3d(fmap[..., 0:3], self.cfg.depth_mode),
                "conf": reg_dense_conf(fmap[..., 3], self.cfg.conf_mode)}


class _LocalFeatureMlp(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden, dtype)
        self.fc2 = Dense(hidden, out_dim, dtype)

    def forward(self, x):
        # exact erf GELU in every dtype, as the JAX head (unlike the trunk Mlp)
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class CatMLPDPTHead(DPTPts3dHead):
    """MASt3R Cat_MLP_LocalFeatures_DPT_Pts3d: the DPT pts3d/conf branch plus
    a one-hidden-layer MLP on cat(encoder, decoder) tokens, pixel-shuffled to
    the (desc, desc_conf) maps."""

    def __init__(self, patch_size: int, cfg: HeadConfig, in_dims: Sequence[int],
                 dtype: torch.dtype):
        super().__init__(cfg, in_dims, dtype)
        self.patch_size = patch_size
        idim = in_dims[0] + in_dims[-1]
        nout = (cfg.local_feat_dim + int(cfg.two_confs)) * patch_size * patch_size
        self.head_local_features = _LocalFeatureMlp(
            idim, int(cfg.desc_hidden_dim_factor * idim), nout, dtype)
        self.dtype = dtype

    def forward(self, hooked_tokens: Sequence[torch.Tensor], grid: Tuple[int, int],
                enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
                with_desc: bool = True) -> Dict[str, torch.Tensor]:
        """with_desc=False skips the local-feature branch (desc/desc_conf are
        then absent); the pseudo-GT generator, which returns no descriptors,
        passes it."""
        out = super().forward(hooked_tokens, grid)
        if not with_desc:
            return out
        cat = torch.cat([enc_tokens.to(self.dtype), dec_tokens.to(self.dtype)], dim=-1)
        fmap = pixel_shuffle_tokens(self.head_local_features(cat), grid, self.patch_size)
        fmap = fmap.to(torch.float32)
        ldim = self.cfg.local_feat_dim
        out["desc"] = reg_desc(fmap[..., :ldim])
        if self.cfg.two_confs:
            out["desc_conf"] = reg_dense_conf(fmap[..., ldim], self.cfg.desc_conf_mode)
        else:
            # mast3r postprocess: with one confidence the pointmap conf
            # doubles as the descriptor conf
            out["desc_conf"] = out["conf"]
        return out


def dpt_hook_indices(dec_depth: int) -> Tuple[int, int, int, int]:
    """dust3r create_dpt_head hooks: [0, 2L/4, 3L/4, L] into
    [encoder_out, dec_1..dec_L]."""
    return (0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth)
