"""AsymmetricCroCo3DStereo — the DUSt3R two-view pointmap network
(counterpart of thermal3d/models/dustr.py), unrolled layout, linear head.

I/O contract:
  model(img1, img2=None) -> (pred1, pred2), images NHWC [B, H, W, 3] in [0, 1]
  pred1 = {"pts3d": [B,H,W,3], "conf": [B,H,W]}
  pred2 = {"pts3d_in_other_view": [B,H,W,3], "conf": [B,H,W]}
img2=None is the monocular mode: view 2 is view 1, so the encoder runs once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from thermal3d_torch.core.config import DustrModelConfig
from thermal3d_torch.models.heads import LinearPts3dHead
from thermal3d_torch.models.layers import (Dense, DecoderBlock, EncoderBlock,
                                           LayerNorm, PatchEmbed)
from thermal3d_torch.models.rope import make_grid_positions, rope_tables


def check_supported(cfg: DustrModelConfig) -> None:
    """Raise NotImplementedError for the layouts the port does not run yet."""
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers is not ported: use the unrolled layout")
    if cfg.branch_batch:
        raise NotImplementedError("branch_batch is not ported: use the unrolled layout")
    if cfg.head.head_type != "linear":
        raise NotImplementedError(
            f"head_type {cfg.head.head_type!r} is not ported (only 'linear')")


class AsymmetricCroCo3DStereo(nn.Module):
    def __init__(self, cfg: DustrModelConfig):
        super().__init__()
        check_supported(cfg)
        self.config = cfg
        dt = cfg.dtype
        impl = cfg.attention_impl
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_channels,
                                      cfg.enc_embed_dim, dt)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(cfg.enc_embed_dim, cfg.enc_num_heads, cfg.mlp_ratio, dt, impl)
            for _ in range(cfg.enc_depth))
        self.enc_norm = LayerNorm(cfg.enc_embed_dim, dt)
        self.decoder_embed = Dense(cfg.enc_embed_dim, cfg.dec_embed_dim, dt)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, cfg.mlp_ratio, dt, impl)
            for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(cfg.dec_embed_dim, cfg.dec_num_heads, cfg.mlp_ratio, dt, impl)
            for _ in range(cfg.dec_depth))
        self.dec_norm = LayerNorm(cfg.dec_embed_dim, dt)
        self.downstream_head1 = LinearPts3dHead(cfg.dec_embed_dim, cfg.patch_size, cfg.head)
        self.downstream_head2 = LinearPts3dHead(cfg.dec_embed_dim, cfg.patch_size, cfg.head)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: matrices and convs normal with std
        1/sqrt(fan_in) (the JAX lecun_normal scale), biases 0, norms 1/0."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:  # LayerNorm scale
                p.fill_(1.0)
            else:
                fan_in = math.prod(p.shape[1:])
                noise = torch.randn(p.shape, generator=generator,
                                    device=generator.device, dtype=torch.float32)
                p.copy_(noise / math.sqrt(fan_in))

    def _rope(self, grid, head_dim, device):
        pos = make_grid_positions(*grid, device=device)
        return rope_tables(pos, head_dim, self.config.rope_base)

    def encode(self, img: torch.Tensor):
        """img: [B, H, W, 3] → (tokens [B, S, enc_dim], patch grid)."""
        cfg = self.config
        x, grid = self.patch_embed(img)
        rope = self._rope(grid, cfg.enc_embed_dim // cfg.enc_num_heads, x.device)
        for blk in self.enc_blocks:
            x = blk(x, rope)
        return self.enc_norm(x), grid

    def decode(self, f1: torch.Tensor, f2: torch.Tensor, grid) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dual-branch decoder; returns the dec_norm'ed last tokens per view.
        Each branch cross-attends to the other branch's PREVIOUS tokens."""
        cfg = self.config
        rope = self._rope(grid, cfg.dec_embed_dim // cfg.dec_num_heads, f1.device)
        x1 = self.decoder_embed(f1)
        x2 = self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, rope), blk2(x2, x1, rope)
        return self.dec_norm(x1), self.dec_norm(x2)

    def forward(self, img1: torch.Tensor, img2: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, Dict]:
        b = img1.shape[0]
        if img2 is None:
            f1, grid = self.encode(img1)
            f2 = f1
        else:
            feats, grid = self.encode(torch.cat([img1, img2], dim=0))
            f1, f2 = feats[:b], feats[b:]
        t1, t2 = self.decode(f1, f2, grid)
        pred1 = self.downstream_head1(t1, grid)
        res2 = self.downstream_head2(t2, grid)
        pred2 = {"pts3d_in_other_view": res2["pts3d"], "conf": res2["conf"]}
        return pred1, pred2
