"""2-D rotary position embedding, croco 'RoPE100' (counterpart of
thermal3d/models/rope.py).

The per-head feature dim is split in halves: the first is rotated by the
token's row (y), the second by its column (x), each with a 1-D GPT-NeoX-style
rotation at base frequency 100.
"""

from __future__ import annotations

import torch


def make_grid_positions(h: int, w: int, device=None) -> torch.Tensor:
    """int64 [h*w, 2] (y, x) positions of an h×w patch grid, row-major."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)


def _inv_freq(dim: int, base: float, device) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))


def rope_tables(positions: torch.Tensor, head_dim: int, base: float = 100.0):
    """(cos, sin) float32 [S, head_dim] laid out [fy, fy, fx, fx], so that
    `t*cos + rot(t)*sin` equals apply_rope_2d_bshd with
    rot(t) = [-t[d4:2d4], t[:d4], -t[3d4:], t[2d4:3d4]]."""
    inv_freq = _inv_freq(head_dim // 2, base, positions.device)
    fy = positions[:, 0].to(torch.float32)[:, None] * inv_freq
    fx = positions[:, 1].to(torch.float32)[:, None] * inv_freq
    freqs = torch.cat([fy, fy, fx, fx], dim=-1)
    return torch.cos(freqs), torch.sin(freqs)


def _rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    d = t.shape[-1]
    freqs = pos.to(torch.float32)[..., None] * _inv_freq(d, base, t.device)
    freqs = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(freqs).to(t.dtype)
    sin = torch.sin(freqs).to(t.dtype)
    half = d // 2
    rotated = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos + rotated * sin


def _rope_2d(tokens: torch.Tensor, pos_y: torch.Tensor, pos_x: torch.Tensor,
             base: float) -> torch.Tensor:
    d = tokens.shape[-1] // 2
    return torch.cat([_rope_1d(tokens[..., :d], pos_y, base),
                      _rope_1d(tokens[..., d:], pos_x, base)], dim=-1)


def apply_rope_2d(tokens: torch.Tensor, positions: torch.Tensor,
                  base: float = 100.0) -> torch.Tensor:
    """2-D RoPE on [B, num_heads, S, head_dim] tokens in their own dtype;
    positions [S, 2] or [B, S, 2] (y, x)."""
    if positions.dim() == 2:
        return _rope_2d(tokens, positions[:, 0], positions[:, 1], base)
    # [B, 1, S]: broadcasts over heads
    return _rope_2d(tokens, positions[:, None, :, 0], positions[:, None, :, 1], base)


def apply_rope_2d_bshd(tokens: torch.Tensor, positions: torch.Tensor,
                       base: float = 100.0) -> torch.Tensor:
    """2-D RoPE on [B, S, num_heads, head_dim] tokens in their own dtype;
    positions [S, 2] (y, x)."""
    # [S, 1]: broadcasts over heads
    return _rope_2d(tokens, positions[:, 0][:, None], positions[:, 1][:, None], base)
