"""The work of a VGGT window, counted from a configuration's shapes (the
family `vggt`; benchmark/counts.py counts dust3r's).

What the algorithm needs at the cell's shapes, whatever implements it:
2·M·K·N operations for a product, 4·B·S_q·S_k·C for an attention call
(QK^T and PV), 2·H·W·C_in·C_out·k² for a convolution (k² taps of every
input pixel for a non-overlapping transposed one), and each input and
output read or written once. `frames` is the window's length.
"""

from __future__ import annotations

from typing import List, Tuple

POSE_DIM = 9
DPT_LAST = 32


def grid(cfg) -> int:
    return cfg["img_size"] // cfg["patch_size"]


def tokens(cfg) -> int:
    """A frame's tokens: the camera token, the registers, the patches."""
    return 1 + cfg["num_register_tokens"] + grid(cfg) ** 2


def _block_products(m: int, c: int, ratio: float) -> List[Tuple[int, int, int]]:
    h = int(c * ratio)
    return [(m, c, 3 * c), (m, c, c), (m, c, h), (m, h, c)]


def trunk_products(cfg, frames: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every product of the patch trunk's, the frame blocks' and
    the global blocks' Dense layers over a window."""
    m = frames * tokens(cfg)
    blocks = cfg["patch_depth"] + 2 * cfg["depth"]
    return blocks * _block_products(m, cfg["embed_dim"], cfg["mlp_ratio"])


def camera_products(cfg, frames: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of the camera head's products: each round the pose
    embedding, the adaLN modulation, the trunk's blocks and the pose MLP."""
    d = 2 * cfg["embed_dim"]
    one = [(frames, POSE_DIM, d), (frames, d, 3 * d)]
    one += cfg["camera_trunk_depth"] * _block_products(frames, d, cfg["mlp_ratio"])
    one += [(frames, d, d // 2), (frames, d // 2, POSE_DIM)]
    return cfg["camera_iterations"] * one


def product_flops(mkn) -> float:
    return float(sum(2 * m * k * n for m, k, n in mkn))


def product_bytes(mkn, itemsize: int) -> float:
    return float(sum((m * k + k * n + m * n + n) * itemsize for m, k, n in mkn))


def k2_calls(cfg, frames: int) -> List[Tuple[int, int, int, int]]:
    """(B, S, C, heads) of every K2 call of a window: a frame block's over
    each frame, a global block's over the window's tokens."""
    c, h, s = cfg["embed_dim"], cfg["num_heads"], tokens(cfg)
    return cfg["depth"] * [(frames, s, c, h), (1, frames * s, c, h)]


def k4_calls(cfg, frames: int) -> List[Tuple[int, int, int, int]]:
    """(B, S, C, heads) of every K4 call: the patch trunk's over each frame,
    the camera head's over the window's camera tokens."""
    trunk = [(frames, tokens(cfg), cfg["embed_dim"], cfg["num_heads"])] * cfg["patch_depth"]
    camera = [(1, frames, 2 * cfg["embed_dim"], cfg["camera_num_heads"])]
    return trunk + camera * (cfg["camera_trunk_depth"] * cfg["camera_iterations"])


def attention_flops(calls) -> float:
    return float(sum(4 * b * s * s * c for b, s, c, _ in calls))


def attention_bytes(calls, itemsize: int, tables: bool = True) -> float:
    """q, k and v read once, the output written once, and with `tables` the
    float32 cos/sin tables (K2) of the call's rows and head dim."""
    return float(sum(4 * b * s * c * itemsize + (2 * s * (c // h) * 4 if tables else 0)
                     for b, s, c, h in calls))


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def dpt_flops(cfg, frames: int, out_dim: int) -> float:
    """Convolutions of one DPT head over `frames` frames."""
    g, d = grid(cfg), 2 * cfg["embed_dim"]
    oc, fd = cfg["dpt_out_channels"], cfg["dpt_features"]
    half = -(-g // 2)
    f = sum(_conv(g, g, d, c, 1) for c in oc)  # projects
    f += _conv(g, g, oc[0], oc[0], 4) + _conv(g, g, oc[1], oc[1], 2)  # transposed, k = s
    f += _conv(half, half, oc[3], oc[3], 3)  # stride 2
    sizes = [4 * g, 2 * g, g, half]
    f += sum(_conv(s, s, c, fd, 3) for s, c in zip(sizes, oc))  # layer*_rn
    # refinenet4 .. refinenet1: residual units at the input size, out_conv at the next
    outs = [sizes[2], sizes[1], sizes[0], 2 * sizes[0]]
    for i, (s, o) in enumerate(zip(reversed(sizes), outs)):
        units = 1 if i == 0 else 2
        f += units * 2 * _conv(s, s, fd, fd, 3) + _conv(o, o, fd, fd, 1)
    f += _conv(8 * g, 8 * g, fd, fd // 2, 3)  # output_conv1
    size = cfg["img_size"]
    f += _conv(size, size, fd // 2, DPT_LAST, 3) + _conv(size, size, DPT_LAST, out_dim, 1)
    return frames * f


def window_flops(cfg, frames: int) -> float:
    """A window's forward pass: patch embedding, every product, every
    attention call, both DPT heads' convolutions."""
    patch = 2.0 * frames * grid(cfg) ** 2 * 3 * cfg["patch_size"] ** 2 * cfg["embed_dim"]
    products = trunk_products(cfg, frames) + camera_products(cfg, frames)
    attention = k2_calls(cfg, frames) + k4_calls(cfg, frames)
    return (patch + product_flops(products) + attention_flops(attention)
            + dpt_flops(cfg, frames, 2) + dpt_flops(cfg, frames, 4))
