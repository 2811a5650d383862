"""The work of a forward pass, counted from a configuration's shapes.

What the algorithm needs at the cell's shapes, whatever implements it:
2·M·K·N operations for a product, 4·B·S_q·S_k·C for an attention call
(QK^T and PV), 2·H·W·C_in·C_out·k² for a convolution, and each input and
output read or written once. `enc_images` are the images the encoder runs
on; `dec_images` the rows each of the two decoder branches runs on.
"""

from __future__ import annotations

from typing import List, Tuple


def tokens(cfg) -> int:
    h, w = cfg["img_size"]
    return (h // cfg["patch_size"]) * (w // cfg["patch_size"])


def trunk_products(cfg, enc_images: int, dec_images: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every product of the encoder and decoder blocks and the
    decoder embedding (the trunk's Dense layers)."""
    s, e, d = tokens(cfg), cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    he, hd = int(e * cfg["mlp_ratio"]), int(d * cfg["mlp_ratio"])
    me, md = enc_images * s, dec_images * s
    out = []
    for _ in range(cfg["enc_depth"]):
        out += [(me, e, 3 * e), (me, e, e), (me, e, he), (me, he, e)]
    for _ in range(2):  # the two decoder branches
        out.append((md, e, d))
        for _ in range(cfg["dec_depth"]):
            out += [(md, d, 3 * d), (md, d, d), (md, d, d), (md, d, d), (md, d, d),
                    (md, d, d), (md, d, hd), (md, hd, d)]
    return out


def product_flops(mkn) -> float:
    return float(sum(2 * m * k * n for m, k, n in mkn))


def product_bytes(mkn, itemsize: int) -> float:
    return float(sum((m * k + k * n + m * n + n) * itemsize for m, k, n in mkn))


def attention_calls(cfg, enc_images: int, dec_images: int) -> List[Tuple[int, int, int, int]]:
    """(B, S, C, heads) of every K2 (self) and K3 (cross) call."""
    s = tokens(cfg)
    enc = [(enc_images, s, cfg["enc_embed_dim"], cfg["enc_num_heads"])] * cfg["enc_depth"]
    dec = [(dec_images, s, cfg["dec_embed_dim"], cfg["dec_num_heads"])] * (4 * cfg["dec_depth"])
    return enc + dec


def attention_flops(calls) -> float:
    return float(sum(4 * b * s * s * c for b, s, c, _ in calls))


def attention_bytes(calls, itemsize: int) -> float:
    """q, k and v read once, the output written once, and the float32
    cos/sin tables of the call's head dim."""
    return float(sum(4 * b * s * c * itemsize + 2 * s * (c // h) * 4 for b, s, c, h in calls))


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def dpt_flops(cfg, images: int) -> float:
    """Convolutions of one DPT pointmap head over `images` images."""
    gh, gw = (n // cfg["patch_size"] for n in cfg["img_size"])
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    d0, d1, d2, d3 = cfg["dpt_layer_dims"]
    fd, last = cfg["feature_dim"], cfg["last_dim"]
    f = _conv(gh, gw, e, d0, 1) + _conv(gh, gw, d0, d0, 4)  # 1x1, then a k=4 s=4 transpose
    f += _conv(gh, gw, d, d1, 1) + _conv(gh, gw, d1, d1, 2)
    f += _conv(gh, gw, d, d2, 1)
    f += _conv(gh, gw, d, d3, 1) + _conv(-(-gh // 2), -(-gw // 2), d3, d3, 3)
    scales = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (-(-gh // 2), -(-gw // 2))]
    f += sum(_conv(h, w, c, fd, 3) for (h, w), c in zip(scales, (d0, d1, d2, d3)))
    for i, (h, w) in enumerate(reversed(scales)):  # refinenet4 .. refinenet1
        units = 1 if i == 0 else 2
        out_h, out_w = (scales[2 - i] if i < 3 else (8 * gh, 8 * gw))
        f += units * 2 * _conv(h, w, fd, fd, 3) + _conv(out_h, out_w, fd, fd, 1)
    f += _conv(8 * gh, 8 * gw, fd, fd // 2, 3)
    f += _conv(16 * gh, 16 * gw, fd // 2, last, 3) + _conv(16 * gh, 16 * gw, last, 4, 1)
    return images * f


def head_flops(cfg, images_per_head: int) -> float:
    """Both pointmap heads, each over `images_per_head` images."""
    if cfg["head_type"] == "linear":
        out = 4 * cfg["patch_size"] ** 2
        return 2 * images_per_head * 2.0 * tokens(cfg) * cfg["dec_embed_dim"] * out
    return 2 * dpt_flops(cfg, images_per_head)


def model_flops(cfg, enc_images: int, dec_images: int) -> float:
    """A forward pass: patch embedding, trunk products, attention, heads."""
    patch = 2.0 * enc_images * tokens(cfg) * 3 * cfg["patch_size"] ** 2 * cfg["enc_embed_dim"]
    return (patch + product_flops(trunk_products(cfg, enc_images, dec_images))
            + attention_flops(attention_calls(cfg, enc_images, dec_images))
            + head_flops(cfg, dec_images))
