"""AsymmetricCroCo3DStereo (DUSt3R / MASt3R) in plain float32 PyTorch.

The architecture as published (naver/croco, naver/dust3r, naver/mast3r): a
ViT encoder of pre-norm blocks with 2-D RoPE ('RoPE100') self-attention, a
dual decoder whose blocks add RoPE'd cross-attention to the other branch's
previous tokens, and per-view heads: dust3r's LinearPts3d, or the DPT
pointmap head that MASt3R's catmlpdpt head carries (its local-feature MLP is
not run: the pseudo-GT path returns no descriptors). LayerNorm eps 1e-6,
exact (erf) GELU. Images enter as NHWC in [0, 1], as the program's input
contract states.

The family's module of the benchmark (a configuration file names it by
"reference": "model"): `param_shapes(cfg)` is the dust3r checkpoint layout
the benchmark makes its seeded weights in, `head_out_weights(cfg)` and
`z_channels(cfg)` the pointmap heads' tensors that the weights' `head_out_scale`
and `z_bias` set, and `tiny_config(cfg, dtype)` the configuration cut to a
width that a CPU test runs; `forward(params, cfg, img1, img2)` computes in
float32 from those weights (any stored dtype is up-cast), with TF32 off.
"""

from __future__ import annotations

import contextvars
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Shapes = List[Tuple[str, Tuple[int, ...]]]


def rope_base(cfg) -> float:
    pos = cfg.get("pos_embed", "RoPE100")
    if not pos.startswith("RoPE"):
        raise ValueError(f"pos_embed {pos!r}: only RoPE<base> is modelled")
    return float(pos[len("RoPE"):])


def _dense(name: str, cin: int, cout: int) -> Shapes:
    return [(f"{name}.weight", (cout, cin)), (f"{name}.bias", (cout,))]


def _norm(name: str, dim: int) -> Shapes:
    return [(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))]


def _conv(name: str, cin: int, cout: int, k: int, bias: bool = True) -> Shapes:
    out = [(f"{name}.weight", (cout, cin, k, k))]
    return out + ([(f"{name}.bias", (cout,))] if bias else [])


def _block(prefix: str, dim: int, mlp_ratio: float, decoder: bool) -> Shapes:
    hidden = int(dim * mlp_ratio)
    out = _norm(f"{prefix}.norm1", dim) + _dense(f"{prefix}.attn.qkv", dim, 3 * dim)
    out += _dense(f"{prefix}.attn.proj", dim, dim)
    if decoder:
        out += _norm(f"{prefix}.norm_y", dim) + _norm(f"{prefix}.norm2", dim)
        for p in ("projq", "projk", "projv", "proj"):
            out += _dense(f"{prefix}.cross_attn.{p}", dim, dim)
        out += _norm(f"{prefix}.norm3", dim)
    else:
        out += _norm(f"{prefix}.norm2", dim)
    return out + _dense(f"{prefix}.mlp.fc1", dim, hidden) + _dense(f"{prefix}.mlp.fc2", hidden, dim)


def _dpt_shapes(prefix: str, cfg) -> Shapes:
    enc, dec = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    dims, fd, last = cfg["dpt_layer_dims"], cfg["feature_dim"], cfg["last_dim"]
    p = f"{prefix}.dpt"
    out = _conv(f"{p}.act_postprocess.0.0", enc, dims[0], 1)
    out += [(f"{p}.act_postprocess.0.1.weight", (dims[0], dims[0], 4, 4)),
            (f"{p}.act_postprocess.0.1.bias", (dims[0],))]
    out += _conv(f"{p}.act_postprocess.1.0", dec, dims[1], 1)
    out += [(f"{p}.act_postprocess.1.1.weight", (dims[1], dims[1], 2, 2)),
            (f"{p}.act_postprocess.1.1.bias", (dims[1],))]
    out += _conv(f"{p}.act_postprocess.2.0", dec, dims[2], 1)
    out += _conv(f"{p}.act_postprocess.3.0", dec, dims[3], 1)
    out += _conv(f"{p}.act_postprocess.3.1", dims[3], dims[3], 3)
    for i, d in enumerate(dims, start=1):
        out += _conv(f"{p}.scratch.layer{i}_rn", d, fd, 3, bias=False)
    for i in range(1, 5):
        r = f"{p}.scratch.refinenet{i}"
        for unit in (("resConfUnit1", "resConfUnit2") if i < 4 else ("resConfUnit2",)):
            out += _conv(f"{r}.{unit}.conv1", fd, fd, 3) + _conv(f"{r}.{unit}.conv2", fd, fd, 3)
        out += _conv(f"{r}.out_conv", fd, fd, 1)
    out += _conv(f"{p}.head.0", fd, fd // 2, 3) + _conv(f"{p}.head.2", fd // 2, last, 3)
    out += _conv(f"{p}.head.4", last, 4, 1)
    if cfg["head_type"] == "catmlpdpt":
        idim = enc + dec
        nout = (cfg["local_feat_dim"] + int(cfg["two_confs"])) * cfg["patch_size"] ** 2
        hidden = int(cfg["desc_hidden_dim_factor"] * idim)
        out += _dense(f"{prefix}.head_local_features.fc1", idim, hidden)
        out += _dense(f"{prefix}.head_local_features.fc2", hidden, nout)
    return out


def param_shapes(cfg) -> Shapes:
    """(name, shape) of every weight, in the dust3r checkpoint's names."""
    enc, dec, p = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["patch_size"]
    out = _conv("patch_embed.proj", 3, enc, p)
    for i in range(cfg["enc_depth"]):
        out += _block(f"enc_blocks.{i}", enc, cfg["mlp_ratio"], decoder=False)
    out += _norm("enc_norm", enc) + _dense("decoder_embed", enc, dec)
    for branch in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg["dec_depth"]):
            out += _block(f"{branch}.{i}", dec, cfg["mlp_ratio"], decoder=True)
    out += _norm("dec_norm", dec)
    for h in ("downstream_head1", "downstream_head2"):
        if cfg["head_type"] == "linear":
            out += _dense(f"{h}.proj", dec, 4 * p * p)
        elif cfg["head_type"] in ("dpt", "catmlpdpt"):
            out += _dpt_shapes(h, cfg)
        else:
            raise ValueError(f"head_type {cfg['head_type']!r} is not modelled")
    return out


def head_out_weights(cfg):
    """The pointmap heads' last weights: a trained head puts points at a
    scene's scale, where random DPT features would put them at expm1 of
    several units (coordinates in the thousands, many overflowing)."""
    for h in ("downstream_head1", "downstream_head2"):
        yield f"{h}.proj.weight" if cfg["head_type"] == "linear" else f"{h}.dpt.head.4.weight"


def z_channels(cfg):
    """(name, index) of the pointmap heads' last biases that feed the Z
    coordinate: a trained model puts its points in front of the camera, so
    the seeded weights start Z at `z_bias`."""
    p2 = cfg["patch_size"] ** 2
    for h in ("downstream_head1", "downstream_head2"):
        if cfg["head_type"] == "linear":  # channels (c, dy, dx): c = 2
            yield f"{h}.proj.bias", slice(2 * p2, 3 * p2)
        else:
            yield f"{h}.dpt.head.4.bias", 2


TINY_MODEL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=48,
                  dec_depth=2, dec_num_heads=2)
TINY_DPT = dict(feature_dim=32, last_dim=16, dpt_layer_dims=[8, 16, 24, 32])


def tiny_config(cfg: dict, dtype: str) -> dict:
    """The configuration at a width and image size that a CPU test runs."""
    cfg = dict(cfg, dtype=dtype, **TINY_MODEL)
    if cfg["head_type"] == "linear":
        cfg["img_size"] = [32, 32]
    else:
        cfg.update(img_size=[64, 64], **TINY_DPT)
    return cfg


# --------------------------------------------------------------------------
# forward


# the dtype every product's two operands are rounded to (per-tensor scaled),
# set by forward: None computes in float32; float8_e4m3fn is the control of a
# bfloat16 configuration (the reference one precision below it)
_GEMM_DTYPE: contextvars.ContextVar = contextvars.ContextVar("gemm_dtype", default=None)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _round(t: torch.Tensor) -> torch.Tensor:
    dtype = _GEMM_DTYPE.get()
    if dtype is None:
        return t
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(torch.float32) * scale


def _linear(x, params, name):
    return F.linear(_round(x), _round(_f32(params[f"{name}.weight"])),
                    _f32(params[f"{name}.bias"]))


def _layer_norm(x, params, name):
    return F.layer_norm(x, x.shape[-1:], _f32(params[f"{name}.weight"]),
                        _f32(params[f"{name}.bias"]), 1e-6)


def _rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """GPT-NeoX rotation of t [..., S, d] by integer positions pos [S]."""
    d = t.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float64, device=t.device) / d))
    angles = pos.to(torch.float64)[:, None] * inv_freq[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(angles).to(t.dtype), torch.sin(angles).to(t.dtype)
    half = d // 2
    rotated = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * cos + rotated * sin


def _rope_2d(t: torch.Tensor, grid: Tuple[int, int], base: float) -> torch.Tensor:
    """croco RoPE2D on [B, H, S, D]: the first half of D rotated by the
    token's row, the second by its column (row-major patch order)."""
    h, w = grid
    ys = torch.arange(h, device=t.device).repeat_interleave(w)
    xs = torch.arange(w, device=t.device).repeat(h)
    d = t.shape[-1] // 2
    return torch.cat([_rope_1d(t[..., :d], ys, base), _rope_1d(t[..., d:], xs, base)], dim=-1)


def _attend(q, k, v, heads: int, grid, base: float):
    """softmax(rope(q) rope(k)^T / sqrt(D)) v over [B, S, C] projections."""
    b, s, c = q.shape

    def split(t):
        return t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)

    qh, kh = _rope_2d(split(q), grid, base), _rope_2d(split(k), grid, base)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(c // heads)
    out = torch.softmax(scores, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, s, c)


def _self_attention(x, params, name, heads, grid, base):
    qkv = _linear(x, params, f"{name}.qkv")
    c = x.shape[-1]
    out = _attend(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], heads, grid, base)
    return _linear(out, params, f"{name}.proj")


def _mlp(x, params, name):
    return _linear(F.gelu(_linear(x, params, f"{name}.fc1")), params, f"{name}.fc2")


def encode(params, cfg, img: torch.Tensor):
    """img [B, H, W, 3] → (tokens [B, S, enc_dim], patch grid)."""
    p = cfg["patch_size"]
    x = F.conv2d(_f32(img).permute(0, 3, 1, 2), _f32(params["patch_embed.proj.weight"]),
                 _f32(params["patch_embed.proj.bias"]), stride=p)
    grid = tuple(x.shape[2:])
    x = x.flatten(2).transpose(1, 2)
    base, heads = rope_base(cfg), cfg["enc_num_heads"]
    for i in range(cfg["enc_depth"]):
        n = f"enc_blocks.{i}"
        x = x + _self_attention(_layer_norm(x, params, f"{n}.norm1"), params, f"{n}.attn",
                                heads, grid, base)
        x = x + _mlp(_layer_norm(x, params, f"{n}.norm2"), params, f"{n}.mlp")
    return _layer_norm(x, params, "enc_norm"), grid


def _decoder_block(x, y, params, n, heads, grid, base):
    x = x + _self_attention(_layer_norm(x, params, f"{n}.norm1"), params, f"{n}.attn",
                            heads, grid, base)
    y_ = _layer_norm(y, params, f"{n}.norm_y")
    xq = _layer_norm(x, params, f"{n}.norm2")
    c = f"{n}.cross_attn"
    out = _attend(_linear(xq, params, f"{c}.projq"), _linear(y_, params, f"{c}.projk"),
                  _linear(y_, params, f"{c}.projv"), heads, grid, base)
    x = x + _linear(out, params, f"{c}.proj")
    return x + _mlp(_layer_norm(x, params, f"{n}.norm3"), params, f"{n}.mlp")


def decode(params, cfg, f1, f2, grid):
    """→ per view the hooks [encoder tokens, dec_1, ..., dec_L], dec_norm on the last."""
    base, heads = rope_base(cfg), cfg["dec_num_heads"]
    x1, x2 = _linear(f1, params, "decoder_embed"), _linear(f2, params, "decoder_embed")
    outs1, outs2 = [f1], [f2]
    for i in range(cfg["dec_depth"]):
        x1, x2 = (_decoder_block(x1, x2, params, f"dec_blocks.{i}", heads, grid, base),
                  _decoder_block(x2, x1, params, f"dec_blocks2.{i}", heads, grid, base))
        outs1.append(x1)
        outs2.append(x2)
    outs1[-1] = _layer_norm(outs1[-1], params, "dec_norm")
    outs2[-1] = _layer_norm(outs2[-1], params, "dec_norm")
    return outs1, outs2


def _postprocess(fmap: torch.Tensor) -> Dict[str, torch.Tensor]:
    """dust3r depth_mode ('exp', -inf, inf), conf_mode ('exp', 1, inf)."""
    xyz = fmap[..., :3]
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / d.clamp(min=1e-8) * torch.expm1(d)
    return {"pts3d": pts, "conf": 1.0 + torch.exp(fmap[..., 3])}


def _linear_head(params, name, cfg, tokens, grid):
    p = cfg["patch_size"]
    feat = _linear(tokens, params, f"{name}.proj")  # [B, S, 4*p*p], channels (c, dy, dx)
    b = feat.shape[0]
    h, w = grid
    fmap = F.pixel_shuffle(feat.transpose(1, 2).reshape(b, 4 * p * p, h, w), p)
    return _postprocess(fmap.permute(0, 2, 3, 1))


def _conv2d(x, params, name, stride=1, padding=0):
    bias = params.get(f"{name}.bias")
    return F.conv2d(x, _f32(params[f"{name}.weight"]), None if bias is None else _f32(bias),
                    stride=stride, padding=padding)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def _rcu(x, params, name):
    y = _conv2d(F.relu(x), params, f"{name}.conv1", padding=1)
    return _conv2d(F.relu(y), params, f"{name}.conv2", padding=1) + x


def _fusion(params, name, x, skip=None, out_hw=None):
    if skip is not None:
        x = x + _rcu(skip, params, f"{name}.resConfUnit1")
    x = _up2(_rcu(x, params, f"{name}.resConfUnit2"))
    if out_hw is not None:
        x = x[:, :, :out_hw[0], :out_hw[1]]
    return _conv2d(x, params, f"{name}.out_conv")


def _dpt_head(params, name, cfg, hooks, grid):
    """croco DPTOutputAdapter + dust3r PixelwiseTaskWithDPT (pts3d, conf)."""
    p = f"{name}.dpt"
    h, w = grid
    maps = [t.reshape(t.shape[0], h, w, t.shape[-1]).permute(0, 3, 1, 2) for t in hooks]
    a = f"{p}.act_postprocess"
    l1 = F.conv_transpose2d(_conv2d(maps[0], params, f"{a}.0.0"), _f32(params[f"{a}.0.1.weight"]),
                            _f32(params[f"{a}.0.1.bias"]), stride=4)
    l2 = F.conv_transpose2d(_conv2d(maps[1], params, f"{a}.1.0"), _f32(params[f"{a}.1.1.weight"]),
                            _f32(params[f"{a}.1.1.bias"]), stride=2)
    l3 = _conv2d(maps[2], params, f"{a}.2.0")
    l4 = _conv2d(_conv2d(maps[3], params, f"{a}.3.0"), params, f"{a}.3.1", stride=2, padding=1)
    s = f"{p}.scratch"
    r1, r2, r3, r4 = (_conv2d(x, params, f"{s}.layer{i}_rn", padding=1)
                      for i, x in enumerate((l1, l2, l3, l4), start=1))
    x = _fusion(params, f"{s}.refinenet4", r4, out_hw=r3.shape[2:])
    x = _fusion(params, f"{s}.refinenet3", x, r3, out_hw=r2.shape[2:])
    x = _fusion(params, f"{s}.refinenet2", x, r2, out_hw=r1.shape[2:])
    x = _fusion(params, f"{s}.refinenet1", x, r1)
    x = _up2(_conv2d(x, params, f"{p}.head.0", padding=1))
    x = F.relu(_conv2d(x, params, f"{p}.head.2", padding=1))
    return _postprocess(_conv2d(x, params, f"{p}.head.4").permute(0, 2, 3, 1))


def dpt_hooks(dec_depth: int) -> Tuple[int, int, int, int]:
    """dust3r create_dpt_head: hooks [0, L/2, 3L/4, L] into [enc, dec_1..dec_L]."""
    return (0, dec_depth * 2 // 4, dec_depth * 3 // 4, dec_depth)


def _head(params, name, cfg, outs, grid):
    if cfg["head_type"] == "linear":
        return _linear_head(params, name, cfg, outs[-1], grid)
    return _dpt_head(params, name, cfg, [outs[i] for i in dpt_hooks(cfg["dec_depth"])], grid)


def forward(params: Dict[str, torch.Tensor], cfg, img1: torch.Tensor, img2=None,
            gemm_dtype=None):
    """→ (pred1 {'pts3d', 'conf'}, pred2 {'pts3d_in_other_view', 'conf'}) in
    float32. img2=None is the monocular mode: view 2 is view 1. gemm_dtype
    rounds both operands of every Dense product to it (the control)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    token = _GEMM_DTYPE.set(gemm_dtype)
    try:
        with torch.no_grad():
            if img2 is None:
                f1, grid = encode(params, cfg, img1)
                f2 = f1
            else:
                feats, grid = encode(params, cfg, torch.cat([img1, img2]))
                f1, f2 = feats[:img1.shape[0]], feats[img1.shape[0]:]
            outs1, outs2 = decode(params, cfg, f1, f2, grid)
            pred1 = _head(params, "downstream_head1", cfg, outs1, grid)
            pred2 = _head(params, "downstream_head2", cfg, outs2, grid)
            return pred1, {"pts3d_in_other_view": pred2["pts3d"], "conf": pred2["conf"]}
    finally:
        _GEMM_DTYPE.reset(token)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
