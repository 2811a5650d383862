"""VGGT (Visual Geometry Grounded Transformer; Wang et al., CVPR 2025,
arXiv:2503.11651, facebookresearch/vggt) in plain float32 PyTorch, without
the track head.

A window of N frames of one scene ([N, H, W, 3] in [0, 1], the program's
input contract) goes, in one pass, to each frame's depth and depth
confidence, world points (in frame 0's camera) and their confidence, and a
9-number camera (translation, quaternion, two fields of view):

  * patch trunk, DINOv2 ViT-L/14 with 4 registers: ResNet mean/std, a
    14x14 conv, cat(cls, patches) + a learned position embedding,
    cat(cls, registers, patches), pre-norm blocks (LayerNorm eps 1e-6, qkv
    bias, plain attention, exact GELU MLP, LayerScale on both residuals),
    a final norm; the patch tokens go on;
  * aggregator: cat(camera token, 4 register tokens, patches) a frame
    (frame 0 takes slot 0 of the [1, 2, ...] camera and register
    parameters, every later frame slot 1), then `depth` pairs of a frame
    block (attention within each frame) and a global block (attention over
    the whole window); their attention normalises q and k by a LayerNorm
    over the head dim (QK-norm), then 2-D RoPE at base 100 (croco's
    RoPE100 layout), the patches at grid positions (y + 1, x + 1) and the
    special tokens at (0, 0); LayerNorm eps 1e-5 (nn.LayerNorm's default);
    layer i's output is cat(frame_i, global_i);
  * two DPT heads on the layers `dpt_layers` (depth: exp and 1 + exp;
    points: sign * expm1(|x|) and 1 + exp), with a sinusoidal UV embedding
    (ratio 0.1) after each projection and before the last convs, fusion
    blocks resizing bilinearly (align_corners=True) to the next skip's size,
    and `output_conv1` at 8x the patch grid resized to the image. The fusion
    blocks' ReLU runs in place as published (nn.ReLU(inplace=True)), so each
    residual conv unit adds relu(x), not x;
  * the camera head on the last layer's camera tokens: token_norm, then
    `camera_iterations` rounds of adaLN modulation by the embedded pose
    (the empty pose tokens first), `camera_trunk_depth` blocks (no RoPE, no
    QK-norm), trunk_norm and an MLP to 9 deltas summed over the rounds; the
    fields of view through ReLU.

The family's module of the benchmark (a configuration names it by
"reference": "vggt"): `param_shapes(cfg)` is the checkpoint's layout
(`aggregator.*`, `camera_head.*`, `depth_head.*`, `point_head.*`) that the
benchmark draws its seeded weights in, `tiny_config(cfg, dtype)` the
configuration at a CPU test's size, and `forward(params, cfg, frames)`
computes in float32 from those weights (any stored dtype is up-cast), with
TF32 off, attention in query blocks so that a window's 32,976 tokens fit.
It imports nothing of the program.
"""

from __future__ import annotations

import contextvars
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Shapes = List[Tuple[str, Tuple[int, ...]]]

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
POSE_DIM = 9  # absT_quaR_FoV
DPT_LAST = 32  # output_conv2's hidden channels
UV_RATIO = 0.1
# score elements a query block of the attention may hold (1 GiB in float32)
SCORE_BUDGET = 1 << 28
# frames a DPT head pass of the reference (its memory only)
HEAD_FRAMES = 4


def tokens_per_frame(cfg) -> int:
    return 1 + cfg["num_register_tokens"] + grid(cfg)[0] * grid(cfg)[1]


def grid(cfg) -> Tuple[int, int]:
    n = cfg["img_size"] // cfg["patch_size"]
    return n, n


def _dense(name: str, cin: int, cout: int) -> Shapes:
    return [(f"{name}.weight", (cout, cin)), (f"{name}.bias", (cout,))]


def _norm(name: str, dim: int) -> Shapes:
    return [(f"{name}.weight", (dim,)), (f"{name}.bias", (dim,))]


def _conv(name: str, cin: int, cout: int, k: int, bias: bool = True) -> Shapes:
    return [(f"{name}.weight", (cout, cin, k, k))] + ([(f"{name}.bias", (cout,))] if bias else [])


def _block(prefix: str, dim: int, heads: int, mlp_ratio: float, qk_norm: bool) -> Shapes:
    out = _norm(f"{prefix}.norm1", dim) + _dense(f"{prefix}.attn.qkv", dim, 3 * dim)
    if qk_norm:
        out += _norm(f"{prefix}.attn.q_norm", dim // heads)
        out += _norm(f"{prefix}.attn.k_norm", dim // heads)
    out += _dense(f"{prefix}.attn.proj", dim, dim) + [(f"{prefix}.ls1.gamma", (dim,))]
    hidden = int(dim * mlp_ratio)
    out += _norm(f"{prefix}.norm2", dim) + _dense(f"{prefix}.mlp.fc1", dim, hidden)
    return out + _dense(f"{prefix}.mlp.fc2", hidden, dim) + [(f"{prefix}.ls2.gamma", (dim,))]


def _dpt_shapes(prefix: str, cfg, out_dim: int) -> Shapes:
    dim, oc, fd = 2 * cfg["embed_dim"], cfg["dpt_out_channels"], cfg["dpt_features"]
    out = _norm(f"{prefix}.norm", dim)
    for i, c in enumerate(oc):
        out += _conv(f"{prefix}.projects.{i}", dim, c, 1)
    # ConvTranspose2d weights are [in, out, k, k]
    out += [(f"{prefix}.resize_layers.0.weight", (oc[0], oc[0], 4, 4)),
            (f"{prefix}.resize_layers.0.bias", (oc[0],)),
            (f"{prefix}.resize_layers.1.weight", (oc[1], oc[1], 2, 2)),
            (f"{prefix}.resize_layers.1.bias", (oc[1],))]
    out += _conv(f"{prefix}.resize_layers.3", oc[3], oc[3], 3)
    s = f"{prefix}.scratch"
    for i, c in enumerate(oc, start=1):
        out += _conv(f"{s}.layer{i}_rn", c, fd, 3, bias=False)
    for i in range(1, 5):
        r = f"{s}.refinenet{i}"
        out += _conv(f"{r}.out_conv", fd, fd, 1)
        for unit in (("resConfUnit1", "resConfUnit2") if i < 4 else ("resConfUnit2",)):
            out += _conv(f"{r}.{unit}.conv1", fd, fd, 3) + _conv(f"{r}.{unit}.conv2", fd, fd, 3)
    out += _conv(f"{s}.output_conv1", fd, fd // 2, 3)
    out += _conv(f"{s}.output_conv2.0", fd // 2, DPT_LAST, 3)
    return out + _conv(f"{s}.output_conv2.2", DPT_LAST, out_dim, 1)


def param_shapes(cfg) -> Shapes:
    """(name, shape) of every weight, in the published checkpoint's names
    (its track head left out)."""
    c, heads, ratio = cfg["embed_dim"], cfg["num_heads"], cfg["mlp_ratio"]
    r, p = cfg["num_register_tokens"], cfg["patch_size"]
    pe = "aggregator.patch_embed"
    out = [(f"{pe}.cls_token", (1, 1, c)), (f"{pe}.pos_embed", (1, 1 + grid(cfg)[0] ** 2, c)),
           (f"{pe}.register_tokens", (1, r, c)), (f"{pe}.mask_token", (1, c))]
    out += _conv(f"{pe}.patch_embed.proj", 3, c, p)
    for i in range(cfg["patch_depth"]):
        out += _block(f"{pe}.blocks.{i}", c, heads, ratio, qk_norm=False)
    out += _norm(f"{pe}.norm", c)
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(cfg["depth"]):
            out += _block(f"aggregator.{kind}.{i}", c, heads, ratio, qk_norm=True)
    out += [("aggregator.camera_token", (1, 2, 1, c)), ("aggregator.register_token", (1, 2, r, c))]
    dim, ch = 2 * c, "camera_head"
    for i in range(cfg["camera_trunk_depth"]):
        out += _block(f"{ch}.trunk.{i}", dim, cfg["camera_num_heads"], ratio, qk_norm=False)
    out += _norm(f"{ch}.token_norm", dim) + _norm(f"{ch}.trunk_norm", dim)
    out += [(f"{ch}.empty_pose_tokens", (1, 1, POSE_DIM))] + _dense(f"{ch}.embed_pose", POSE_DIM, dim)
    out += _dense(f"{ch}.poseLN_modulation.1", dim, 3 * dim)
    out += _dense(f"{ch}.pose_branch.fc1", dim, dim // 2)
    out += _dense(f"{ch}.pose_branch.fc2", dim // 2, POSE_DIM)
    return out + _dpt_shapes("depth_head", cfg, 2) + _dpt_shapes("point_head", cfg, 4)


TINY = dict(img_size=56, embed_dim=32, num_heads=2, patch_depth=2, depth=4,
            dpt_layers=[0, 1, 2, 3], dpt_features=16, dpt_out_channels=[8, 16, 24, 32],
            camera_trunk_depth=2, camera_num_heads=2)


def tiny_config(cfg: dict, dtype: str) -> dict:
    """The configuration at a width, depth and image size a CPU test runs
    (a 4x4 patch grid; every kind of layer kept)."""
    return dict(cfg, dtype=dtype, **TINY)


# --------------------------------------------------------------------------
# forward


# the dtype every product's two operands are rounded to (per-tensor scaled),
# set by forward: None computes in float32; float8_e4m3fn is the control of a
# bfloat16 configuration (the reference one precision below it)
_GEMM_DTYPE: contextvars.ContextVar = contextvars.ContextVar("vggt_gemm_dtype", default=None)


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


def _layer_norm(x, params, name, eps: float):
    return F.layer_norm(x, x.shape[-1:], _f32(params[f"{name}.weight"]),
                        _f32(params[f"{name}.bias"]), eps)


def _rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """GPT-NeoX rotation of t [..., S, d] by integer positions pos [S]."""
    d = t.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float64, device=t.device) / d))
    angles = pos.to(torch.float64)[:, None] * inv_freq[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(angles).to(t.dtype), torch.sin(angles).to(t.dtype)
    half = d // 2
    return t * cos + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sin


def _rope_2d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """RotaryPositionEmbedding2D on [B, H, S, D]: the first half of D rotated
    by the token's row, the second by its column; pos [S, 2] (y, x)."""
    d = t.shape[-1] // 2
    return torch.cat([_rope_1d(t[..., :d], pos[:, 0], base),
                      _rope_1d(t[..., d:], pos[:, 1], base)], dim=-1)


def positions(cfg, device) -> torch.Tensor:
    """int64 [tokens_per_frame, 2] (y, x): the special tokens at (0, 0), the
    patches at (y + 1, x + 1), row-major."""
    h, w = grid(cfg)
    ys = torch.arange(h, device=device).repeat_interleave(w)
    xs = torch.arange(w, device=device).repeat(h)
    special = torch.zeros(1 + cfg["num_register_tokens"], 2, dtype=torch.int64, device=device)
    return torch.cat([special, torch.stack([ys, xs], dim=-1) + 1])


def _attention(q, k, v):
    """softmax(q k^T / sqrt(D)) v on [B, H, S, D], a block of query rows at a
    time so that the scores of S = 32,976 keys fit."""
    b, h, s, d = q.shape
    rows = max(1, SCORE_BUDGET // (b * h * k.shape[2]))
    out = torch.empty_like(q)
    for i in range(0, s, rows):
        scores = (q[:, :, i:i + rows] @ k.transpose(-1, -2)) / math.sqrt(d)
        out[:, :, i:i + rows] = torch.softmax(scores, dim=-1) @ v
    return out


def _block_fwd(x, params, n, heads, eps, pos=None, base=100.0, qk_norm=False):
    """vggt.layers.Block: x += ls1 * proj(attn(LN(x))); x += ls2 * mlp(LN(x))."""
    b, s, c = x.shape
    qkv = _linear(_layer_norm(x, params, f"{n}.norm1", eps), params, f"{n}.attn.qkv")
    q, k, v = qkv.reshape(b, s, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    if qk_norm:
        q = _layer_norm(q, params, f"{n}.attn.q_norm", eps)
        k = _layer_norm(k, params, f"{n}.attn.k_norm", eps)
    if pos is not None:
        q, k = _rope_2d(q, pos, base), _rope_2d(k, pos, base)
    a = _attention(q, k, v).transpose(1, 2).reshape(b, s, c)
    x = x + _f32(params[f"{n}.ls1.gamma"]) * _linear(a, params, f"{n}.attn.proj")
    h = _linear(_layer_norm(x, params, f"{n}.norm2", eps), params, f"{n}.mlp.fc1")
    h = _linear(F.gelu(h), params, f"{n}.mlp.fc2")
    return x + _f32(params[f"{n}.ls2.gamma"]) * h


def patch_tokens(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """DINOv2 ViT-L/14 with registers: frames [N, H, W, 3] in [0, 1] → the
    normalised patch tokens [N, h*w, C]."""
    pe = "aggregator.patch_embed"
    mean = torch.tensor(RESNET_MEAN, device=frames.device)
    std = torch.tensor(RESNET_STD, device=frames.device)
    x = ((_f32(frames) - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(x, _f32(params[f"{pe}.patch_embed.proj.weight"]),
                 _f32(params[f"{pe}.patch_embed.proj.bias"]), stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    n, _, c = x.shape
    x = torch.cat([_f32(params[f"{pe}.cls_token"]).expand(n, 1, c), x], dim=1)
    x = x + _f32(params[f"{pe}.pos_embed"])
    registers = _f32(params[f"{pe}.register_tokens"]).expand(n, -1, -1)
    x = torch.cat([x[:, :1], registers, x[:, 1:]], dim=1)
    for i in range(cfg["patch_depth"]):
        x = _block_fwd(x, params, f"{pe}.blocks.{i}", cfg["num_heads"], 1e-6)
    return _layer_norm(x, params, f"{pe}.norm", 1e-6)[:, 1 + cfg["num_register_tokens"]:]


def _special(param: torch.Tensor, n: int) -> torch.Tensor:
    """[1, 2, k, C] → [n, k, C]: slot 0 for frame 0, slot 1 for the rest."""
    t = _f32(param)
    return torch.cat([t[:, :1], t[:, 1:].expand(1, n - 1, *t.shape[2:])], dim=1).reshape(
        n, *t.shape[2:])


def aggregate(params, cfg, frames: torch.Tensor, keep) -> Dict[int, torch.Tensor]:
    """→ {layer i: cat(frame_i, global_i) [N, tokens_per_frame, 2C]} for i in keep."""
    patches = patch_tokens(params, cfg, frames)
    n, _, c = patches.shape
    x = torch.cat([_special(params["aggregator.camera_token"], n),
                   _special(params["aggregator.register_token"], n), patches], dim=1)
    pos = positions(cfg, frames.device)
    window_pos = pos.repeat(n, 1)
    heads, base = cfg["num_heads"], float(cfg["rope_freq"])
    outs = {}
    for i in range(cfg["depth"]):
        x = _block_fwd(x, params, f"aggregator.frame_blocks.{i}", heads, 1e-5, pos, base, True)
        frame = x
        x = _block_fwd(x.reshape(1, -1, c), params, f"aggregator.global_blocks.{i}", heads,
                       1e-5, window_pos, base, True).reshape(n, -1, c)
        if i in keep:
            outs[i] = torch.cat([frame, x], dim=-1)
    return outs


def _sincos(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """make_sincos_pos_embed at omega_0 = 100: [M] → [M, dim] (sin, cos)."""
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    out = pos.to(torch.float64)[:, None] * (1.0 / 100.0 ** omega)[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def uv_embedding(h: int, w: int, channels: int, aspect: float, device) -> torch.Tensor:
    """create_uv_grid + position_grid_to_embed, times the ratio: float32
    [channels, h, w]. The grid spans +-aspect/diag (x) and +-1/diag (y),
    diag = sqrt(aspect^2 + 1), each inset by (n - 1)/n."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, dtype=torch.float64, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, dtype=torch.float64, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")  # [h, w]
    emb = torch.cat([_sincos(channels // 2, uu.reshape(-1)),
                     _sincos(channels // 2, vv.reshape(-1))], dim=1)
    return (UV_RATIO * emb).to(torch.float32).reshape(h, w, channels).permute(2, 0, 1)


def _conv2d(x, params, name, stride=1, padding=0):
    bias = params.get(f"{name}.bias")
    return F.conv2d(x, _f32(params[f"{name}.weight"]), None if bias is None else _f32(bias),
                    stride=stride, padding=padding)


def _resize(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def _rcu(x, params, name):
    """ResidualConvUnit with VGGT's in-place ReLU: the skip adds relu(x)."""
    x = F.relu(x)
    return _conv2d(F.relu(_conv2d(x, params, f"{name}.conv1", padding=1)), params,
                   f"{name}.conv2", padding=1) + x


def _fusion(params, name, x, skip=None, size=None):
    if skip is not None:
        x = x + _rcu(skip, params, f"{name}.resConfUnit1")
    x = _rcu(x, params, f"{name}.resConfUnit2")
    x = _resize(x, size if size is not None else (2 * x.shape[2], 2 * x.shape[3]))
    return _conv2d(x, params, f"{name}.out_conv")


def _dpt(params, name, cfg, outs, rows) -> torch.Tensor:
    """DPTHead over the frames `rows` → the raw map [n, H, W, out_dim]."""
    h, w = grid(cfg)
    size = cfg["img_size"]
    first = 1 + cfg["num_register_tokens"]
    feats = []
    for i, layer in enumerate(cfg["dpt_layers"]):
        x = _layer_norm(outs[layer][rows, first:], params, f"{name}.norm", 1e-5)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
        x = _conv2d(x, params, f"{name}.projects.{i}")
        x = x + uv_embedding(h, w, x.shape[1], 1.0, x.device)
        r = f"{name}.resize_layers.{i}"
        if i < 2:
            x = F.conv_transpose2d(x, _f32(params[f"{r}.weight"]), _f32(params[f"{r}.bias"]),
                                   stride=4 // (i + 1))
        elif i == 3:
            x = _conv2d(x, params, r, stride=2, padding=1)
        feats.append(x)
    s = f"{name}.scratch"
    r1, r2, r3, r4 = (_conv2d(x, params, f"{s}.layer{i}_rn", padding=1)
                      for i, x in enumerate(feats, start=1))
    x = _fusion(params, f"{s}.refinenet4", r4, size=r3.shape[2:])
    x = _fusion(params, f"{s}.refinenet3", x, r3, size=r2.shape[2:])
    x = _fusion(params, f"{s}.refinenet2", x, r2, size=r1.shape[2:])
    x = _fusion(params, f"{s}.refinenet1", x, r1)
    x = _resize(_conv2d(x, params, f"{s}.output_conv1", padding=1), (size, size))
    x = x + uv_embedding(size, size, x.shape[1], 1.0, x.device)
    x = F.relu(_conv2d(x, params, f"{s}.output_conv2.0", padding=1))
    return _conv2d(x, params, f"{s}.output_conv2.2").permute(0, 2, 3, 1)


def dpt_heads(params, cfg, outs) -> Dict[str, torch.Tensor]:
    n = outs[cfg["dpt_layers"][0]].shape[0]
    depth, points = [], []
    for b in range(0, n, HEAD_FRAMES):
        rows = slice(b, b + HEAD_FRAMES)
        depth.append(_dpt(params, "depth_head", cfg, outs, rows))
        points.append(_dpt(params, "point_head", cfg, outs, rows))
    d, p = torch.cat(depth), torch.cat(points)
    xyz = p[..., :3]
    return {"depth": torch.exp(d[..., 0]), "depth_conf": 1.0 + torch.exp(d[..., 1]),
            "world_points": torch.sign(xyz) * torch.expm1(xyz.abs()),
            "world_points_conf": 1.0 + torch.exp(p[..., 3])}


def camera_head(params, cfg, tokens: torch.Tensor) -> List[torch.Tensor]:
    """CameraHead on the last layer's camera tokens [N, 2C] → the activated
    pose encoding [N, 9] of each round."""
    ch, n = "camera_head", tokens.shape[0]
    x = _layer_norm(tokens, params, f"{ch}.token_norm", 1e-5)[None]
    pose, out = None, []
    for _ in range(cfg["camera_iterations"]):
        inp = (_f32(params[f"{ch}.empty_pose_tokens"]).expand(1, n, POSE_DIM)
               if pose is None else pose)
        mod = _linear(F.silu(_linear(inp, params, f"{ch}.embed_pose")), params,
                      f"{ch}.poseLN_modulation.1")
        shift, scale, gate = mod.chunk(3, dim=-1)
        m = gate * (F.layer_norm(x, x.shape[-1:], eps=1e-6) * (1 + scale) + shift) + x
        for i in range(cfg["camera_trunk_depth"]):
            m = _block_fwd(m, params, f"{ch}.trunk.{i}", cfg["camera_num_heads"], 1e-5)
        h = _linear(_layer_norm(m, params, f"{ch}.trunk_norm", 1e-5), params,
                    f"{ch}.pose_branch.fc1")
        delta = _linear(F.gelu(h), params, f"{ch}.pose_branch.fc2")
        pose = delta if pose is None else pose + delta
        out.append(torch.cat([pose[0, :, :7], F.relu(pose[0, :, 7:])], dim=-1))
    return out


def forward(params: Dict[str, torch.Tensor], cfg, frames: torch.Tensor, gemm_dtype=None):
    """frames [N, H, W, 3] in [0, 1] → {depth [N, H, W], depth_conf,
    world_points [N, H, W, 3], world_points_conf, pose_enc [N, 9],
    pose_enc_list (each round's)} in float32. gemm_dtype rounds both
    operands of every Linear product to it (the control)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    token = _GEMM_DTYPE.set(gemm_dtype)
    try:
        with torch.no_grad():
            last = cfg["depth"] - 1
            outs = aggregate(params, cfg, frames, set(cfg["dpt_layers"]) | {last})
            poses = camera_head(params, cfg, outs[last][:, 0])
            return {**dpt_heads(params, cfg, outs), "pose_enc": poses[-1],
                    "pose_enc_list": poses}
    finally:
        _GEMM_DTYPE.reset(token)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
