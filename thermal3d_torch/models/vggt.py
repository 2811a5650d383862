"""VGGT (Visual Geometry Grounded Transformer; Wang et al., CVPR 2025) without
its track head: a window of N frames of one scene in one pass to each
frame's depth, world points (in frame 0's camera), their confidences and a
9-number camera.

  * `aggregator.patch_embed`, the DINOv2 ViT-L/14 trunk with 4 registers:
    ResNet mean/std, the 14x14 patch conv, cat(cls, patches) + a learned
    position embedding, cat(cls, registers, patches), pre-norm blocks
    (LayerNorm eps 1e-6, plain attention through K4 on strided views of the
    packed qkv, exact GELU, LayerScale on both residuals), a final norm;
  * the aggregator: a frame's tokens are cat(camera token, registers,
    patches) (frame 0 takes slot 0 of the camera and register parameters,
    every later frame slot 1), then pairs of a frame block, attention
    within each frame ([N, S, 3C] into K2), and a global block, attention
    over the window ([1, N*S, 3C] into K2 with the frame's RoPE tables
    tiled N times). Their attention normalises q and k by a LayerNorm over
    the head dim, written into the packed qkv before K2 ropes them (an
    eager pass), with the patches at RoPE positions (y + 1, x + 1) and the
    special tokens at (0, 0); LayerNorm eps 1e-5. Only the layers the heads
    read are kept, each cat(frame_i, global_i);
  * two DPT heads (`DPTHead`) on the layers `dpt_layers`, in float32 with
    TF32 convolutions as published, over DPT_FRAMES frames at a time: depth
    exp and 1 + exp, points sign * expm1(|x|) and 1 + exp, a sinusoidal UV
    embedding (ratio 0.1) after each projection and before the last convs,
    fusion blocks resizing bilinearly (align_corners=True) to the next
    skip's size, `output_conv1` at 8x the grid resized to the image; the
    fusion blocks' ReLU runs in place as published, so each residual conv
    unit adds relu(x);
  * the camera head on the last layer's camera tokens: token_norm, then
    `camera_iterations` rounds of adaLN modulation by the embedded pose,
    `camera_trunk_depth` blocks (K4 at head dim 128 over the window's N
    tokens), trunk_norm and an MLP to 9 deltas summed over the rounds, in
    float32 as published; the fields of view through ReLU.

Module and parameter names follow the published checkpoint
(`aggregator.patch_embed.*`, `aggregator.frame_blocks.{i}.*`,
`aggregator.global_blocks.{i}.*`, `aggregator.camera_token`,
`aggregator.register_token`, `camera_head.*`, `depth_head.*`,
`point_head.*`), so its state dict, without the track head's, loads
strictly. Weights are stored in any dtype. The trunk's products and
attention compute in the config's dtype; the residual stream, the DPT heads
and the camera head stay float32, as in the published inference (its trunk
under bfloat16 autocast, its heads outside it).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from thermal3d_torch.core.config import VGGTConfig
from thermal3d_torch.core.profiling import annotate
from thermal3d_torch.kernels.flash_attention import attention_bshd, fused_rope_attention
from thermal3d_torch.models.dustr import PARAMS_DTYPES
from thermal3d_torch.models.layers import Dense, LayerNorm, PatchEmbed, Rope
from thermal3d_torch.models.rope import make_grid_positions, rope_tables

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
GLOBAL_ATTENTION_SPAN = "vggt.global_attention"


class LayerScale(nn.Module):
    """A residual branch scaled by gamma and added to the stream, x + gamma *
    branch, in one pass and in float32: the residual stream stays float32
    whatever the compute dtype, as the published inference keeps it (the
    trunk under bfloat16 autocast adds each bfloat16 branch to a float32
    stream), so 144 additions do not each round it to bfloat16."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x, branch):
        return torch.addcmul(x.to(torch.float32), branch, self.gamma)


class Mlp(nn.Module):
    """fc1, exact (erf) GELU, fc2."""

    def __init__(self, dim: int, hidden: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, out_dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def qk_norm_(qkv: torch.Tensor, q_norm: LayerNorm, k_norm: LayerNorm, num_heads: int) -> None:
    """Normalise each head's lanes of q and k of the packed [B, S, 3C] qkv in
    place, so that K2, which ropes q and k itself, reads them normalised."""
    c = qkv.shape[-1] // 3
    for i, norm in enumerate((q_norm, k_norm)):
        part = qkv[..., i * c:(i + 1) * c].unflatten(-1, (num_heads, c // num_heads))
        part.copy_(norm(part))


class Attention(nn.Module):
    """Self-attention on the packed qkv: with a Rope, QK-norm (where built)
    and K2; without one, K4 on strided views of q, k and v."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, qk_norm: bool,
                 eps: float = 1e-5):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype)
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads, dtype, eps)
            self.k_norm = LayerNorm(dim // num_heads, dtype, eps)
        self.proj = Dense(dim, dim, dtype)
        self.num_heads = num_heads
        self.scale = 1.0 / math.sqrt(dim // num_heads)
        self.span: Optional[str] = None  # a span around the K2 call (global blocks)

    def forward(self, x, rope: Optional[Rope] = None):
        qkv = self.qkv(x)
        b, s, three_c = qkv.shape
        if rope is None:
            q, k, v = qkv.view(b, s, 3, self.num_heads, -1).unbind(2)
            out = attention_bshd(q, k, v, scale=self.scale, impl="pallas")
            return self.proj(out.reshape(b, s, three_c // 3))
        if hasattr(self, "q_norm"):
            qk_norm_(qkv, self.q_norm, self.k_norm, self.num_heads)
        span = (annotate(self.span, qkv.device) if self.span is not None
                else contextlib.nullcontext())
        with span:
            out = fused_rope_attention(qkv, rope.cos, rope.sin, self.num_heads, self.scale)
        return self.proj(out)


class Block(nn.Module):
    """x += ls1 * attn(norm1(x)); x += ls2 * mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype,
                 qk_norm: bool, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype, eps)
        self.attn = Attention(dim, num_heads, dtype, qk_norm, eps)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, dtype, eps)
        hidden = int(dim * mlp_ratio)
        self.mlp = Mlp(dim, hidden, dim, dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x, rope: Optional[Rope] = None):
        x = self.ls1(x, self.attn(self.norm1(x), rope))
        return self.ls2(x, self.mlp(self.norm2(x)))


class PatchTrunk(nn.Module):
    """DINOv2 ViT-L/14 with registers (`aggregator.patch_embed`): normalised
    NHWC frames → the normalised patch tokens [N, h*w, C] and the grid. The
    mask token is held, as the checkpoint has it, and never read."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        c, dt = cfg.embed_dim, cfg.dtype
        h, w = cfg.patch_grid
        self.cls_token = nn.Parameter(torch.empty(1, 1, c))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + h * w, c))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_register_tokens, c))
        self.mask_token = nn.Parameter(torch.empty(1, c))
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, c, dt)
        self.blocks = nn.ModuleList(
            Block(c, cfg.num_heads, cfg.mlp_ratio, dt, qk_norm=False, eps=1e-6)
            for _ in range(cfg.patch_depth))
        self.norm = LayerNorm(c, dt, 1e-6)

    def forward(self, images):
        x, grid = self.patch_embed(images)
        n, _, c = x.shape
        f32 = torch.float32
        x = torch.cat([self.cls_token.to(f32).expand(n, 1, c), x.to(f32)], dim=1)
        x = x + self.pos_embed.to(f32)
        x = torch.cat([x[:, :1], self.register_tokens.to(f32).expand(n, -1, -1), x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:], grid


def special_tokens(param: torch.Tensor, n: int) -> torch.Tensor:
    """A [1, 2, k, C] parameter → [n, k, C] float32: slot 0 for frame 0, slot
    1 for every later frame."""
    t = param.to(torch.float32)
    return torch.cat([t[:, :1], t[:, 1:].expand(1, n - 1, *t.shape[2:])], dim=1).reshape(
        n, *t.shape[2:])


def frame_positions(grid: Tuple[int, int], specials: int, device) -> torch.Tensor:
    """int64 [specials + h*w, 2] (y, x) RoPE positions of a frame's tokens:
    the special tokens at (0, 0), the patches at (y + 1, x + 1)."""
    return torch.cat([torch.zeros(specials, 2, dtype=torch.int64, device=device),
                      make_grid_positions(*grid, device=device) + 1])


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        c, dt = cfg.embed_dim, cfg.dtype
        self.config = cfg
        self.patch_embed = PatchTrunk(cfg)
        self.frame_blocks = nn.ModuleList(
            Block(c, cfg.num_heads, cfg.mlp_ratio, dt, qk_norm=True, eps=1e-5)
            for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(
            Block(c, cfg.num_heads, cfg.mlp_ratio, dt, qk_norm=True, eps=1e-5)
            for _ in range(cfg.depth))
        for blk in self.global_blocks:
            blk.attn.span = GLOBAL_ATTENTION_SPAN
        self.camera_token = nn.Parameter(torch.empty(1, 2, 1, c))
        self.register_token = nn.Parameter(torch.empty(1, 2, cfg.num_register_tokens, c))
        self._tables: Dict[tuple, Tuple[Rope, Rope]] = {}
        self._mean_std: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, grid: Tuple[int, int], n: int, device) -> Tuple[Rope, Rope]:
        """(frame, window) RoPE tables of an n-frame window, cached per (grid,
        n, device): the frame's [S, head_dim], and the frame's tiled n times
        [n*S, head_dim] for the global blocks."""
        key = (tuple(grid), n, str(device))
        if key not in self._tables:
            cfg = self.config
            pos = frame_positions(grid, cfg.special_tokens, device)
            cos, sin = rope_tables(pos, cfg.embed_dim // cfg.num_heads, cfg.rope_base)
            frame = Rope(cos, sin, pos, cfg.rope_base)
            window = Rope(cos.repeat(n, 1), sin.repeat(n, 1), pos.repeat(n, 1), cfg.rope_base)
            self._tables[key] = frame, window
        return self._tables[key]

    def forward(self, images: torch.Tensor, keep: Iterable[int]) -> Dict[int, torch.Tensor]:
        """images [N, H, W, 3] in [0, 1] → {layer i: cat(frame_i, global_i)
        [N, S, 2C]} for each i in keep."""
        keep = set(keep)
        with annotate("vggt.patch_embed", images.device):
            key = str(images.device)
            if key not in self._mean_std:  # made once: a host copy would wait
                self._mean_std[key] = (torch.tensor(RESNET_MEAN, device=images.device),
                                       torch.tensor(RESNET_STD, device=images.device))
            mean, std = self._mean_std[key]
            patches, grid = self.patch_embed((images.to(torch.float32) - mean) / std)
        n, _, c = patches.shape
        with annotate("vggt.aggregator", images.device):
            x = torch.cat([special_tokens(self.camera_token, n),
                           special_tokens(self.register_token, n), patches.to(torch.float32)],
                          dim=1)
            frame_rope, window_rope = self.rope(grid, n, images.device)
            outs = {}
            for i, (fb, gb) in enumerate(zip(self.frame_blocks, self.global_blocks)):
                frame = fb(x, frame_rope)
                x = gb(frame.reshape(1, -1, c), window_rope).view_as(frame)
                if i in keep:
                    outs[i] = torch.cat([frame, x], dim=-1)
            return outs


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

POSE_DIM = 9  # translation, quaternion, two fields of view
DPT_LAST = 32  # output_conv2's hidden channels
UV_RATIO = 0.1
# frames a DPT head pass takes: frames_chunk_size as published (all 24 of a
# window in one pass ran no faster on an H100, for twice the memory peak)
DPT_FRAMES = 8


def _sincos(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """make_sincos_pos_embed at omega_0 = 100: [M] → [M, dim] (sin, cos)."""
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    out = pos.to(torch.float64)[:, None] * (1.0 / 100.0 ** omega)[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def uv_embedding(h: int, w: int, channels: int, device, aspect: float = 1.0) -> torch.Tensor:
    """The DPT head's position embedding, times its ratio: float32
    [1, channels, h, w] of sin/cos of a UV grid spanning +-aspect/diag in x
    and +-1/diag in y (diag = sqrt(aspect^2 + 1)), each inset by (n - 1)/n;
    x takes the first half of the channels."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, dtype=torch.float64, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, dtype=torch.float64, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")  # [h, w]
    emb = torch.cat([_sincos(channels // 2, uu.reshape(-1)),
                     _sincos(channels // 2, vv.reshape(-1))], dim=1)
    return (UV_RATIO * emb).to(torch.float32).reshape(h, w, channels).permute(2, 0, 1)[None]


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, align_corners=True."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


@contextlib.contextmanager
def tf32_convs():
    """cuDNN runs float32 convolutions in TF32 on the tensor cores inside the
    block (torch's default, under which the published heads run in float32;
    the port's other float32 convolutions are IEEE, core/device.py::
    exact_float32_convs); the setting before it is restored after."""
    cudnn = torch.backends.cudnn
    previous = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32 = previous


class HeadConv(nn.Conv2d):
    """A DPT head's convolution, float32 from weights stored in any dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(torch.float32)
        return self._conv_forward(x, self.weight.to(torch.float32), bias)


class HeadConvT(nn.ConvTranspose2d):
    """A DPT head's non-overlapping transposed convolution (kernel = stride),
    float32."""

    def __init__(self, channels: int, factor: int):
        super().__init__(channels, channels, factor, stride=factor)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(torch.float32),
                                  self.bias.to(torch.float32), stride=self.stride)


class _ResidualUnit(nn.Module):
    """ResidualConvUnit with VGGT's in-place ReLU (nn.ReLU(inplace=True) in
    the published head): the skip adds relu(x), not x."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = HeadConv(features, features, 3, padding=1)
        self.conv2 = HeadConv(features, features, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class _Fusion(nn.Module):
    """FeatureFusionBlock: (x + rcu1(skip)), rcu2, a bilinear resize to
    `size` (x2 without one), out_conv. The block without a skip
    (refinenet4) has no resConfUnit1."""

    def __init__(self, features: int, has_skip: bool):
        super().__init__()
        self.out_conv = HeadConv(features, features, 1)
        if has_skip:
            self.resConfUnit1 = _ResidualUnit(features)
        self.resConfUnit2 = _ResidualUnit(features)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(_resize(x, size or (2 * x.shape[2], 2 * x.shape[3])))


class DPTHead(nn.Module):
    """vggt.heads.DPTHead over the aggregator's layers `dpt_layers` → the
    raw map [N, H, W, out_dim], DPT_FRAMES frames a pass. In float32 with
    TF32 convolutions whatever the compute dtype, as published (the heads
    run outside the trunk's autocast): in bfloat16 their rounding alone put
    the world points 3-5x further from the float32 reference."""

    def __init__(self, cfg: VGGTConfig, out_dim: int):
        super().__init__()
        dim, oc, fd = 2 * cfg.embed_dim, cfg.dpt_out_channels, cfg.dpt_features
        self.config = cfg
        self.norm = LayerNorm(dim, torch.float32, 1e-5)
        self.projects = nn.ModuleList(HeadConv(dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            HeadConvT(oc[0], 4), HeadConvT(oc[1], 2), nn.Identity(),
            HeadConv(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = nn.Module()
        for i, c in enumerate(oc, start=1):
            setattr(self.scratch, f"layer{i}_rn", HeadConv(c, fd, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}", _Fusion(fd, has_skip=i < 4))
        self.scratch.output_conv1 = HeadConv(fd, fd // 2, 3, padding=1)
        self.scratch.output_conv2 = nn.Sequential(
            HeadConv(fd // 2, DPT_LAST, 3, padding=1), nn.ReLU(), HeadConv(DPT_LAST, out_dim, 1))
        self._uv: Dict[tuple, torch.Tensor] = {}

    def _add_uv(self, x: torch.Tensor) -> torch.Tensor:
        key = (*x.shape[1:], str(x.device))
        if key not in self._uv:
            self._uv[key] = uv_embedding(x.shape[2], x.shape[3], x.shape[1], x.device)
        return x + self._uv[key]

    def _pass(self, outs: Dict[int, torch.Tensor], rows: slice, image_hw) -> torch.Tensor:
        cfg, sc = self.config, self.scratch
        h, w = cfg.patch_grid
        feats = []
        for proj, resize, layer in zip(self.projects, self.resize_layers, cfg.dpt_layers):
            x = self.norm(outs[layer][rows, cfg.special_tokens:])  # [n, h*w, 2C]
            x = x.transpose(1, 2).unflatten(-1, (h, w))  # NCHW in channels-last memory
            feats.append(resize(self._add_uv(proj(x))))
        r1, r2, r3, r4 = (rn(x) for rn, x in zip(
            (sc.layer1_rn, sc.layer2_rn, sc.layer3_rn, sc.layer4_rn), feats))
        x = sc.refinenet4(r4, size=r3.shape[2:])
        x = sc.refinenet3(x, r3, size=r2.shape[2:])
        x = sc.refinenet2(x, r2, size=r1.shape[2:])
        x = sc.refinenet1(x, r1)
        x = self._add_uv(_resize(sc.output_conv1(x), image_hw))
        return sc.output_conv2(x).permute(0, 2, 3, 1)

    def forward(self, outs: Dict[int, torch.Tensor], image_hw) -> torch.Tensor:
        n = outs[self.config.dpt_layers[0]].shape[0]
        with tf32_convs():
            return torch.cat([self._pass(outs, slice(i, i + DPT_FRAMES), image_hw)
                              for i in range(0, n, DPT_FRAMES)])


def activate_depth(raw: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"depth": torch.exp(raw[..., 0]), "depth_conf": 1.0 + torch.exp(raw[..., 1])}


def activate_points(raw: torch.Tensor) -> Dict[str, torch.Tensor]:
    xyz = raw[..., :3]
    return {"world_points": torch.sign(xyz) * torch.expm1(xyz.abs()),
            "world_points_conf": 1.0 + torch.exp(raw[..., 3])}


class CameraHead(nn.Module):
    """vggt.heads.CameraHead: the last layer's camera tokens [N, 2C] → the
    activated pose encoding [N, 9] (float32) of each of the
    `camera_iterations` rounds. A round modulates the normalised tokens by
    the embedded pose so far (adaLN: shift, scale, gate), runs the trunk's
    blocks over the window's N tokens, and adds the MLP's deltas. In float32
    whatever the compute dtype, as published (the heads run outside the
    trunk's autocast): IEEE float32 products, and K4 at head dim 128 on its
    3xTF32 kernel."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        dim, dt = 2 * cfg.embed_dim, torch.float32
        self.iterations = cfg.camera_iterations
        self.trunk = nn.ModuleList(
            Block(dim, cfg.camera_num_heads, cfg.mlp_ratio, dt, qk_norm=False, eps=1e-5)
            for _ in range(cfg.camera_trunk_depth))
        self.token_norm = LayerNorm(dim, dt, 1e-5)
        self.trunk_norm = LayerNorm(dim, dt, 1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.empty(1, 1, POSE_DIM))
        self.embed_pose = Dense(POSE_DIM, dim, dt)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), Dense(dim, 3 * dim, dt))
        self.pose_branch = Mlp(dim, dim // 2, POSE_DIM, dt)

    def forward(self, tokens: torch.Tensor):
        x = self.token_norm(tokens)[None]  # [1, N, 2C]: the window is one batch item
        pose, out = None, []
        for _ in range(self.iterations):
            inp = self.empty_pose_tokens.expand(1, x.shape[1], -1) if pose is None else pose
            shift, scale, gate = self.poseLN_modulation(self.embed_pose(inp)).chunk(3, dim=-1)
            m = gate * (F.layer_norm(x, x.shape[-1:], eps=1e-6) * (1 + scale) + shift) + x
            for blk in self.trunk:
                m = blk(m)
            delta = self.pose_branch(self.trunk_norm(m))
            pose = delta if pose is None else pose + delta
            out.append(torch.cat([pose[0, :, :7], F.relu(pose[0, :, 7:])], dim=-1))
        return out


class VGGT(nn.Module):
    """images [N, H, W, 3] in [0, 1] → {depth [N, H, W], depth_conf,
    world_points [N, H, W, 3], world_points_conf, pose_enc [N, 9]}, float32."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.config = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DPTHead(cfg, 2)
        self.point_head = DPTHead(cfg, 4)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg, dev = self.config, images.device
        last = cfg.depth - 1
        outs = self.aggregator(images, set(cfg.dpt_layers) | {last})
        with annotate("vggt.heads", dev):
            with annotate("vggt.depth_head", dev):
                depth = activate_depth(self.depth_head(outs, images.shape[1:3]))
            with annotate("vggt.point_head", dev):
                points = activate_points(self.point_head(outs, images.shape[1:3]))
            with annotate("vggt.camera_head", dev):
                pose = self.camera_head(outs[last][:, 0])[-1]
        return {**depth, **points, "pose_enc": pose}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: every tensor of two or more axes normal with
        std 1/sqrt(fan_in), biases 0, other vectors (norm and LayerScale) 1."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                noise = torch.randn(p.shape, generator=generator, device=generator.device)
                p.copy_(noise / math.sqrt(math.prod(p.shape[1:])))


def frozen_vggt(config: VGGTConfig, device: torch.device,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                params_dtype: Optional[str] = None) -> VGGT:
    """The model on `device` for inference (eval mode, no gradients), with
    `state_dict` loaded strictly or, without one, seeded random weights;
    params_dtype 'bfloat16' stores every weight in bf16, None keeps float32."""
    if params_dtype is not None and params_dtype not in PARAMS_DTYPES:
        raise ValueError(f"params_dtype {params_dtype!r} not in {tuple(PARAMS_DTYPES)}")
    model = VGGT(config).to(device)
    if state_dict is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model.init_weights(gen)
    else:
        model.load_state_dict(state_dict, strict=True)
    if params_dtype is not None:
        model.to(PARAMS_DTYPES[params_dtype])
    return model.eval().requires_grad_(False)
