"""An independent PyTorch restatement of the DUSt3R architecture, the
numeric oracle of cli.parity's --full-gate (the port's own copy of the JAX
package's test oracle, which that gate loads from tests/; the port cannot
load it, since it imports the JAX package).

It is written from the architecture contract, not from the port's modules:
agreement between it and the port's model, layer by layer, on the same
checkpoint is evidence that the checkpoint layout, the RoPE convention, the
qkv packing and the head wiring (linear, DPT, catmlpdpt) are right. Besides
the network it holds the per-layer activation capture of the oracle and of
the port's model (forward hooks on the same names: enc_blocks_i, enc_norm,
decoder_embed, dec_blocks_i, dec_blocks2_i, dec_norm) and their comparison.
Positions and RoPE tables are made on the device of the tokens; the
arithmetic is the test oracle's, so on the CPU the two agree bit for bit.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def rope2d_oracle(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0):
    """tokens: [B, H, S, D]; positions: [S, 2] (y, x)."""

    def rope1d(t, pos1d):
        d = t.size(-1)
        inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, device=t.device).float() / d))
        freqs = torch.einsum("i,j->ij", pos1d.float(), inv_freq)
        freqs = torch.cat((freqs, freqs), dim=-1)  # [S, d]
        cos, sin = freqs.cos(), freqs.sin()
        t1, t2 = t[..., : d // 2], t[..., d // 2:]
        rotated = torch.cat((-t2, t1), dim=-1)
        return t * cos + rotated * sin

    d = tokens.size(-1) // 2
    y, x = tokens[..., :d], tokens[..., d:]
    y = rope1d(y, positions[:, 0])
    x = rope1d(x, positions[:, 1])
    return torch.cat((y, x), dim=-1)


@contextlib.contextmanager
def exact_float32():
    """IEEE float32 matmuls and convs from torch on the card (no TF32)
    inside the block; both settings restored after. The port's own float32
    attention kernels (K2-K6 at every head dim, kernels/flash_attention.py)
    run 3xTF32 on the tensor cores whatever these settings say: each
    operand split into tf32 hi and lo, each product hi*hi + hi*lo + lo*hi
    in float32, so their products are not IEEE float32 ones (about 2^-21
    relative a product)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    previous = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = previous


class TorchAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, x, pos):
        b, s, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = rope2d_oracle(q, pos)
        k = rope2d_oracle(k, pos)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        out = attn.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(b, s, c))


class TorchCrossAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, x, key, value, xpos, ypos):
        b, sq, c = x.shape
        sk = key.shape[1]
        hd = c // self.heads
        q = self.projq(x).reshape(b, sq, self.heads, hd).transpose(1, 2)
        k = self.projk(key).reshape(b, sk, self.heads, hd).transpose(1, 2)
        v = self.projv(value).reshape(b, sk, self.heads, hd).transpose(1, 2)
        q = rope2d_oracle(q, xpos)
        k = rope2d_oracle(k, ypos)
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        out = attn.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(b, sq, c))


class TorchMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class TorchEncBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TorchAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = TorchMlp(dim, int(dim * mlp_ratio))

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class TorchDecBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = TorchAttention(dim, heads)
        self.cross_attn = TorchCrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.norm_y = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = TorchMlp(dim, int(dim * mlp_ratio))

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))


class _TorchRCU(nn.Module):
    """MiDaS ResidualConvUnit_custom (bn=False): x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, fd):
        super().__init__()
        self.conv1 = nn.Conv2d(fd, fd, 3, padding=1)
        self.conv2 = nn.Conv2d(fd, fd, 3, padding=1)

    def forward(self, x):
        r = F.relu(x)
        r = self.conv1(r)
        r = F.relu(r)
        r = self.conv2(r)
        return r + x


class _TorchFusion(nn.Module):
    """MiDaS FeatureFusionBlock_custom (deconv/bn/expand False,
    align_corners=True)."""

    def __init__(self, fd):
        super().__init__()
        self.resConfUnit1 = _TorchRCU(fd)
        self.resConfUnit2 = _TorchRCU(fd)
        self.out_conv = nn.Conv2d(fd, fd, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        return self.out_conv(x)


class _TorchScratch(nn.Module):
    def __init__(self, fd, dims):
        super().__init__()
        self.layer1_rn = nn.Conv2d(dims[0], fd, 3, padding=1, bias=False)
        self.layer2_rn = nn.Conv2d(dims[1], fd, 3, padding=1, bias=False)
        self.layer3_rn = nn.Conv2d(dims[2], fd, 3, padding=1, bias=False)
        self.layer4_rn = nn.Conv2d(dims[3], fd, 3, padding=1, bias=False)
        self.refinenet1 = _TorchFusion(fd)
        self.refinenet2 = _TorchFusion(fd)
        self.refinenet3 = _TorchFusion(fd)
        self.refinenet4 = _TorchFusion(fd)


class _TorchDPTCore(nn.Module):
    """croco DPTOutputAdapter: act_postprocess pyramid + scratch fusion +
    output head. State-dict keys match released_checkpoint layout
    (convert/torch_to_flax.py::expected_torch_keys)."""

    def __init__(self, hc, enc_dim, dec_dim):
        super().__init__()
        dims = hc.dpt_layer_dims
        fd = hc.feature_dim
        hooks_dims = (enc_dim, dec_dim, dec_dim, dec_dim)
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(hooks_dims[0], dims[0], 1),
                          nn.ConvTranspose2d(dims[0], dims[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(hooks_dims[1], dims[1], 1),
                          nn.ConvTranspose2d(dims[1], dims[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(hooks_dims[2], dims[2], 1)),
            nn.Sequential(nn.Conv2d(hooks_dims[3], dims[3], 1),
                          nn.Conv2d(dims[3], dims[3], 3, stride=2, padding=1)),
        ])
        self.scratch = _TorchScratch(fd, dims)
        self.head = nn.Sequential(
            nn.Conv2d(fd, fd // 2, 3, padding=1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(fd // 2, hc.last_dim, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(hc.last_dim, 4, 1),
        )

    def forward(self, hooked, grid):
        h, w = grid
        maps = [t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)
                for t in hooked]
        l1, l2, l3, l4 = (self.act_postprocess[i](maps[i]) for i in range(4))
        r1 = self.scratch.layer1_rn(l1)
        r2 = self.scratch.layer2_rn(l2)
        r3 = self.scratch.layer3_rn(l3)
        r4 = self.scratch.layer4_rn(l4)
        p4 = self.scratch.refinenet4(r4)
        p3 = self.scratch.refinenet3(p4, r3)
        p2 = self.scratch.refinenet2(p3, r2)
        p1 = self.scratch.refinenet1(p2, r1)
        return self.head(p1)  # [B, 4, H, W]


def _reg_pts_conf(fmap_bhwc):
    xyz, conf = fmap_bhwc[..., :3], fmap_bhwc[..., 3]
    n = xyz.norm(dim=-1, keepdim=True)
    pts = xyz / n.clamp(min=1e-8) * torch.expm1(n)
    return pts, 1 + conf.exp()


class _TorchDPTHead(nn.Module):
    """dust3r PixelwiseTaskWithDPT: DPT core → (pts3d, conf)."""

    def __init__(self, hc, enc_dim, dec_dim):
        super().__init__()
        self.dpt = _TorchDPTCore(hc, enc_dim, dec_dim)

    def forward(self, hooked, grid):
        fmap = self.dpt(hooked, grid).permute(0, 2, 3, 1)
        pts, conf = _reg_pts_conf(fmap)
        return {"pts3d": pts, "conf": conf}


class _TorchLocalFeatMLP(nn.Module):
    def __init__(self, idim, hid, nout):
        super().__init__()
        self.fc1 = nn.Linear(idim, hid)
        self.fc2 = nn.Linear(hid, nout)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) gelu


class _TorchCatMLPDPTHead(nn.Module):
    """mast3r Cat_MLP_LocalFeatures_DPT_Pts3d: DPT pts3d/conf branch + MLP
    local-feature branch over cat(enc_out, dec_out) tokens."""

    def __init__(self, hc, enc_dim, dec_dim, patch_size):
        super().__init__()
        self.hc = hc
        self.p = patch_size
        self.dpt = _TorchDPTCore(hc, enc_dim, dec_dim)
        idim = enc_dim + dec_dim
        hid = int(hc.desc_hidden_dim_factor * idim)
        nout = (hc.local_feat_dim + int(hc.two_confs)) * patch_size ** 2
        self.head_local_features = _TorchLocalFeatMLP(idim, hid, nout)

    def forward(self, hooked, grid, enc_tok, dec_tok):
        h, w = grid
        fmap = self.dpt(hooked, grid).permute(0, 2, 3, 1)
        pts, conf = _reg_pts_conf(fmap)
        out = {"pts3d": pts, "conf": conf}
        x = self.head_local_features(torch.cat([enc_tok, dec_tok], dim=-1))
        b = x.shape[0]
        feat = x.transpose(-1, -2).view(b, -1, h, w)
        feat = F.pixel_shuffle(feat, self.p).permute(0, 2, 3, 1)
        ldim = self.hc.local_feat_dim
        desc = feat[..., :ldim]
        out["desc"] = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        if self.hc.two_confs:
            # desc_conf_mode ('exp', 0, inf): vmin + exp(x) with vmin = 0
            # (unlike pts conf whose vmin is 1)
            vmin = self.hc.desc_conf_mode[1]
            out["desc_conf"] = vmin + feat[..., ldim].exp()
        return out


class OracleDustr(nn.Module):
    """Independent restatement of AsymmetricCroCo3DStereo: linear
    head (the DUSt3R-224 training/serving config, thermal_dustr_model.py:34-47),
    DPT head, and the MASt3R catmlpdpt metric head (the pseudo-GT model,
    scripts/pseudo_gt.py:17-34)."""

    def __init__(self, cfg):
        super().__init__()
        e, d, p = cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.ModuleDict(
            {"proj": nn.Conv2d(3, e, kernel_size=p, stride=p)})
        self.enc_blocks = nn.ModuleList(
            [TorchEncBlock(e, cfg.enc_num_heads, cfg.mlp_ratio)
             for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(e, eps=1e-6)
        self.decoder_embed = nn.Linear(e, d)
        self.dec_blocks = nn.ModuleList(
            [TorchDecBlock(d, cfg.dec_num_heads, cfg.mlp_ratio)
             for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [TorchDecBlock(d, cfg.dec_num_heads, cfg.mlp_ratio)
             for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(d, eps=1e-6)
        ht = cfg.head.head_type
        if ht == "linear":
            self.downstream_head1 = nn.ModuleDict(
                {"proj": nn.Linear(d, 4 * p * p)})
            self.downstream_head2 = nn.ModuleDict(
                {"proj": nn.Linear(d, 4 * p * p)})
        elif ht == "dpt":
            self.downstream_head1 = _TorchDPTHead(cfg.head, e, d)
            self.downstream_head2 = _TorchDPTHead(cfg.head, e, d)
        elif ht == "catmlpdpt":
            self.downstream_head1 = _TorchCatMLPDPTHead(cfg.head, e, d, p)
            self.downstream_head2 = _TorchCatMLPDPTHead(cfg.head, e, d, p)
        else:
            raise NotImplementedError(ht)

    def _positions(self, h, w, device):
        return torch.cartesian_prod(torch.arange(h, device=device),
                                    torch.arange(w, device=device))

    def _encode(self, img):
        x = self.patch_embed["proj"](img)  # [B, E, h, w]
        b, e, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = self._positions(h, w, x.device)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos, (h, w)

    def _head(self, head, tokens, grid):
        b, s, _ = tokens.shape
        h, w = grid
        p = self.cfg.patch_size
        feat = head["proj"](tokens)
        feat = feat.transpose(-1, -2).view(b, -1, h, w)
        feat = F.pixel_shuffle(feat, p)  # [B, 4, H, W]
        fmap = feat.permute(0, 2, 3, 1)
        xyz, conf = fmap[..., :3], fmap[..., 3]
        n = xyz.norm(dim=-1, keepdim=True)
        pts = xyz / n.clamp(min=1e-8) * torch.expm1(n)
        return pts, 1 + conf.exp()

    def forward(self, img1, img2):
        b = img1.shape[0]
        feats, pos, grid = self._encode(torch.cat([img1, img2], dim=0))
        f1, f2 = feats[:b], feats[b:]
        outs1, outs2 = [f1], [f2]
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            nx1 = blk1(x1, x2, pos, pos)
            nx2 = blk2(x2, x1, pos, pos)
            x1, x2 = nx1, nx2
            outs1.append(x1)
            outs2.append(x2)
        outs1[-1] = self.dec_norm(outs1[-1])
        outs2[-1] = self.dec_norm(outs2[-1])
        ht = self.cfg.head.head_type
        if ht == "linear":
            pts1, conf1 = self._head(self.downstream_head1, outs1[-1], grid)
            pts2, conf2 = self._head(self.downstream_head2, outs2[-1], grid)
            return (pts1, conf1), (pts2, conf2)
        # dust3r create_dpt_head hooks: [0, 2L/4, 3L/4, L] into
        # [encoder_out, dec_1..dec_L] (models/heads.py::dpt_hook_indices)
        L = self.cfg.dec_depth
        hooks = (0, L * 2 // 4, L * 3 // 4, L)
        h1 = [outs1[i] for i in hooks]
        h2 = [outs2[i] for i in hooks]
        if ht == "dpt":
            return self.downstream_head1(h1, grid), self.downstream_head2(h2, grid)
        return (self.downstream_head1(h1, grid, outs1[0], outs1[-1]),
                self.downstream_head2(h2, grid, outs2[0], outs2[-1]))


# ---------------------------------------------------------------------------
# Per-layer activation capture + comparison
# ---------------------------------------------------------------------------

def _hooked(named_modules, run):
    """run() with a forward hook on each (name, module) recording its outputs
    as float32 numpy arrays, one per call; returns (acts, run's result)."""
    acts: dict = {}

    def hook(name):
        def fn(_mod, _inp, out):
            acts.setdefault(name, []).append(out.detach().float().cpu().numpy())
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in named_modules]
    try:
        with torch.no_grad():
            out = run()
    finally:
        for h in handles:
            h.remove()
    return acts, out


def _trunk_modules(model):
    """(hook name, module) of the blocks and norms, in the JAX module names."""
    mods = [(f"enc_blocks_{i}", b) for i, b in enumerate(model.enc_blocks)]
    mods += [("enc_norm", model.enc_norm), ("decoder_embed", model.decoder_embed)]
    mods += [(f"dec_blocks_{i}", b) for i, b in enumerate(model.dec_blocks)]
    mods += [(f"dec_blocks2_{i}", b) for i, b in enumerate(model.dec_blocks2)]
    return mods + [("dec_norm", model.dec_norm)]


def capture_oracle_activations(oracle: OracleDustr, img1, img2):
    """Run the oracle on NHWC numpy images, hooking every block and norm;
    returns ({name: [numpy array per call]}, outputs)."""
    dev = next(oracle.parameters()).device

    def run():
        return oracle(torch.from_numpy(img1.transpose(0, 3, 1, 2)).to(dev),
                      torch.from_numpy(img2.transpose(0, 3, 1, 2)).to(dev))

    return _hooked(_trunk_modules(oracle), run)


def capture_model_activations(model, img1, img2):
    """The same capture on the port's AsymmetricCroCo3DStereo (NHWC input);
    returns ({name: [numpy array per call]}, (pred1, pred2))."""
    dev = next(model.parameters()).device
    return _hooked(_trunk_modules(model),
                   lambda: model(torch.from_numpy(img1).to(dev), torch.from_numpy(img2).to(dev)))


def per_layer_drift(oracle_acts, model_acts):
    """{layer: (max_abs_delta, activation_scale)} over matching call indices.

    Both models encode the two views in one batched pass, so arrays align
    directly; modules called twice (decoder_embed, dec_norm) compare call
    by call."""
    rows = {}
    for name, t_calls in sorted(oracle_acts.items()):
        f_calls = model_acts.get(name)
        if f_calls is None:
            continue
        deltas, scales = [], []
        for t, f in zip(t_calls, f_calls):
            if t.shape != f.shape:
                continue
            deltas.append(float(np.abs(t - f).max()))
            scales.append(float(np.abs(t).max()))
        if deltas:
            rows[name] = (max(deltas), max(scales))
    return rows
