"""AsymmetricCroCo3DStereo — the DUSt3R/MASt3R two-view pointmap network
(counterpart of thermal3d/models/dustr.py), unrolled layout (a JAX tree in the
scan or branch layout is unstacked by convert.from_jax); linear, DPT and
catmlpdpt heads.

I/O contract:
  model(img1, img2=None) -> (pred1, pred2), images NHWC [B, H, W, 3] in [0, 1]
  pred1 = {"pts3d": [B,H,W,3], "conf": [B,H,W]}
  pred2 = {"pts3d_in_other_view": [B,H,W,3], "conf": [B,H,W]}
catmlpdpt adds "desc" [B,H,W,local_feat_dim] and "desc_conf" [B,H,W] to both.
img2=None is the monocular mode: view 2 is view 1, so the encoder runs once.
With config.remat each encoder and decoder block is recomputed in the
backward pass (torch.utils.checkpoint), so its kernels launch twice a step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from thermal3d_torch.core.config import DustrModelConfig
from thermal3d_torch.models.heads import (CatMLPDPTHead, DPTPts3dHead, LinearPts3dHead,
                                          dpt_hook_indices)
from thermal3d_torch.models.layers import (Dense, DecoderBlock, EncoderBlock,
                                           LayerNorm, PatchEmbed, Rope)
from thermal3d_torch.models.rope import make_grid_positions, rope_tables

HEAD_TYPES = ("linear", "dpt", "catmlpdpt")
PARAMS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: DustrModelConfig) -> None:
    """Raise ValueError for a head_type or dpt_dtype no package knows.
    cfg.scan_layers and cfg.branch_batch, the JAX model's compile layouts
    (whose outputs equal the unrolled model's), change nothing here: the
    port's model always runs unrolled."""
    if cfg.head.head_type not in HEAD_TYPES:
        raise ValueError(f"unknown head_type {cfg.head.head_type!r} (not in {HEAD_TYPES})")
    head_dtype(cfg)


def head_dtype(cfg: DustrModelConfig) -> torch.dtype:
    """Compute dtype of the DPT/catmlpdpt heads: 'compute' follows the model,
    'float32' pins the head to float32."""
    if cfg.head.dpt_dtype == "compute":
        return cfg.dtype
    if cfg.head.dpt_dtype == "float32":
        return torch.float32
    raise ValueError(f"unknown head dpt_dtype {cfg.head.dpt_dtype!r} "
                     "('compute' or 'float32')")


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
        self.downstream_head1 = self._make_head()
        self.downstream_head2 = self._make_head()

    def _make_head(self) -> nn.Module:
        cfg = self.config
        if cfg.head.head_type == "linear":
            return LinearPts3dHead(cfg.dec_embed_dim, cfg.patch_size, cfg.head)
        in_dims = (cfg.enc_embed_dim,) + (cfg.dec_embed_dim,) * 3
        if cfg.head.head_type == "dpt":
            return DPTPts3dHead(cfg.head, in_dims, head_dtype(cfg))
        return CatMLPDPTHead(cfg.patch_size, cfg.head, in_dims, head_dtype(cfg))

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

    def _rope(self, grid, head_dim, device) -> Rope:
        pos = make_grid_positions(*grid, device=device)
        base = self.config.rope_base
        return Rope(*rope_tables(pos, head_dim, base), positions=pos, base=base)

    def encode(self, img: torch.Tensor):
        """img: [B, H, W, 3] → (tokens [B, S, enc_dim], patch grid)."""
        cfg = self.config
        x, grid = self.patch_embed(img)
        rope = self._rope(grid, cfg.enc_embed_dim // cfg.enc_num_heads, x.device)
        for blk in self.enc_blocks:
            x = self._block(blk, x, rope)
        return self.enc_norm(x), grid

    def _block(self, blk, *args):
        """blk(*args), recomputed in the backward pass under config.remat."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False)
        return blk(*args)

    def decode(self, f1: torch.Tensor, f2: torch.Tensor, grid
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Dual-branch decoder. Returns per view the hook list [encoder_out,
        dec_1, ..., dec_L], with dec_norm on the last entry only. Each branch
        cross-attends to the other branch's PREVIOUS tokens."""
        cfg = self.config
        rope = self._rope(grid, cfg.dec_embed_dim // cfg.dec_num_heads, f1.device)
        outs1, outs2 = [f1], [f2]
        x1 = self.decoder_embed(f1)
        x2 = self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = self._block(blk1, x1, x2, rope), self._block(blk2, x2, x1, rope)
            outs1.append(x1)
            outs2.append(x2)
        outs1[-1] = self.dec_norm(outs1[-1])
        outs2[-1] = self.dec_norm(outs2[-1])
        return outs1, outs2

    def _run_head(self, head, outs: List[torch.Tensor], grid, with_desc: bool):
        """The heads read the hook tokens in float32 (the JAX model casts the
        whole hook list; only the entries a head reads are cast here)."""
        head_type = self.config.head.head_type
        if head_type == "linear":
            return head(outs[-1].to(torch.float32), grid)
        hooked = [outs[i].to(torch.float32) for i in dpt_hook_indices(self.config.dec_depth)]
        if head_type == "dpt":
            return head(hooked, grid)
        return head(hooked, grid, outs[0].to(torch.float32), outs[-1].to(torch.float32),
                    with_desc=with_desc)

    def decode_with_heads(self, f1: torch.Tensor, f2: torch.Tensor, grid,
                          with_desc: bool = True) -> Tuple[Dict, Dict]:
        """Decoder + heads on encoder tokens f1/f2. with_desc=False skips the
        catmlpdpt local-feature branch (no desc/desc_conf in the results)."""
        outs1, outs2 = self.decode(f1, f2, grid)
        pred1 = self._run_head(self.downstream_head1, outs1, grid, with_desc)
        pred2 = dict(self._run_head(self.downstream_head2, outs2, grid, with_desc))
        pred2["pts3d_in_other_view"] = pred2.pop("pts3d")
        return pred1, pred2

    def forward(self, img1: torch.Tensor, img2: Optional[torch.Tensor] = None,
                with_desc: bool = True) -> Tuple[Dict, Dict]:
        b = img1.shape[0]
        if img2 is None:
            f1, grid = self.encode(img1)
            f2 = f1
        else:
            feats, grid = self.encode(torch.cat([img1, img2], dim=0))
            f1, f2 = feats[:b], feats[b:]
        return self.decode_with_heads(f1, f2, grid, with_desc)


@torch.no_grad()
def calibrate_act_absmax(model: AsymmetricCroCo3DStereo, img1: torch.Tensor,
                         img2: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One float forward (monocular when img2 is None) that records, for
    every Dense of the trunk (kernels.quant.trunk_dense), max|input| as the
    module is given it, in float32, max-reduced over its calls (the JAX
    QuantDense's 'calib' collection). Returns {module path: 0-dim tensor},
    the act_scales of kernels.quant.quantize_model_int8. The catmlpdpt
    local-feature branch, which reads no trunk GEMM, is not run."""
    from thermal3d_torch.kernels.quant import trunk_dense

    record: Dict[str, torch.Tensor] = {}

    def hook(path):
        def fn(_mod, args):
            v = args[0].abs().amax().to(torch.float32)
            record[path] = v if path not in record else torch.maximum(record[path], v)
        return fn

    handles = [dense.register_forward_pre_hook(hook(path)) for path, dense in trunk_dense(model)]
    try:
        model(img1, img2, with_desc=False)
    finally:
        for h in handles:
            h.remove()
    return record


def frozen_model(config: DustrModelConfig, device: torch.device,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 params_dtype: Optional[str] = None) -> AsymmetricCroCo3DStereo:
    """The model on `device` for inference (eval mode, no gradients), with
    `state_dict` loaded strictly or, without one, seeded random weights;
    params_dtype 'bfloat16' stores every weight in bf16, None keeps float32."""
    if params_dtype is not None and params_dtype not in PARAMS_DTYPES:
        raise ValueError(f"params_dtype {params_dtype!r} not in {tuple(PARAMS_DTYPES)}")
    model = AsymmetricCroCo3DStereo(config).to(device)
    if state_dict is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model.init_weights(gen)
    else:
        model.load_state_dict(state_dict, strict=True)
    if params_dtype is not None:
        model.to(PARAMS_DTYPES[params_dtype])
    return model.eval().requires_grad_(False)


def trainable_model(config: DustrModelConfig, device: torch.device,
                    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                    seed: int = 0) -> AsymmetricCroCo3DStereo:
    """The model on `device` for training: float32 master weights that
    require grad, computing in config.compute_dtype; `state_dict` loaded
    strictly or, without one, seeded random weights."""
    model = AsymmetricCroCo3DStereo(config).to(device)
    if state_dict is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        model.init_weights(gen)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(torch.float32).train().requires_grad_(True)
