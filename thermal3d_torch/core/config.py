"""Model configuration for the port (counterpart of thermal3d/core/config.py).

Field names and defaults mirror the JAX `DustrModelConfig`/`HeadConfig`, so a
JAX config and a port config built from the same keywords describe the same
network. Only what the DUSt3R-224 serving path reads is kept; the layouts the
port does not run yet (`scan_layers`, `branch_batch`, DPT/catmlpdpt heads) are
fields so that asking for them raises instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Downstream head. Only 'linear' (dust3r LinearPts3d) is ported."""

    head_type: str = "linear"
    # pts3d = unit(x) * expm1(|x|); conf = 1 + exp(c)  (dust3r postprocess)
    depth_mode: Tuple[str, float, float] = ("exp", float("-inf"), float("inf"))
    conf_mode: Tuple[str, float, float] = ("exp", 1.0, float("inf"))


@dataclasses.dataclass(frozen=True)
class DustrModelConfig:
    """AsymmetricCroCo3DStereo architecture (ViT-L encoder, base decoder)."""

    img_size: Tuple[int, int] = (224, 224)
    patch_size: int = 16
    in_channels: int = 3
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 8
    dec_num_heads: int = 12
    mlp_ratio: float = 4.0
    rope_base: float = 100.0  # croco 'RoPE100'
    head: HeadConfig = dataclasses.field(default_factory=HeadConfig)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # 'auto': the CUDA kernels for CUDA tensors, their plain versions for CPU
    # tensors; 'torch': the plain versions everywhere (the reference run that
    # chip_smoke.py holds the kernels against).
    attention_impl: str = "auto"
    scan_layers: bool = False  # not ported: raises
    branch_batch: bool = False  # not ported: raises

    @property
    def patch_grid(self) -> Tuple[int, int]:
        return (self.img_size[0] // self.patch_size,
                self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        h, w = self.patch_grid
        return h * w

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


# The model the reference fine-tunes: ViT-L/16 encoder, 8-block base decoder
# (the reference loads the 12-block checkpoint into 8 blocks), linear head.
DUSTR_224_LINEAR = DustrModelConfig()

# CPU test preset: the JAX suite's tiny model (tests/conftest.py TINY_KW and
# the CLI's --model_preset tiny).
TINY = DustrModelConfig(
    img_size=(32, 32),
    enc_embed_dim=64,
    enc_depth=2,
    enc_num_heads=2,
    dec_embed_dim=48,
    dec_depth=2,
    dec_num_heads=2,
)
