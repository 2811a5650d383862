"""Configuration for the port (counterpart of thermal3d/core/config.py).

Field names and defaults mirror the JAX dataclasses, so a JAX config and a
port config built from the same keywords describe the same network, loss and
training run. Only fields that the port reads are kept. The layouts the
port does not run yet (`scan_layers`, `branch_batch`) are fields so that
asking for them raises instead of being ignored; so are the TPU mesh options
of `TrainConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Downstream head: 'linear' (dust3r LinearPts3d), 'dpt' (DPT regression
    head) or 'catmlpdpt' (MASt3R: DPT pts3d/conf + an MLP local-feature
    branch on cat(encoder, decoder) tokens)."""

    head_type: str = "linear"  # 'linear' | 'dpt' | 'catmlpdpt'
    # pts3d = unit(x) * expm1(|x|); conf = 1 + exp(c)  (dust3r postprocess)
    depth_mode: Tuple[str, float, float] = ("exp", float("-inf"), float("inf"))
    conf_mode: Tuple[str, float, float] = ("exp", 1.0, float("inf"))
    # DPT
    feature_dim: int = 256
    last_dim: int = 128
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    # catmlpdpt
    local_feat_dim: int = 24
    desc_conf_mode: Tuple[str, float, float] = ("exp", 0.0, float("inf"))
    two_confs: bool = True
    desc_hidden_dim_factor: float = 4.0
    # DPT/catmlpdpt compute dtype: 'compute' follows the model's compute
    # dtype, 'float32' pins the head to float32; the regression activations
    # are float32 either way
    dpt_dtype: str = "compute"  # 'compute' | 'float32'


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
    # Attention route (models/layers.py), each a kernel for CUDA tensors and
    # its plain version for CPU tensors:
    #   'auto', 'pallas_fused', 'pallas_fusedN'  fused RoPE attention K2/K3
    #                                            (N, the TPU's head group,
    #                                            shapes nothing on the card)
    #   'pallas'                                RoPE, then attention K4
    #   'pallas_grouped', 'pallas_groupedN'     RoPE, then K5
    #   'pallas_multihead'                      RoPE, then K6
    #   'torch'   the plain versions everywhere (the reference run that
    #             chip_smoke.py holds the kernels against)
    attention_impl: str = "auto"
    # recompute each encoder and decoder block in the backward pass
    # (torch.utils.checkpoint): activation memory for compute
    remat: bool = False
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

# The frozen pseudo-GT model: MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric
# (ViT-L encoder, 12-block base decoder, 512² input, catmlpdpt metric head
# with two confidences).
MASTR_512_CATMLPDPT = DustrModelConfig(
    img_size=(512, 512),
    dec_depth=12,
    head=HeadConfig(head_type="catmlpdpt", local_feat_dim=24, two_confs=True),
)

# The released DUSt3R-512 DPT variant: the same trunk with a plain DPT head.
DUSTR_512_DPT = DustrModelConfig(
    img_size=(512, 512),
    dec_depth=12,
    head=HeadConfig(head_type="dpt"),
)

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


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Thermal-aware loss constants (the reference's utils/loss.py)."""

    alpha: float = 0.2  # log-conf regulariser (confidences clamped to [1e-5, 10])
    edge_weight: float = 0.5
    smoothness_weight: float = 0.3
    detail_weight: float = 0.3
    multi_scale: bool = True
    scales: Tuple[int, ...] = (1, 2)
    thermal_factor: float = 8.0
    grad_clamp_view1: float = 0.4  # asymmetric clamps
    grad_clamp_view2: float = 0.5
    huber_delta: float = 0.1
    grad_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the reference's train_thermal_dustr.py)."""

    lr: float = 5e-4
    weight_decay: float = 1e-4
    epochs: int = 50
    batch_size: int = 4
    warmup_frac: float = 0.1  # LinearLR over 10% of the epochs
    warmup_start_factor: float = 0.1
    eta_min: float = 1e-7  # cosine floor
    grad_clip_norm: float = 1.0
    early_stop_patience: int = 10
    accumulation_steps: int = 1
    # one flat-vector optimizer on the TPU: launch policy there, the same
    # numbers as the per-tensor update; accepted and ignored (train/state.py)
    flatten_optimizer: bool = False
    # AdamW first-moment dtype: 'bfloat16' stores m in bf16 (the second
    # moment stays float32); None keeps the parameters' dtype
    mu_dtype: Optional[str] = None
    use_enhanced_loss: bool = True
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    seed: int = 0
    val_fraction: float = 0.2  # 0.8/0.2 random split
    log_interval: int = 100
    max_batches: Optional[int] = None  # quick-test cap
    # sharding: only the one-device mesh is ported (ROADMAP Queue 1 item 11)
    mesh_shape: Tuple[int, ...] = (-1,)
    zero1: bool = False

