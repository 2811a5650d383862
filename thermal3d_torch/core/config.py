"""Configuration for the port (counterpart of thermal3d/core/config.py).

Field names and defaults mirror the JAX dataclasses, so a JAX config and a
port config built from the same keywords describe the same network, loss and
training run. Only fields that the port reads are kept, and the JAX
model's compile layouts (`scan_layers`, `branch_batch`), which a JAX config
carries over: their outputs equal the unrolled model's, which the port runs.
`PreprocessConfig` is kept whole, with the JAX defaults, as part of the
package's import surface (`from thermal3d_torch.core import PreprocessConfig`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Freiburg thermal camera raw-count window (utils/preprocessing.py:53-54), read
# by preprocess.enhance.enhance_thermal_fixed_range; the upper bound of the
# reference's IR display window (utils/visualize.py:577-596), read by viz/
FREIBURG_RAW_MIN = 21800
FREIBURG_RAW_MAX = 25000
FREIBURG_VIZ_MAX = 23700


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
    # the JAX model's XLA compile layouts (the stacks under lax.scan; the
    # two decoder branches batched); the port runs its unrolled modules
    scan_layers: bool = False
    branch_batch: bool = False

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
class VGGTConfig:
    """VGGT (Visual Geometry Grounded Transformer, Wang et al. 2025) without
    its track head: a DINOv2 patch trunk with registers, an aggregator of
    alternating frame and global blocks (QK-LayerNorm, 2-D RoPE, LayerScale),
    two DPT heads on the aggregator layers `dpt_layers` and an adaLN camera
    head refined `camera_iterations` times (models/vggt.py)."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_depth: int = 24  # DINOv2 blocks
    num_register_tokens: int = 4
    depth: int = 24  # frame blocks, and as many global blocks
    rope_base: float = 100.0
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    dpt_layers: Tuple[int, int, int, int] = (4, 11, 17, 23)
    camera_trunk_depth: int = 4
    camera_num_heads: int = 16
    camera_iterations: int = 4
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def patch_grid(self) -> Tuple[int, int]:
        n = self.img_size // self.patch_size
        return n, n

    @property
    def special_tokens(self) -> int:
        """The camera token and the registers ahead of each frame's patches."""
        return 1 + self.num_register_tokens

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


# facebook/VGGT-1B: 518² frames, patch 14, ViT-L widths, 24 frame and 24
# global blocks, DPT heads on layers 4, 11, 17 and 23
VGGT_1B = VGGTConfig()

# CPU test preset (cli.pseudo_gt --model vggt1b --model_preset tiny): a 4x4
# patch grid and every kind of layer, the benchmark reference's tiny form
# (benchmark/reference/vggt.py::TINY)
VGGT_TINY = VGGTConfig(img_size=56, embed_dim=32, num_heads=2, patch_depth=2, depth=4,
                       dpt_layers=(0, 1, 2, 3), dpt_features=16,
                       dpt_out_channels=(8, 16, 24, 32), camera_trunk_depth=2,
                       camera_num_heads=2)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Thermal preprocessing constants (the reference's utils/preprocessing.py):
    the percentile window, the Freiburg raw-count window, the 16-bit scale,
    the thermal head's initial values and the fire-scene CLAHE settings."""

    percentile_low: float = 2.0
    percentile_high: float = 98.0
    raw_min: int = FREIBURG_RAW_MIN
    raw_max: int = FREIBURG_RAW_MAX
    uint16_scale: float = 65535.0
    edge_weight_init: float = 0.5  # ThermalDUSt3R's learnable head
    temp_scale_init: float = 1.0
    clahe_clip_limit: float = 3.0  # fire-scene CLAHE
    clahe_grid: Tuple[int, int] = (8, 8)
    fire_mask_threshold: float = 0.7


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
    # the process mesh of training (core/mesh.py, train/loop.py): one
    # process a device; 'data' is data parallelism, 'model' Megatron tensor
    # parallelism; zero1 shards the AdamW moments over 'data'
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    zero1: bool = False

