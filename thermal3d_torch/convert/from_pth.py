"""Load a torch/dust3r `.pth` checkpoint into the port (the port's own copy
of the rules of thermal3d/convert/torch_to_flax.py; the port's modules use
the torch key layout, so no tensor is transformed).

* The container is unwrapped: {'model': …}, {'state_dict': …} or raw.
* A ThermalDUSt3R wrapper checkpoint ('model.'-prefixed keys, or the
  learnable `edge_weight`/`temp_scale`) is detected: its two scalars form the
  thermal head's state, its `sobel_x`/`sobel_y` buffers are dropped and the
  prefix is stripped.
* Skipped, as the reference skips them: croco's `mask_token` and
  `prediction_head`, encoder/decoder blocks past the configured depth (a
  12-block checkpoint into the 8-block 224 model), and the dead
  `refinenet4.resConfUnit1` of the DPT heads.
* The rest loads with strict=True: an unknown or a missing key raises.

`expected_torch_keys` and `released_checkpoint_keys` give the name → shape
inventory a checkpoint of a config has (the validator of cli.model_info).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

from thermal3d_torch.core.config import DustrModelConfig

_BLOCK = re.compile(r"(enc_blocks|dec_blocks2?)\.(\d+)\.")
_DEAD = re.compile(r"downstream_head[12]\.dpt\.scratch\.refinenet4\.resConfUnit1\.")
THERMAL_KEYS = ("edge_weight", "temp_scale")


def load_torch_checkpoint(path: str) -> Mapping[str, torch.Tensor]:
    """Load a .pth on the CPU and unwrap its container. Released dust3r
    checkpoints pickle their training arguments beside the weights, so this
    unpickles the whole file (weights_only=False): load only checkpoints
    from a source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        return ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def is_wrapper_state_dict(state: Mapping) -> bool:
    """A ThermalDUSt3R-wrapper checkpoint: 'model.'-prefixed keys or the
    learnable edge_weight/temp_scale."""
    return any(k.startswith("model.") or k in THERMAL_KEYS for k in state)


def _skipped(key: str, config: DustrModelConfig) -> bool:
    if key.split(".")[0] in ("mask_token", "prediction_head"):
        return True
    m = _BLOCK.match(key)
    if m is not None:
        depth = config.enc_depth if m.group(1) == "enc_blocks" else config.dec_depth
        return int(m.group(2)) >= depth
    return _DEAD.match(key) is not None


def split_checkpoint(state: Mapping[str, torch.Tensor], config: DustrModelConfig,
                     wrapper: Optional[bool] = None
                     ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """A torch state dict → (the model's state dict, float32, for a strict
    load; the thermal head's {'edge_weight', 'temp_scale'} or None).
    wrapper=None detects the wrapper layout."""
    if wrapper is None:
        wrapper = is_wrapper_state_dict(state)
    model: Dict[str, torch.Tensor] = {}
    head: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        value = torch.as_tensor(value).detach().to(torch.float32)
        if wrapper:
            if key in THERMAL_KEYS:
                head[key] = value.reshape(())
                continue
            if key in ("sobel_x", "sobel_y"):
                continue
            key = key[len("model."):] if key.startswith("model.") else key
        if not _skipped(key, config):
            model[key] = value
    return model, (head or None)


def load_pth(path: str, config: DustrModelConfig
             ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """The --weights / --model loader of the CLIs: a .pth file, or a
    checkpoint directory of the port's training (train/checkpoint.py: its
    newest best checkpoint, else its last) → split_checkpoint. Any other
    directory is taken for an orbax checkpoint and raises
    NotImplementedError (reading orbax needs jax: export the JAX params to a
    .pth instead); anything else ValueError."""
    if os.path.isdir(path):
        from thermal3d_torch.train.checkpoint import (is_checkpoint_dir,
                                                      load_params_from_checkpoint_dir)

        if is_checkpoint_dir(path):
            return split_checkpoint(load_params_from_checkpoint_dir(path)[0], config)
        raise NotImplementedError(
            f"{path}: not a thermal3d_torch checkpoint directory; orbax directories are "
            "not read (they need jax): export the JAX params with "
            "thermal3d.convert.flax_to_torch.export_state_dict to a .pth and pass that")
    if not path.endswith(".pth"):
        raise ValueError(f"unsupported weights format: {path}")
    return split_checkpoint(load_torch_checkpoint(path), config)


def expected_torch_keys(config: DustrModelConfig) -> Dict[str, Tuple[int, ...]]:
    """name → shape of every tensor of a checkpoint the converter
    understands for `config`: the port's own model's state dict (built on
    the meta device), plus the DPT heads' dead refinenet4.resConfUnit1, which
    checkpoints carry and the converter skips (shaped as resConfUnit2)."""
    import torch

    from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo

    with torch.device("meta"):
        state = AsymmetricCroCo3DStereo(config).state_dict()
    keys = {k: tuple(v.shape) for k, v in state.items()}
    for k, shape in list(keys.items()):
        if ".scratch.refinenet4.resConfUnit2." in k:
            keys[k.replace("resConfUnit2", "resConfUnit1")] = shape
    return keys


def released_checkpoint_keys(config: DustrModelConfig, ckpt_dec_depth: Optional[int] = None
                             ) -> Dict[str, Tuple[int, ...]]:
    """The inventory of a released naver checkpoint of this architecture:
    expected_torch_keys at the checkpoint's native decoder depth (default
    max(dec_depth, 12): the 224-linear checkpoint carries 12 decoder blocks
    a branch where the model builds 8), plus croco's `mask_token`
    [1, 1, dec_embed_dim], which the model never reads."""
    if ckpt_dec_depth is None:
        ckpt_dec_depth = max(config.dec_depth, 12)
    keys = expected_torch_keys(dataclasses.replace(config, dec_depth=ckpt_dec_depth))
    keys["mask_token"] = (1, 1, config.dec_embed_dim)
    return keys
