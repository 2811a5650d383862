"""JAX/Flax parameter tree → PyTorch state dict for the port (the port's own
copy of the mapping in thermal3d/convert/flax_to_torch.py).

The input is the Flax param tree of AsymmetricCroCo3DStereo as nested dicts
of numpy arrays (or of anything np.asarray reads), or, with wrapper=True, of
ThermalDUSt3R (`thermal_preprocess` scalars + `model` subtree). Dense kernels
[in, out] become torch weights [out, in]; convs go HWIO → OIHW; a Flax
ConvTranspose kernel (HWIO, applied unflipped) becomes the torch
ConvTranspose2d weight [in, out, kh, kw] flipped in both spatial axes;
LayerNorm `scale` becomes `weight`. Keys follow the torch/dust3r layout that
the port's module names mirror, so the result loads with strict=True. A tree
of the JAX model's scan or branch layout (`scan_layers`, `branch_batch`) is
unstacked into the unrolled layout first (models/scan_params.py).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from thermal3d_torch.models.scan_params import unrolled_params

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _conv(w: np.ndarray) -> np.ndarray:  # HWIO → OIHW
    return w.transpose(3, 2, 0, 1)


def _conv_t(w: np.ndarray) -> np.ndarray:  # flax convT kernel → torch [in, out, kh, kw]
    return w[::-1, ::-1].transpose(2, 3, 0, 1)


# DPT modules of the Flax head → (torch name under `dpt.`, kernel transform)
_DPT = {
    "act1_proj": ("act_postprocess.0.0", _conv),
    "act1_up": ("act_postprocess.0.1", _conv_t),
    "act2_proj": ("act_postprocess.1.0", _conv),
    "act2_up": ("act_postprocess.1.1", _conv_t),
    "act3_proj": ("act_postprocess.2.0", _conv),
    "act4_proj": ("act_postprocess.3.0", _conv),
    "act4_down": ("act_postprocess.3.1", _conv),
    "head0": ("head.0", _conv),
    "head2": ("head.2", _conv),
    "head4": ("head.4", _conv),
}
_RN = re.compile(r"layer[1-4]_rn")
_REFINE = re.compile(r"refinenet[1-4]\.(resConfUnit[12]\.conv[12]|out_conv)")


def _head_key_and_value(rest, leaf: str, value: np.ndarray):
    """torch key (below downstream_head*) and value of a head leaf."""
    if rest == ["proj"]:  # linear head
        return f"proj.{_LEAF[leaf]}", value.T if leaf == "kernel" else value
    if rest in (["mlp_fc1"], ["mlp_fc2"]):  # catmlpdpt local-feature MLP
        key = f"head_local_features.fc{rest[0][-1]}.{_LEAF[leaf]}"
        return key, value.T if leaf == "kernel" else value
    # DPT subtree: [dpt_head,] dpt, <module...>
    r = rest[1:] if rest[:1] == ["dpt_head"] else rest
    r = r[1:] if r[:1] == ["dpt"] else r
    if len(r) == 1 and r[0] in _DPT:
        name, fn = _DPT[r[0]]
        return f"dpt.{name}.{_LEAF[leaf]}", fn(value) if leaf == "kernel" else value
    inner = ".".join(r)
    if _RN.fullmatch(inner) or _REFINE.fullmatch(inner):
        return f"dpt.scratch.{inner}.{_LEAF[leaf]}", _conv(value) if leaf == "kernel" else value
    return None


def _key_and_value(mods, leaf: str, value: np.ndarray):
    """torch key and value for one Flax leaf; None for an unknown path."""
    m0 = mods[0] if mods else ""
    if m0 == "patch_embed":
        w = value.transpose(3, 2, 0, 1) if leaf == "kernel" else value  # HWIO → OIHW
        return "patch_embed.proj." + _LEAF[leaf], w
    if m0.startswith(("enc_blocks_", "dec_blocks_", "dec_blocks2_")):
        stack, idx = m0.rsplit("_", 1)
        inner = ".".join(mods[1:])
        w = value.T if leaf == "kernel" else value
        return f"{stack}.{idx}.{inner}.{_LEAF[leaf]}", w
    if m0 in ("enc_norm", "dec_norm"):
        return f"{m0}.{_LEAF[leaf]}", value
    if m0 == "decoder_embed":
        return f"decoder_embed.{_LEAF[leaf]}", value.T if leaf == "kernel" else value
    if m0 in ("downstream_head1", "downstream_head2") and leaf in _LEAF:
        kv = _head_key_and_value(list(mods[1:]), leaf, value)
        return None if kv is None else (f"{m0}.{kv[0]}", kv[1])
    return None


def _unrolled(tree: Mapping, wrapper: bool) -> Mapping:
    """The tree with the model's (or the wrapper's `model`) subtree in the
    unrolled layout."""
    if wrapper:
        return {k: unrolled_params(v) if k == "model" else v for k, v in tree.items()}
    return unrolled_params(tree)


def state_dict_from_jax(params: Mapping, wrapper: bool = False) -> Dict[str, torch.Tensor]:
    """Convert a Flax param tree to a torch state dict (CPU tensors, the
    source dtype). Raises KeyError on a path that no module of the port has."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(_unrolled(params, wrapper)):
        parts = list(path)
        prefix = ""
        if wrapper:
            if parts[0] == "thermal_preprocess":
                out[parts[1]] = torch.from_numpy(np.array(value).reshape(()))
                continue
            if parts[0] == "model":
                prefix, parts = "model.", parts[1:]
        kv = _key_and_value(parts[:-1], parts[-1], value)
        if kv is None:
            raise KeyError(f"cannot convert flax param path {'.'.join(path)} "
                           "(no module of the port has it)")
        key, w = kv
        out[prefix + key] = torch.from_numpy(np.array(w, order="C"))
    return out


def thermal_head_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """ThermalPreprocessHead params {'edge_weight', 'temp_scale'} → state dict."""
    return {k: torch.from_numpy(np.array(params[k], np.float32).reshape(()))
            for k in ("edge_weight", "temp_scale")}


def int8_state_dict_from_jax(params_q: Mapping, quant: Mapping,
                             wrapper: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX int8 tree (`params_q` and the `quant` collection of
    thermal3d.kernels.quant.quantize_params_int8) → the port's int8 state
    dict: int8 kernels [K, N] become int8 weights [N, K]; `kernel_scale`
    becomes `weight_scale` ([N], or [G, N] transposed to [N, G]) and
    `act_scale` stays a 0-dim float32. Load it with
    kernels.quant.load_int8_state_dict."""
    out = state_dict_from_jax(params_q, wrapper=wrapper)
    for path, value in _flatten(_unrolled(quant, wrapper)):
        parts = list(path)
        prefix = ""
        if wrapper and parts[0] == "model":
            prefix, parts = "model.", parts[1:]
        kv = _key_and_value(parts[:-1], "kernel", value)
        if kv is None or parts[-1] not in ("kernel_scale", "act_scale"):
            raise KeyError(f"cannot convert flax quant path {'.'.join(path)}")
        module = prefix + kv[0][:-len(".weight")]
        if parts[-1] == "kernel_scale":
            out[f"{module}.weight_scale"] = torch.from_numpy(
                np.array(value.T, np.float32, order="C"))
        else:
            out[f"{module}.act_scale"] = torch.from_numpy(np.array(value, np.float32).reshape(()))
    return out
