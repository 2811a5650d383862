"""JAX/Flax parameter tree → PyTorch state dict for the port (the port's own
copy of the linear-head subset of thermal3d/convert/flax_to_torch.py).

The input is the Flax param tree of AsymmetricCroCo3DStereo as nested dicts
of numpy arrays (or of anything np.asarray reads), or, with wrapper=True, of
ThermalDUSt3R (`thermal_preprocess` scalars + `model` subtree). Dense kernels
[in, out] become torch weights [out, in]; the patch conv goes HWIO → OIHW;
LayerNorm `scale` becomes `weight`. Keys follow the torch/dust3r layout that
the port's module names mirror, so the result loads with strict=True.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


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
    if m0 in ("downstream_head1", "downstream_head2") and list(mods[1:]) == ["proj"]:
        return f"{m0}.proj.{_LEAF[leaf]}", value.T if leaf == "kernel" else value
    return None


def state_dict_from_jax(params: Mapping, wrapper: bool = False) -> Dict[str, torch.Tensor]:
    """Convert a Flax param tree to a torch state dict (CPU tensors, the
    source dtype). Raises KeyError on a parameter this slice does not port."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
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
                           "(only the DUSt3R-224 linear-head model is ported)")
        key, w = kv
        out[prefix + key] = torch.from_numpy(np.array(w, order="C"))
    return out


def thermal_head_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """ThermalPreprocessHead params {'edge_weight', 'temp_scale'} → state dict."""
    return {k: torch.from_numpy(np.array(params[k], np.float32).reshape(()))
            for k in ("edge_weight", "temp_scale")}
