"""JAX param trees in the scan and branch layouts → the unrolled layout
(counterpart of the `from_*` half of thermal3d/models/scan_params.py, on
numpy arrays).

`scan_layers` and `branch_batch` are compile layouts of the JAX model: the
scan model stacks each layer stack on a leading depth axis (`enc_scan/blk`,
`dec_scan/blk1`, `dec_scan/blk2`), the branch model stacks each decoder
layer's two branches on a leading axis of 2 (`dec_dual_{i}`); the outputs
equal the unrolled model's. The port always runs the unrolled model, so a
tree in either layout is unstacked into `enc_blocks_{i}`, `dec_blocks_{i}`,
`dec_blocks2_{i}` before it is converted (convert/from_jax.py). The depth is
the stacked axis's length.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


def _unstack(tree: Mapping, n: int) -> List[Dict]:
    """A tree of stacked arrays → n trees of their slices."""
    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    return [take(tree, i) for i in range(n)]


def _depth(tree: Mapping) -> int:
    node = tree
    while isinstance(node, Mapping):
        node = next(iter(node.values()))
    return int(np.asarray(node).shape[0])


def is_scan_params(params: Mapping) -> bool:
    return "enc_scan" in params or "dec_scan" in params


def is_branch_params(params: Mapping) -> bool:
    return any(k.startswith("dec_dual_") for k in params)


def from_scan_params(params: Mapping) -> Dict:
    """Scan layout → unrolled (checkpoint-native) layout."""
    if "enc_scan" not in params or "dec_scan" not in params:
        raise ValueError("params are not in scan layout (no enc_scan/dec_scan)")
    out = {k: v for k, v in params.items() if k not in ("enc_scan", "dec_scan")}
    for stack, tree in (("enc_blocks", params["enc_scan"]["blk"]),
                        ("dec_blocks", params["dec_scan"]["blk1"]),
                        ("dec_blocks2", params["dec_scan"]["blk2"])):
        for i, t in enumerate(_unstack(tree, _depth(tree))):
            out[f"{stack}_{i}"] = t
    return out


def from_branch_params(params: Mapping) -> Dict:
    """Branch-batched layout → unrolled (checkpoint-native) layout."""
    if "dec_dual_0" not in params:
        raise ValueError("params are not in branch layout (no dec_dual_0)")
    out = {k: v for k, v in params.items() if not k.startswith("dec_dual_")}
    for k, v in params.items():
        if k.startswith("dec_dual_"):
            i = k[len("dec_dual_"):]
            out[f"dec_blocks_{i}"], out[f"dec_blocks2_{i}"] = _unstack(v, 2)
    return out


def unrolled_params(params: Mapping) -> Mapping:
    """`params` in the unrolled layout, whichever of the three it is in."""
    if is_scan_params(params):
        return from_scan_params(params)
    if is_branch_params(params):
        return from_branch_params(params)
    return params
