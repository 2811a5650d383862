"""Inference: the batched engine and the serving artifact.

Re-exports are lazy, as in thermal3d/infer, so that `thermal3d_torch.infer.
export` (the serving loader, which runs without the model code) can be
imported without pulling the engine and the models into the process.
"""

import importlib

_EXPORTS = {
    "InferenceEngine": ("thermal3d_torch.infer.engine", "InferenceEngine"),
    "ServingArtifact": ("thermal3d_torch.infer.export", "ServingArtifact"),
    "save_serving_artifact": ("thermal3d_torch.infer.export", "save_serving_artifact"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'thermal3d_torch.infer' has no attribute {name!r}")
    return getattr(importlib.import_module(module_name), attr)
