"""thermal3d_torch — the PyTorch/CUDA port of thermal3d for one NVIDIA H100.

The JAX package `thermal3d` is the reference; module names here mirror it, so
`thermal3d_torch/models/dustr.py` is the counterpart of
`thermal3d/models/dustr.py`. This package imports torch and numpy only. The
Pallas kernels of the reference are hand-written CUDA C++ for sm_90a under
`kernels/csrc/`, built with nvcc at first use; each has a plain PyTorch
version beside it that runs on CPU tensors.

Supported so far: DUSt3R-224 monocular serving (`infer.engine.InferenceEngine`,
`infer` on arrays and `infer_paths` on PNG files), MASt3R-512 pseudo-GT
(`pseudo_gt.generator`, `pseudo_gt.test_set`), evaluation against pseudo-GT
depths (`evaluation`), and the infer / pseudo_gt / evaluate CLIs (`cli`).
PNG files are decoded by the port's own decoder (`native`), without cv2,
PIL or libpng. Several cards: serving and pseudo-GT over a device mesh (one
process, a replica a card) and training over torch.distributed (one process
a card: data and tensor parallelism, ZeRO-1), in `core/mesh.py` and
`core/distributed.py`. Deployment: a self-contained serving artifact
(`infer/export.py`, `cli.export`: torch.export programs with the kernels as
the custom ops of `kernels/ops.py`). Tools: `cli.model_info`, `cli.explore`,
`core/profiling.py`.
"""
