"""thermal3d_torch — the PyTorch/CUDA port of thermal3d for one NVIDIA H100.

The JAX package `thermal3d` is the reference; module names here mirror it, so
`thermal3d_torch/models/dustr.py` is the counterpart of
`thermal3d/models/dustr.py`. This package imports torch and numpy only. The
Pallas kernels of the reference are hand-written CUDA C++ for sm_90a under
`kernels/csrc/`, built with nvcc at first use; each has a plain PyTorch
version beside it that runs on CPU tensors.

Supported so far: DUSt3R-224 monocular serving (`infer.engine.InferenceEngine`).
"""
