"""thermal3d_torch — the PyTorch/CUDA port of thermal3d for one NVIDIA H100.

The JAX package `thermal3d` is the reference; module names here mirror it, so
`thermal3d_torch/models/dustr.py` is the counterpart of
`thermal3d/models/dustr.py`. This package imports torch and numpy only. The
Pallas kernels of the reference are hand-written CUDA C++ for sm_90a under
`kernels/csrc/`, built with nvcc at first use; each has a plain PyTorch
version beside it that runs on CPU tensors.

What it covers: everything the JAX package does, on the card. DUSt3R-224
serving (`infer.InferenceEngine`: `infer` on arrays, `infer_paths` on PNG
files; the fire-scene and refinement modes), MASt3R-512 pseudo-GT
(`pseudo_gt`), evaluation against pseudo-GT depths (`evaluation`),
fine-tuning (`train`, `losses`), int8 serving (`kernels/quant.py`), the
parity gate, several cards (serving and pseudo-GT over a device mesh, one
process with a replica a card; training over torch.distributed, one process
a card: data and tensor parallelism, ZeRO-1; `core/mesh.py`,
`core/distributed.py`), a self-contained serving artifact (`infer/export.py`,
`cli.export`: torch.export programs with the kernels as the custom ops of
`kernels/ops.py`), the CLIs of `cli/` with the JAX CLIs' flags, and the
workflow wrappers `scripts/torch_run_*.sh`. PNG files are decoded by the
port's own decoder (`native`), without cv2, PIL or libpng. Each sub-package
re-exports the names its JAX counterpart does (`from thermal3d_torch.infer
import InferenceEngine`; `thermal3d_torch.infer` is lazy, as in JAX). A
kernel launches on the card its tensors are on, so `device="cuda:1"` runs
every kernel on card 1.
"""
