"""K1: fused percentile contrast enhancement (counterpart of
thermal3d/kernels/image_ops.py).

`percentile_enhance` launches the CUDA kernel in csrc/percentile_enhance.cu
for a CUDA tensor and runs `percentile_enhance_plain`, the same binary search
written in PyTorch, for a CPU tensor. Both return, for each image, the single
order statistics p_lo/p_hi found on the 65535-step grid (not np.percentile's
interpolation), then clip-rescale the image to [0, 1].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from thermal3d_torch.kernels import _build

GRID = 65535.0  # 16-bit quantisation grid for values in [0, 1]
SEARCH_STEPS = 16  # ceil(log2(65536))
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_STATIC_SMEM = 256  # the kernel's per-warp partial sums


def search_target(frac: float, n: int) -> float:
    """Rank a percentile's count must reach: frac/100 * n, computed in double
    and rounded to float32, as the reference's weakly typed scalar is."""
    return float(np.float32(frac / 100.0 * n))


def percentile_enhance_plain(gray: torch.Tensor, lo: float = 2.0,
                             hi: float = 98.0) -> torch.Tensor:
    """[B, H, W] float32 in [0, 1] → percentile-rescaled [B, H, W] in [0, 1].
    The kernel's arithmetic in PyTorch, step for step."""
    b, h, w = gray.shape
    n = h * w
    x = gray.reshape(b, n)
    q = torch.floor(x * GRID)

    def percentile(frac):
        target = search_target(frac, n)
        lo_v = torch.zeros(b, dtype=torch.float32, device=gray.device)
        hi_v = torch.full((b,), GRID, dtype=torch.float32, device=gray.device)
        for _ in range(SEARCH_STEPS):
            mid = torch.floor((lo_v + hi_v) * 0.5)
            count = (q <= mid[:, None]).to(torch.float32).sum(dim=1)
            ok = count >= target
            lo_v, hi_v = torch.where(ok, lo_v, mid + 1.0), torch.where(ok, mid, hi_v)
        return lo_v / GRID

    p_lo = percentile(lo)[:, None]
    p_hi = percentile(hi)[:, None]
    scale = 1.0 / torch.clamp(p_hi - p_lo, min=1e-12)
    return torch.clamp((x - p_lo) * scale, 0.0, 1.0).reshape(b, h, w)


def percentile_enhance(gray: torch.Tensor, lo: float = 2.0,
                       hi: float = 98.0) -> torch.Tensor:
    """[B, H, W] float32 in [0, 1] → [B, H, W]: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. Forward only."""
    if gray.device.type == "cpu":
        return percentile_enhance_plain(gray, lo, hi)
    if gray.device.type != "cuda":
        raise ValueError(f"percentile_enhance: unsupported device {gray.device}")
    if gray.dtype != torch.float32 or gray.dim() != 3:
        raise ValueError("percentile_enhance: needs a [B, H, W] float32 tensor, "
                         f"got {tuple(gray.shape)} {gray.dtype}")
    if not gray.is_contiguous():
        raise ValueError("percentile_enhance: input must be contiguous")
    if gray.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("percentile_enhance: the CUDA kernel is forward only")
    b, h, w = gray.shape
    n = h * w
    if 2 * n + _STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"percentile_enhance: a {h}x{w} image does not fit in "
                         "one block's shared memory")
    out = torch.empty_like(gray)
    if b == 0:
        return out
    lib = _lib()
    rc = lib.t3d_percentile_enhance(
        gray.data_ptr(), out.data_ptr(), b, n, search_target(lo, n),
        search_target(hi, n), torch.cuda.current_stream(gray.device).cuda_stream)
    _build.check(lib, rc, "percentile_enhance launch")
    percentile_enhance.launches += 1
    return out


percentile_enhance.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("percentile_enhance")
    fn = lib.t3d_percentile_enhance
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
