"""K1: fused percentile contrast enhancement (counterpart of
thermal3d/kernels/image_ops.py).

`percentile_enhance` launches the CUDA kernel in csrc/percentile_enhance.cu
for a CUDA tensor and runs `percentile_enhance_plain`, the binary search of
the Pallas kernel written in PyTorch, for a CPU tensor. All return, for each
image, the single order statistics p_lo/p_hi found on the 65535-step grid
(not np.percentile's interpolation), then clip-rescale the image to [0, 1].
The CUDA kernel finds the same order statistics by a two-level radix select
over many blocks an image; `percentile_radix_plain` restates that algorithm
in PyTorch, so the CPU tests can hold it to the search bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from thermal3d_torch.kernels import _build

GRID = 65535.0  # 16-bit quantisation grid for values in [0, 1]
SEARCH_STEPS = 16  # ceil(log2(65536))
# pixels an image the kernel takes: its int32 counts, compared as float32,
# are exact up to 2^24
MAX_PIXELS = 1 << 24
_SCRATCH_INTS = 256 + 2 * 256 + 4  # an image's hist_hi, hist_lo and selection


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
        return grid_value(lo_v)

    return _rescale(x, percentile(lo), percentile(hi)).reshape(b, h, w)


def grid_value(v: torch.Tensor) -> torch.Tensor:
    """v / 65535 in IEEE float32, as the kernels divide. The divisor is a
    tensor: torch's CUDA division by a Python scalar multiplies by the
    scalar's float32 reciprocal instead, which is 1 ulp off for some v (the
    plain version on the card then missed the kernel by up to 2.98e-8)."""
    return v / torch.full_like(v, GRID)


def _rescale(x: torch.Tensor, p_lo: torch.Tensor, p_hi: torch.Tensor) -> torch.Tensor:
    """Clip-rescale [B, N] images by their per-image [B] percentiles."""
    p_lo, p_hi = p_lo[:, None], p_hi[:, None]
    scale = 1.0 / torch.clamp(p_hi - p_lo, min=1e-12)
    return torch.clamp((x - p_lo) * scale, 0.0, 1.0)


def percentile_radix_plain(gray: torch.Tensor, lo: float = 2.0,
                           hi: float = 98.0) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch: a two-level radix select (256
    bins of the high byte of q = clamp(floor(x * 65535), 0, 65535), then 256
    of the low byte within the selected bin) for the smallest v with
    count(q <= v) >= target; then the same clip-rescale. Equal, bit for bit,
    to percentile_enhance_plain."""
    b, h, w = gray.shape
    n = h * w
    x = gray.reshape(b, n)
    q = torch.clamp(torch.floor(x * GRID), 0.0, GRID).to(torch.int64)
    image = torch.arange(b, device=gray.device)[:, None]

    def select(counts, below, target):
        """Per image: the first bin where below + the cumulative count
        reaches target (255 if none), and below + the count before it."""
        cum = below[:, None] + torch.cumsum(counts, dim=1)
        bins = torch.clamp((cum.to(torch.float32) < target).sum(dim=1), max=255)
        before = torch.where(bins > 0, cum.gather(1, (bins - 1).clamp(min=0)[:, None])[:, 0],
                             below)
        return bins, before

    hist_hi = torch.bincount((image * 256 + (q >> 8)).reshape(-1),
                             minlength=b * 256).reshape(b, 256)
    zero = torch.zeros(b, dtype=torch.int64, device=gray.device)
    ps = []
    for frac in (lo, hi):
        target = search_target(frac, n)
        high, below = select(hist_hi, zero, target)
        in_bin = (q >> 8) == high[:, None]
        hist_lo = torch.bincount((image * 256 + (q & 255))[in_bin],
                                 minlength=b * 256).reshape(b, 256)
        low, _ = select(hist_lo, below, target)
        ps.append(grid_value((high * 256 + low).to(torch.float32)))
    return _rescale(x, *ps).reshape(b, h, w)


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
    if n > MAX_PIXELS or b > 65535:
        raise ValueError(f"percentile_enhance: at most {MAX_PIXELS} pixels an image and "
                         f"65535 images (got {b} of {h}x{w})")
    out = torch.empty_like(gray)
    if out.numel() == 0:
        return out
    scratch = torch.zeros(b * _SCRATCH_INTS, dtype=torch.int32, device=gray.device)
    lib = _lib()
    rc = lib.t3d_percentile_enhance(
        gray.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, n, search_target(lo, n),
        search_target(hi, n), torch.cuda.current_stream(gray.device).cuda_stream)
    _build.check(lib, rc, "percentile_enhance launch")
    percentile_enhance.launches += 1
    return out


percentile_enhance.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("percentile_enhance")
    fn = lib.t3d_percentile_enhance
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
