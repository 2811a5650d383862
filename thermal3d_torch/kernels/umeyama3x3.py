"""The Umeyama/Kabsch 3×3 solve of the pseudo-GT pose: for each covariance
C [3,3], the Kabsch rotation R = U·Vᵀ and the signed singular values, with
U and V rotations, so that det C's sign falls on the third.

`kabsch3x3` launches the CUDA kernel in csrc/umeyama3x3.cu for a CUDA tensor
and runs `kabsch3x3_plain`, the kernel's sweeps written in PyTorch, for a
CPU tensor. Both solve in float64 (one-sided cyclic Jacobi on C's columns,
then the columns sorted by norm; the csrc file's header has the steps) and
store float32, and neither reads a result back to the host: the pseudo-GT
step is dispatched whole without waiting for the device, where
torch.linalg.svd on CUDA checks the solver's info on the host. No TPU
kernel corresponds: the JAX package leaves its SVD to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from thermal3d_torch.kernels import _build

SWEEPS = 8  # csrc/umeyama3x3.cu's kSweeps
LEFT = 1e-6  # its kLeft: the least share of b2 off u1 that makes u2
PAIRS = ((0, 1), (0, 2), (1, 2))


def kabsch3x3_plain(cov: torch.Tensor):
    """[B, 3, 3] covariances → (r [B,3,3], signed singular values [B,3],
    rank_ok [B] bool), in cov's dtype: the kernel's arithmetic in PyTorch,
    step for step. Singular values are sorted by magnitude, the first two
    nonnegative; rank_ok: at least two of them above cov's dtype's eps."""
    b = cov.to(torch.float64).clone()  # b[:, i, j]: row i, column j
    v = torch.eye(3, dtype=torch.float64, device=cov.device).expand_as(b).clone()
    for _ in range(SWEEPS):
        for p, q in PAIRS:
            _rotate(b, v, p, q)
    n = (b * b).sum(dim=1)
    for p, q in ((0, 1), (1, 2), (0, 1)):
        _order(b, v, n, p, q)

    s1 = n[:, 0].sqrt()
    e1 = torch.zeros_like(b[:, :, 0])
    e1[:, 0] = 1.0
    u1 = torch.where(s1[:, None] > 0, b[:, :, 0] / s1[:, None], e1)
    u2 = b[:, :, 1] - (u1 * b[:, :, 1]).sum(-1, keepdim=True) * u1
    w = u2.norm(dim=-1, keepdim=True)
    # too little of b2 left off u1: u1 × e_k for the axis e_k least along u1
    # (argmin takes the first of equals, as the kernel's strict compare)
    axis = torch.nn.functional.one_hot(u1.abs().argmin(dim=-1), 3).to(u1.dtype)
    other = torch.linalg.cross(u1, axis)
    u2 = torch.where(w > LEFT * n[:, 1:2].sqrt(), u2, other)
    u2 = u2 / u2.norm(dim=-1, keepdim=True)
    u3 = torch.linalg.cross(u1, u2)
    u = torch.stack((u1, u2, u3), dim=-1)

    sig = (u * b).sum(dim=1)
    sig[:, 1] = sig[:, 1].abs()
    rank_ok = (sig.abs() > torch.finfo(cov.dtype).eps).sum(dim=-1) >= 2
    r = u @ v.transpose(1, 2)
    return r.to(cov.dtype), sig.to(cov.dtype), rank_ok


def _rotate(b: torch.Tensor, v: torch.Tensor, p: int, q: int) -> None:
    """The plane rotation that makes columns p and q of b orthogonal,
    applied to b and v in place (none where they already are)."""
    bp, bq = b[:, :, p], b[:, :, q]
    a = (bp * bp).sum(-1)
    c2 = (bq * bq).sum(-1)
    g = (bp * bq).sum(-1)
    turn = g != 0
    zeta = (c2 - a) / torch.where(turn, 2.0 * g, torch.ones_like(g))
    t = torch.copysign(torch.ones_like(zeta), zeta) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
    c = torch.where(turn, 1.0 / torch.sqrt(1.0 + t * t), torch.ones_like(t))[:, None]
    s = torch.where(turn, c[:, 0] * t, torch.zeros_like(t))[:, None]
    for m in (b, v):
        mp, mq = m[:, :, p].clone(), m[:, :, q].clone()
        m[:, :, p] = c * mp - s * mq
        m[:, :, q] = s * mp + c * mq


def _order(b: torch.Tensor, v: torch.Tensor, n: torch.Tensor, p: int, q: int) -> None:
    """Columns p < q in descending order of norm (n: squared norms); a swap
    negates the new column q, so det v stays +1."""
    swap = n[:, q] > n[:, p]
    for m in (b, v):
        mp, mq = m[:, :, p].clone(), m[:, :, q].clone()
        m[:, :, p] = torch.where(swap[:, None], mq, mp)
        m[:, :, q] = torch.where(swap[:, None], -mp, mq)
    np_, nq = n[:, p].clone(), n[:, q].clone()
    n[:, p] = torch.where(swap, nq, np_)
    n[:, q] = torch.where(swap, np_, nq)


def kabsch3x3(cov: torch.Tensor):
    """[B, 3, 3] covariances → (r, signed singular values, rank_ok) as
    kabsch3x3_plain: the CUDA kernel for a CUDA tensor (float32,
    contiguous), the plain version for a CPU tensor. One launch a call."""
    if cov.device.type == "cpu":
        return kabsch3x3_plain(cov)
    if cov.device.type != "cuda":
        raise ValueError(f"kabsch3x3: unsupported device {cov.device}")
    if cov.dtype != torch.float32 or cov.dim() != 3 or tuple(cov.shape[1:]) != (3, 3):
        raise ValueError(f"kabsch3x3: needs a [B, 3, 3] float32 tensor, got "
                         f"{tuple(cov.shape)} {cov.dtype}")
    if not cov.is_contiguous():
        raise ValueError("kabsch3x3: input must be contiguous")
    if cov.shape[0] >= 2 ** 31:
        raise ValueError(f"kabsch3x3: at most 2^31 - 1 covariances, got {cov.shape[0]}")
    r = torch.empty_like(cov)
    sig = torch.empty((cov.shape[0], 3), dtype=torch.float32, device=cov.device)
    rank_ok = torch.empty((cov.shape[0],), dtype=torch.bool, device=cov.device)
    if cov.shape[0] > 0:
        _launch(cov, r, sig, rank_ok)
    return r, sig, rank_ok


def _launch(cov: torch.Tensor, r: torch.Tensor, sig: torch.Tensor,
            rank_ok: torch.Tensor) -> None:
    """Launch the kernel on checked tensors, on their card: the library call
    runs with that card current, on its current stream."""
    lib = _lib()
    stream = torch.cuda.current_stream(cov.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = lib.t3d_umeyama3x3(cov.data_ptr(), r.data_ptr(), sig.data_ptr(),
                                rank_ok.data_ptr(), cov.shape[0], stream)
    _build.check(lib, rc, "umeyama3x3 launch")
    _build.count_launch(kabsch3x3)


kabsch3x3.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("umeyama3x3")
    fn = lib.t3d_umeyama3x3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
