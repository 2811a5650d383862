"""The collectives of the port's multi-process training, on torch.distributed
calls only (no DTensor, no parallelize_module): gloo on the CPU runs every
one of them, and each collective is a call a reader can see.

* `all_reduce_` / `all_gather`: one tensor over a process group; a group of
  one process (or None) is a no-op.
* `all_reduce_buckets_`: the data-parallel gradient average: the tensors
  packed into flat buckets, one all_reduce a bucket.
* Megatron's two conjugate autograd Functions of tensor parallelism:
  `copy_to_model_parallel` (identity forward, all-reduce backward) in front
  of a column-split GEMM, and `reduce_from_model_parallel` (all-reduce
  forward, identity backward) after a row-split one.

Host staging, by design: gloo carries CUDA tensors for some collectives and
not others, and NCCL refuses two ranks on one card, so the only multi-rank
job one card can run is gloo with every rank on cuda:0. When a gloo group is
handed a CUDA tensor, these helpers copy it to the host, run the collective
there and copy the result back. `STAGED` counts such collectives and their
bytes. An NCCL group never stages: a CUDA tensor goes to NCCL as it is, and
no helper falls back from NCCL to anything else.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

# collectives a gloo group ran on host copies of CUDA tensors, and their bytes
STAGED = {"count": 0, "bytes": 0}
BUCKET_ELEMS = 1 << 25  # elements a gradient bucket (128 MB of float32)


def group_size(group) -> int:
    """Processes in `group` (1 for None: no collective is needed)."""
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """True when `group` is gloo and t lies on a card: the collective then
    runs on a host copy (module docstring)."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over `group`, in place; t must be contiguous."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        STAGED["count"] += 1
        STAGED["bytes"] += t.numel() * t.element_size()
        return t
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every process's t, in group-rank order (all of one shape)."""
    n = group_size(group)
    if n == 1:
        return [t]
    src = t.contiguous()
    if _staged(src, group):
        host = src.cpu()
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        STAGED["count"] += 1
        STAGED["bytes"] += n * t.numel() * t.element_size()
        return [o.to(t.device) for o in outs]
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return outs


def all_reduce_buckets_(tensors: Iterable[torch.Tensor], group,
                        scale: Optional[float] = None) -> None:
    """Sum the tensors over `group` in place, then multiply by `scale`:
    consecutive tensors of one dtype and device are packed into flat
    buckets of at most BUCKET_ELEMS elements (a larger tensor is a bucket of
    its own), one all_reduce a bucket."""
    if group_size(group) == 1:
        return
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce_(flat, group)
        if scale is not None:
            flat.mul_(scale)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + t.numel() > BUCKET_ELEMS):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()


class _CopyToModelParallel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    'model' group (each rank holds the part its column shard produced)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    """The forward sums the row-split GEMM's partial products over the
    'model' group; identity backward (the sum's gradient is each part's)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromModelParallel.apply(x, group)
