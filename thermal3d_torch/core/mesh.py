"""Device meshes and the sharding rules of the port (counterpart of
thermal3d/core/mesh.py).

A `Mesh` is a numpy array of torch.devices with named axes, `.shape` a dict
as JAX exposes it. It comes in two kinds:

* single-controller (`make_mesh(..., devices=[...])`): one process drives
  every device of the mesh. Serving and pseudo-GT use it on the 'data' axis:
  one model replica per distinct device (`replicate`), the batch split into
  one chunk per position and run on a thread per distinct device
  (`run_on_mesh`; infer/engine.py, pseudo_gt/generator.py).
* over processes (`make_mesh()` once torch.distributed is initialised,
  core/distributed.py): one position per rank, each rank driving its own
  device; the mesh then also carries this rank's process group along each
  axis ('data': the ranks that share this rank's 'model' coordinate;
  'model': those that share its 'data' coordinate). Training runs on it:
  data parallelism over 'data', Megatron tensor parallelism over 'model'.

The spec functions state the JAX rules (thermal3d/core/mesh.py:66-140) on
the port's state_dict keys and torch's [out, in] weight layout, so JAX's
kernel axis 1 is torch's weight axis 0. A spec is a tuple of axis names or
None, one entry a tensor axis (shorter tuples leave the rest replicated):

* column-split over 'model' (the output features): `qkv`, `projq`,
  `projk`, `projv`, `fc1`, weights and biases;
* row-split over 'model' (the input features): `fc2`, and `proj` under
  `attn` / `cross_attn`; their biases replicate and are added once, after
  the reduce;
* replicated: `patch_embed`, the `downstream_head`s, norms and scalars;
* ZeRO-1 (`state_sharding(..., zero1=True)`): the optimizer slots (mu, nu,
  acc) add 'data' on the largest free axis whose size 'data' divides.

The packed `qkv` projection is split by heads, not contiguously: rank r of
'model' takes heads [r·H/tp, (r+1)·H/tp) of q, of k and of v (Megatron's
head-aligned split, which the JAX comment at mesh.py:56-63 calls
comm-optimal), so each rank runs its attention kernels on H/tp whole heads.
`tp` must therefore divide both head counts; GSPMD does not need that.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import copy
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from thermal3d_torch.core import collectives
from thermal3d_torch.core.device import resolve_device

Spec = Tuple[Optional[str], ...]
COL_SHARDED = ("qkv", "projq", "projk", "projv", "fc1")  # output features split
ROW_SHARDED = ("fc2",)  # input features split; attn out-proj by context


class Mesh:
    """devices: object ndarray of torch.device, one axis a name. ranks (for
    a mesh over processes): the rank at each position, groups: this rank's
    process group along each axis of size > 1, and host_groups: the same
    ranks in a gloo group (the group itself under gloo), for votes on the
    host that wait for no device work."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, groups: Optional[Dict] = None,
                 host_groups: Optional[Dict] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} but axis names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = ranks
        self.groups = dict(groups or {})
        self.host_groups = dict(host_groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def over_processes(self) -> bool:
        return self.ranks is not None

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (0 on a single-controller mesh or
        for an axis the mesh lacks)."""
        if self.ranks is None or axis not in self.axis_names:
            return 0
        pos = np.argwhere(self.ranks == dist.get_rank())[0]
        return int(pos[self.axis_names.index(axis)])

    def group(self, axis: str):
        """This rank's process group along `axis`; None when the axis has one
        position (no collective needed) or the mesh is single-controller."""
        return self.groups.get(axis)

    def all_agree(self, ok: bool, axis: str = "data") -> bool:
        """True when `ok` holds on every rank of this rank's `axis` group
        (collective over it; `ok` itself without one): a vote on the host."""
        group = self.host_groups.get(axis)
        if group is None:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        return bool(flag.item())

    def data_devices(self) -> List[torch.device]:
        """The device at each 'data' position (the first along other axes)."""
        if "data" not in self.axis_names:
            return [self.devices.reshape(-1)[0]]
        arr = np.moveaxis(self.devices, self.axis_names.index("data"), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        kind = "processes" if self.over_processes else "devices"
        return f"Mesh({self.shape}, over {kind})"


def resolve_shape(mesh_shape: Sequence[int], n: int) -> List[int]:
    """A single -1 absorbs the remaining count, as numpy's reshape does."""
    shape = list(mesh_shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // known
    return shape


def make_mesh(mesh_shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (single-controller; a device may repeat), or,
    with devices=None, over the ranks of the initialised process group (one
    position a rank, every rank must call this), else over every CUDA device
    of this process (raises without CUDA). A shape that does not hold the
    count raises numpy's reshape ValueError, as the JAX make_mesh does."""
    if devices is None and dist.is_available() and dist.is_initialized():
        return _process_mesh(mesh_shape, axis_names)
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(resolve_shape(mesh_shape, len(devices))), axis_names)


def _process_mesh(mesh_shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    from thermal3d_torch.core.distributed import process_device

    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = np.arange(world).reshape(resolve_shape(mesh_shape, world))
    names: List[Optional[str]] = [None] * world
    dist.all_gather_object(names, str(process_device()))
    devices = np.empty(world, dtype=object)
    devices[:] = [torch.device(n) for n in names]
    groups, host_groups = {}, {}
    on_host = dist.get_backend() == dist.Backend.GLOO
    for k, axis in enumerate(axis_names):
        if ranks.shape[k] == 1:
            continue
        lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
        for line in lines:  # every rank creates every group, in one order
            members = [int(r) for r in line]
            g = dist.new_group(members)
            h = g if on_host else dist.new_group(members, backend="gloo")
            if rank in line:
                groups[axis], host_groups[axis] = g, h
    return Mesh(devices.reshape(ranks.shape), axis_names, ranks, groups, host_groups)


def local_batch_size(mesh: Mesh, global_batch_size: int) -> int:
    n = mesh.shape.get("data", 1)
    if global_batch_size % n:
        raise ValueError(
            f"global batch size {global_batch_size} not divisible by data-parallel size {n}")
    return global_batch_size // n


def shard_batch(mesh: Mesh, batch: Mapping, index: Optional[int] = None) -> Dict:
    """The rows of data position `index` (default: this rank's) of each
    array or tensor of `batch`: [i·B/n, (i+1)·B/n)."""
    i = mesh.coordinate("data") if index is None else index
    out = {}
    for k, v in batch.items():
        n = local_batch_size(mesh, v.shape[0])
        out[k] = v[i * n:(i + 1) * n]
    return out


# --- the sharding rules -------------------------------------------------------

def param_partition_spec(name: str, ndim: int, mesh: Mesh) -> Spec:
    """The spec of one parameter, by its state_dict key (module docstring).
    Replicated (()) unless the mesh has a 'model' axis."""
    if "model" not in mesh.axis_names:
        return ()
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if any(p.startswith(("downstream_head", "patch_embed")) for p in parts):
        return ()
    if parent in COL_SHARDED:
        if leaf == "weight" and ndim == 2:
            return ("model", None)
        if leaf == "bias" and ndim == 1:
            return ("model",)
        return ()
    if leaf == "weight" and ndim == 2 and (
            parent in ROW_SHARDED or (parent == "proj" and any(
                p in ("attn", "cross_attn") for p in parts))):
        return (None, "model")
    return ()


def _jax_axis_order(ndim: int) -> List[int]:
    """The torch axes in the order of the JAX kernel's axes: Dense [in, out]
    is torch's [out, in]; a conv's HWIO is torch's OIHW."""
    return {2: [1, 0], 4: [2, 3, 1, 0]}.get(ndim, list(range(ndim)))


def _zero1_extend(spec: Spec, shape: Sequence[int], n_data: int) -> Spec:
    """Add 'data' to a spec on the largest free axis n_data divides (ties go
    to the axis that comes first in the JAX kernel layout, so the slices are
    JAX's, transposed); no such axis: the spec as it is (replicated)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = None, 0
    for i in _jax_axis_order(len(shape)):
        d = int(shape[i])
        if dims[i] is None and d % n_data == 0 and d > best_dim:
            best, best_dim = i, d
    if best is None:
        return tuple(spec)
    dims[best] = "data"
    return tuple(dims)


def state_sharding(mesh: Mesh, shapes: Mapping[str, Sequence[int]], zero1: bool = False,
                   slots: Sequence[str] = ("mu", "nu")) -> Dict[str, Dict[str, Spec]]:
    """Specs of a train state: {"params": {key: spec}, and per optimizer
    slot of `slots` {key: spec}}, for `shapes` {state_dict key: global
    shape}. The slots mirror the parameters' tensor-parallel specs; with
    zero1 (and 'data' > 1) they add 'data' (_zero1_extend)."""
    n_data = int(mesh.shape.get("data", 1))
    params = {k: param_partition_spec(k, len(s), mesh) for k, s in shapes.items()}
    out: Dict[str, Dict[str, Spec]] = {"params": params}
    for slot in slots:
        out[slot] = {k: (_zero1_extend(params[k], s, n_data)
                         if zero1 and n_data > 1 and len(s) >= 1 else params[k])
                     for k, s in shapes.items()}
    return out


# --- slicing and gathering by spec --------------------------------------------

def tp_pack(name: str) -> int:
    """3 for the packed qkv projection ([3, H, D] on its output axis, split
    by heads within each of q, k, v), 1 otherwise."""
    parts = name.split(".")
    return 3 if len(parts) >= 2 and parts[-2] == "qkv" else 1


def split_tensor(t: torch.Tensor, axis: int, n: int, i: int, pack: int = 1) -> torch.Tensor:
    """Part i of n of t along `axis`, a contiguous copy; with pack k the
    axis is k equal blocks, each split (qkv by heads)."""
    shape = list(t.shape)
    if shape[axis] % (pack * n):
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split into {pack}×{n}")
    blocks = t.reshape(*shape[:axis], pack, shape[axis] // pack, *shape[axis + 1:])
    part = blocks.narrow(axis + 1, i * (shape[axis] // pack // n), shape[axis] // pack // n)
    shape[axis] //= n
    return part.reshape(shape).contiguous()


def join_tensors(parts: Sequence[torch.Tensor], axis: int, pack: int = 1) -> torch.Tensor:
    """The inverse of split_tensor over all n parts."""
    shape = list(parts[0].shape)
    blocks = [p.reshape(*shape[:axis], pack, shape[axis] // pack, *shape[axis + 1:])
              for p in parts]
    shape[axis] *= len(parts)
    return torch.cat(blocks, dim=axis + 1).reshape(shape)


def slice_for_rank(name: str, full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's part of a full (unsharded) tensor under `spec`."""
    out = full
    for axis_name in ("model", "data"):
        if axis_name in spec:
            pack = tp_pack(name) if axis_name == "model" else 1
            out = split_tensor(out, spec.index(axis_name), mesh.shape[axis_name],
                               mesh.coordinate(axis_name), pack)
    return out


def gather_full(name: str, local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's part under `spec` (collective:
    every rank of the groups must call it)."""
    out = local
    for axis_name in ("data", "model"):
        if axis_name in spec:
            pack = tp_pack(name) if axis_name == "model" else 1
            out = join_tensors(collectives.all_gather(out, mesh.group(axis_name)),
                               spec.index(axis_name), pack)
    return out


# --- tensor parallelism of the model --------------------------------------------

def shard_model_(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep, in place, this rank's 'model' share of every tensor-parallel
    weight of `model` (full, e.g. from convert/from_jax.py), and wire the
    attention and MLP modules to the 'model' group (models/layers.py). A
    no-op without a 'model' axis of size > 1. Raises ValueError unless tp
    divides both head counts."""
    from thermal3d_torch.models.layers import Attention, CrossAttention, Dense, Mlp

    tp = int(mesh.shape.get("model", 1))
    if tp == 1 or getattr(model, "tp_mesh", None) is mesh:
        return model
    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("the model is already sharded over another mesh")
    cfg = model.config
    if cfg.enc_num_heads % tp or cfg.dec_num_heads % tp:
        raise ValueError(f"tensor parallelism over {tp} ranks must divide both head counts "
                         f"(enc_num_heads={cfg.enc_num_heads}, dec_num_heads="
                         f"{cfg.dec_num_heads})")
    group = mesh.group("model")
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            spec = param_partition_spec(name, p.dim(), mesh)
            if "model" not in spec:
                continue
            owner, leaf = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            if isinstance(owner, Dense) and owner.weight_scale is not None:
                raise ValueError("tensor parallelism does not apply to int8 weights")
            part = slice_for_rank(name, p.data, spec, mesh)
            setattr(owner, leaf, torch.nn.Parameter(part, requires_grad=p.requires_grad))
    for module in model.modules():
        if isinstance(module, (Attention, CrossAttention)):
            module.num_heads //= tp  # module.scale keeps the global head_dim
            module.tp_group = group
        elif isinstance(module, Mlp):
            module.tp_group = group
    model.tp_mesh = mesh
    return model


def full_state_dict(model: torch.nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The model's state dict with every tensor-parallel weight gathered to
    its full shape (collective over 'model'); on the host."""
    out = {}
    for name, t in model.state_dict().items():
        spec = param_partition_spec(name, t.dim(), mesh) if mesh is not None else ()
        full = gather_full(name, t.detach(), spec, mesh) if "model" in spec else t
        out[name] = full.detach().to("cpu", copy=True)
    return out


def load_full_state_dict_(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
                          mesh: Optional[Mesh]) -> None:
    """Load a full (unsharded) state dict into a model sharded by
    shard_model_: each tensor-parallel weight is sliced to this rank's part
    first; strict, as load_state_dict(strict=True)."""
    sliced = {}
    for name, t in state.items():
        spec = param_partition_spec(name, t.dim(), mesh) if mesh is not None else ()
        sliced[name] = slice_for_rank(name, t, spec, mesh) if "model" in spec else t
    model.load_state_dict(sliced, strict=True)


# --- single-controller data parallelism (serving, pseudo-GT) ---------------------------

def mesh_positions(mesh) -> Optional[List[torch.device]]:
    """The device of each 'data' position of a single-controller mesh (None
    without a mesh); each is checked as resolve_device checks a device."""
    if mesh is None:
        return None
    if mesh.over_processes:
        raise ValueError("serving takes a single-controller mesh (make_mesh(..., devices=)), "
                         "not one over processes")
    return [resolve_device(d) for d in mesh.data_devices()]


def replicate(device: torch.device, positions: Optional[List[torch.device]], modules):
    """{device: modules} for each distinct device of `positions`: the
    modules themselves on `device`, deep copies moved to every other one."""
    out = {device: modules}
    for d in positions or ():
        if d not in out:
            out[d] = tuple(copy.deepcopy(m).to(d) for m in modules)
    return out


def run_on_mesh(positions: List[torch.device], batch: int, chunk) -> Dict[str, torch.Tensor]:
    """chunk(device, rows) → dict of tensors, for the rows of each mesh
    position (batch/n a position; an indivisible batch raises the JAX
    engine's ValueError). The chunks of a device run in position order on
    the calling thread when the mesh has one distinct device, else on one
    thread a distinct device. Either way they run on the caller's current
    stream of every card of the mesh (a thread's current stream is its own,
    the default stream unless set): a chunk's copy of its rows from an
    input on one card, and its work, follow what the caller queued there
    (an input still being staged), and the gather and what the caller
    queues next (a fetch) follow the chunks. Returns the chunks' tensors
    concatenated in position order, on the first position's device."""
    n = len(positions)
    if batch % n:
        raise ValueError(f"batch size {batch} not divisible by the mesh's "
                         f"data-parallel size {n}")
    per = batch // n
    by_device: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(positions):
        by_device.setdefault(d, []).append(i)
    streams = [torch.cuda.current_stream(d) for d in by_device if d.type == "cuda"]

    def run(device):
        with contextlib.ExitStack() as ctx:
            for s in streams:
                ctx.enter_context(torch.cuda.stream(s))
            if device.type == "cuda":
                ctx.enter_context(torch.cuda.device(device))
            return [(i, chunk(device, slice(i * per, (i + 1) * per))) for i in by_device[device]]

    if len(by_device) == 1:
        done = run(positions[0])
    else:
        with cf.ThreadPoolExecutor(len(by_device)) as pool:
            done = [r for rs in pool.map(run, list(by_device)) for r in rs]
    parts = [out for _, out in sorted(done, key=lambda r: r[0])]
    with torch.inference_mode():
        return {k: torch.cat([p[k].to(positions[0]) for p in parts]) for k in parts[0]}

