"""Train state, optimizer and learning-rate schedule (counterpart of
thermal3d/train/state.py).

The optimizer restates the JAX chain `optax.chain(clip_by_global_norm(1.0),
adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4,
mu_dtype=...))`, wrapped in `optax.MultiSteps` for gradient accumulation,
on foreach tensor ops (a few passes over the parameters, as torch's own
foreach AdamW makes them):
  * the clip scales by max_norm / norm only when norm >= max_norm (torch's
    clip_grad_norm_ divides by norm + 1e-6 and is not used);
  * Adam's moments m = (1 − b1) g + b1 m, v = (1 − b2) g² + b2 v, both
    bias-corrected, u = m̂ / (√v̂ + eps); the decoupled decay is applied
    first, p · (1 − lr·wd), then p − lr · u. optax adds wd · p to u
    instead: the same rule, rounded in another order (the tests hold both
    to optax and to torch.optim.AdamW);
  * lr is the schedule at the optimizer's count before its increment;
  * mu_dtype 'bfloat16' stores m in bf16 while the update uses the float32
    m of this step, as optax casts after the update;
  * accumulation_steps k > 1 keeps optax's running mean of the k
    micro-batch gradients and updates on every k-th call only.
`flatten_optimizer` is the TPU's launch policy (one flat vector instead of
per-leaf updates), numerically the same as the per-tensor update: it is
accepted and ignored, as `split_programs` is in the generator.

The schedule is the reference's epoch-stepped LinearLR → CosineAnnealingLR,
a function of epoch = step // steps_per_epoch.

On a process mesh (core/mesh.py) the optimizer takes a `ParallelLayout`:
  * tensor parallelism: a rank holds its 'model' share of each split
    parameter and of its moments; the clip's global norm counts a split
    tensor's squares once a shard (summed over 'model') and a replicated
    tensor's once in total, not tp times;
  * ZeRO-1 (cfg.zero1, 'data' > 1): each rank keeps mu / nu / acc only for
    its slice of each parameter on the slot's 'data' axis (mesh.
    _zero1_extend), updates that slice of the parameter, and all-gathers the
    updated slices over 'data'; the clip's norm is then the norm of the
    whole averaged gradient: the squares of the slices summed over 'data'.
  * `full_state_dict` / `load_full_state_dict` gather and re-slice the
    slots, so a checkpoint does not depend on the world size.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from thermal3d_torch.core import collectives
from thermal3d_torch.core.config import TrainConfig
from thermal3d_torch.core.mesh import (Mesh, gather_full, param_partition_spec,
                                       slice_for_rank, state_sharding)

MU_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """step → learning rate (float32 values, as the JAX schedule returns)."""
    warmup_epochs = int(cfg.epochs * cfg.warmup_frac)
    base, eta_min = cfg.lr, cfg.eta_min
    t_max = max(1, cfg.epochs - warmup_epochs)

    def schedule(step: int) -> float:
        epoch = int(step) // max(1, steps_per_epoch)
        if epoch < warmup_epochs:
            lr = base * (cfg.warmup_start_factor + (1.0 - cfg.warmup_start_factor)
                         * min(epoch, warmup_epochs) / warmup_epochs)
        else:
            t = max(epoch - warmup_epochs, 0)
            lr = eta_min + (base - eta_min) * 0.5 * (1 + math.cos(math.pi * t / t_max))
        return float(np.float32(lr))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), a
    float32 scalar on the tensors' device: the norms of the tensors, then
    the norm of those."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class ParallelLayout:
    """Where a rank's parameters (state_dict keys `names`, local shapes) and
    their optimizer slots lie on a process mesh: each parameter's spec and
    its slots' (mesh.state_sharding, zero1 when asked), and the 'data' and
    'model' groups."""

    def __init__(self, mesh: Mesh, names: Sequence[str], params: Sequence[torch.Tensor],
                 zero1: bool = False):
        self.mesh = mesh
        self.names = list(names)
        tp = int(mesh.shape.get("model", 1))
        shapes = {}
        for name, p in zip(self.names, params):
            shape = list(p.shape)
            spec = param_partition_spec(name, p.dim(), mesh)
            if "model" in spec:
                shape[spec.index("model")] *= tp
            shapes[name] = shape
        specs = state_sharding(mesh, shapes, zero1=zero1, slots=("mu",))
        self.param_specs = [specs["params"][n] for n in self.names]
        self.slot_specs = [specs["mu"][n] for n in self.names]
        self.zero1_axes = [s.index("data") if "data" in s else None for s in self.slot_specs]
        self.n_data = int(mesh.shape.get("data", 1))
        self.data_index = mesh.coordinate("data")
        self.data_group, self.model_group = mesh.group("data"), mesh.group("model")

    def slot_view(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of tensor i (a view), or t itself."""
        ax = self.zero1_axes[i]
        if ax is None:
            return t
        k = t.shape[ax] // self.n_data
        return t.narrow(ax, self.data_index * k, k)

    def norm(self, tensors: Sequence[torch.Tensor], sliced: bool) -> torch.Tensor:
        """The global norm of the whole tensors that `tensors` are this
        rank's parts of: parameter-shaped (sliced=False: only 'model'
        shares) or slot-shaped (sliced=True: ZeRO-1 slices too). Each part's
        squares are summed over the groups that split it, and counted once."""
        sq = [n.square() for n in torch._foreach_norm([t.to(torch.float32) for t in tensors])]
        zero = torch.zeros((), device=sq[0].device) if sq else torch.zeros(())
        kinds = {(m, d): zero.clone() for m in (False, True) for d in (False, True)}
        for i, s in enumerate(sq):
            key = ("model" in self.param_specs[i],
                   sliced and self.zero1_axes[i] is not None)
            kinds[key] = kinds[key] + s
        by_model = torch.stack([kinds[(True, False)], kinds[(True, True)]])
        collectives.all_reduce_(by_model, self.model_group)
        by_data = torch.stack([kinds[(False, True)], by_model[1]])
        collectives.all_reduce_(by_data, self.data_group)
        return torch.sqrt(kinds[(False, False)] + by_model[0] + by_data[0] + by_data[1])

    def gather_slices_(self, params: Sequence[torch.Tensor]) -> None:
        """After a ZeRO-1 update of each rank's slices: every rank's updated
        slices, one flat all_gather over 'data', copied into the parameters."""
        idx = [i for i, ax in enumerate(self.zero1_axes) if ax is not None]
        if not idx or self.n_data == 1:
            return
        mine = [self.slot_view(i, params[i]) for i in idx]
        flat = torch.cat([m.reshape(-1) for m in mine])
        parts = collectives.all_gather(flat, self.data_group)
        for j, part in enumerate(parts):
            if j == self.data_index:
                continue
            offset = 0
            for i, m in zip(idx, mine):
                ax = self.zero1_axes[i]
                dst = params[i].narrow(ax, j * m.shape[ax], m.shape[ax])
                dst.copy_(part[offset:offset + m.numel()].view(m.shape))
                offset += m.numel()


class AdamW:
    """The JAX optimizer chain on a list of float32 parameters (see the
    module docstring). `step(grads)` updates the parameters in place. With
    a ParallelLayout, the parameters are this rank's shares and the slots
    may be ZeRO-1 slices."""

    def __init__(self, params: List[torch.Tensor], cfg: TrainConfig, steps_per_epoch: int,
                 layout: Optional[ParallelLayout] = None):
        if cfg.mu_dtype not in MU_DTYPES:
            raise ValueError(f"mu_dtype {cfg.mu_dtype!r} not in {tuple(MU_DTYPES)}")
        self.params = list(params)
        self.cfg = cfg
        self.layout = layout
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        mu_dtype = MU_DTYPES[cfg.mu_dtype]
        self.count = 0  # the inner optimizer's updates so far (optax's count)
        slots = self._slots(self.params)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in slots]
        self.nu = [torch.zeros_like(p) for p in slots]
        self.k = max(1, cfg.accumulation_steps)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in slots] if self.k > 1 else None

    def _slots(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """tensors cut to the slots' shapes: the ZeRO-1 slices (views)."""
        if self.layout is None:
            return list(tensors)
        return [self.layout.slot_view(i, t) for i, t in enumerate(tensors)]

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the (averaged) gradients of the parameters."""
        if self.layout is None:
            return global_norm(grads)
        return self.layout.norm(grads, sliced=False)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = [g.to(torch.float32) for g in self._slots(grads)]
        if self.acc is not None:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return
            grads = self.acc
            self.acc = [torch.zeros_like(p) for p in grads]
            self.mini_step = 0
        self._update(grads, self._slots(self.params))
        if self.layout is not None:
            self.layout.gather_slices_(self.params)

    def _update(self, grads: List[torch.Tensor], params: List[torch.Tensor]) -> None:
        cfg = self.cfg
        b1, b2, eps = 0.9, 0.999, 1e-8
        # clip_by_global_norm: g where norm < max_norm, else g · (max_norm /
        # norm); the factor stays on the device, so no host sync decides it
        norm = global_norm(grads) if self.layout is None else self.layout.norm(grads, True)
        torch._foreach_mul_(grads, torch.where(norm < cfg.grad_clip_norm, 1.0,
                                               cfg.grad_clip_norm / norm))
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, eps)
        # the decoupled decay, p · (1 − lr·wd), then p − lr · m̂ / (√v̂ + eps)
        torch._foreach_mul_(params, 1 - lr * cfg.weight_decay)
        if self.mu[0].dtype == params[0].dtype:
            torch._foreach_lerp_(self.mu, grads, 1 - b1)
            torch._foreach_addcdiv_(params, self.mu, denom, -lr / bc1)
            return
        # m stored in another dtype (bf16): b1 · m in that dtype (b1 rounded
        # to it, as JAX rounds a weak scalar), the sum and the update in
        # float32, then m rounded for storage
        m = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m, [(t * torch.tensor(b1, dtype=t.dtype)).to(torch.float32)
                                for t in self.mu])
        torch._foreach_addcdiv_(params, m, denom, -lr / bc1)
        for mu, new in zip(self.mu, m):
            mu.copy_(new)

    def state_dict(self) -> Dict:
        """This rank's state (its slices of the slots)."""
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "acc": self.acc}

    def full_state_dict(self) -> Dict:
        """The state with every slot gathered to its parameter's full shape
        (collective on a process mesh), as a one-device optimizer holds it."""
        out = self.state_dict()
        if self.layout is None:
            return out
        lay = self.layout
        for name in ("mu", "nu", "acc"):
            if out[name] is not None:
                out[name] = [gather_full(lay.names[i], t, lay.slot_specs[i], lay.mesh)
                             for i, t in enumerate(out[name])]
        return out

    def load_full_state_dict(self, state: Dict) -> None:
        """Load a full state (full_state_dict, or a one-device optimizer's):
        each slot is cut to this rank's part first."""
        if self.layout is not None:
            lay = self.layout
            state = dict(state)
            for name in ("mu", "nu", "acc"):
                if state[name] is not None:
                    state[name] = [slice_for_rank(lay.names[i], t, lay.slot_specs[i], lay.mesh)
                                   for i, t in enumerate(state[name])]
        self.load_state_dict(state)

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if (mine is None) != (theirs is None) or (mine and len(mine) != len(theirs)):
                raise ValueError(f"optimizer state {name!r} does not match this optimizer")
            for dst, src in zip(mine or (), theirs or ()):
                dst.copy_(src)


class TrainState:
    """The model (whose float32 parameters are the master weights), its
    optimizer and the step count: what the JAX TrainState holds."""

    def __init__(self, model: torch.nn.Module, tx: AdamW, step: int = 0):
        self.model = model
        self.tx = tx
        self.step = step

    @property
    def params(self) -> List[torch.Tensor]:
        return self.tx.params

    def apply_gradients(self, grads: List[torch.Tensor]) -> "TrainState":
        self.tx.step(grads)
        self.step += 1
        return self


def create_train_state(model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int,
                       params: Optional[List[torch.Tensor]] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A TrainState over `params` (default: every parameter of the model that
    requires grad, in module order). With a process mesh the optimizer gets
    the ParallelLayout of the model's (tensor-parallel, already sharded)
    parameters, ZeRO-1 slots when cfg.zero1."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if params is None:
        params = [p for _, p in named]
    layout = None
    if mesh is not None and mesh.over_processes:
        if [id(p) for p in params] != [id(p) for _, p in named]:
            raise ValueError("on a process mesh the train state holds every trainable "
                             "parameter of the model, in module order")
        layout = ParallelLayout(mesh, [n for n, _ in named], params, zero1=cfg.zero1)
    return TrainState(model, AdamW(params, cfg, steps_per_epoch, layout))
