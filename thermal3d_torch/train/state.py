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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import TrainConfig

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


class AdamW:
    """The JAX optimizer chain on a list of float32 parameters (see the
    module docstring). `step(grads)` updates the parameters in place."""

    def __init__(self, params: List[torch.Tensor], cfg: TrainConfig, steps_per_epoch: int):
        if cfg.mu_dtype not in MU_DTYPES:
            raise ValueError(f"mu_dtype {cfg.mu_dtype!r} not in {tuple(MU_DTYPES)}")
        self.params = list(params)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        mu_dtype = MU_DTYPES[cfg.mu_dtype]
        self.count = 0  # the inner optimizer's updates so far (optax's count)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.k = max(1, cfg.accumulation_steps)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        grads = [g.to(torch.float32) for g in grads]
        if self.acc is not None:
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return
            grads = self.acc
            self.acc = [torch.zeros_like(p) for p in self.params]
            self.mini_step = 0
        self._update(grads)

    def _update(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        b1, b2, eps = 0.9, 0.999, 1e-8
        # clip_by_global_norm: g where norm < max_norm, else g · (max_norm /
        # norm); the factor stays on the device, so no host sync decides it
        norm = global_norm(grads)
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
        torch._foreach_mul_(self.params, 1 - lr * cfg.weight_decay)
        if self.mu[0].dtype == self.params[0].dtype:
            torch._foreach_lerp_(self.mu, grads, 1 - b1)
            torch._foreach_addcdiv_(self.params, self.mu, denom, -lr / bc1)
            return
        # m stored in another dtype (bf16): b1 · m in that dtype (b1 rounded
        # to it, as JAX rounds a weak scalar), the sum and the update in
        # float32, then m rounded for storage
        m = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(m, [(t * torch.tensor(b1, dtype=t.dtype)).to(torch.float32)
                                for t in self.mu])
        torch._foreach_addcdiv_(self.params, m, denom, -lr / bc1)
        for mu, new in zip(self.mu, m):
            mu.copy_(new)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "acc": self.acc}

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
                       params: Optional[List[torch.Tensor]] = None) -> TrainState:
    """A TrainState over `params` (default: every parameter of the model that
    requires grad, in module order)."""
    if params is None:
        params = [p for p in model.parameters() if p.requires_grad]
    return TrainState(model, AdamW(params, cfg, steps_per_epoch))
