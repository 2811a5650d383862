"""Training checkpoints in the port's own torch format (counterpart of
thermal3d/train/checkpoint.py, which writes orbax directories).

Two policies side by side under one directory:

  <dir>/best/<step>/ — best-validation checkpoints, the 3 with the lowest
                       val_loss kept
  <dir>/last/<step>/ — every epoch, only the newest kept, so a resume
                       continues from the true last epoch

Each step directory holds `model.pt` (the model's state dict), `optimizer.pt`
(the optimizer state and the train step) and `meta.json` (val_loss plus the
loop's epoch, best_val and patience). Saves copy every tensor to the host
first, write into a temporary directory and rename it into place, so a step
directory is complete or absent; when best and last save the same step of
the same state, the second hard-links the first's tensor files (a ViT-L
checkpoint is 5.4 GB). Resume priority: last, then best.

Checkpoints do not depend on the world size. On a process mesh
(`mesh=`, core/mesh.py) every rank takes part in a save, which gathers the
full, unsharded tensors (tensor-parallel weights over 'model', ZeRO-1
moments over 'data'), and only the coordinator writes them; every rank
restores the same files and cuts its own part out of them. So a
multi-process run resumes on another world size, and its checkpoint is a
one-device model's (`--weights` of cli.infer). The directory must be one
that every rank reads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from thermal3d_torch.core.distributed import is_coordinator
from thermal3d_torch.core.mesh import full_state_dict, load_full_state_dict_

MODEL_FILE, OPTIMIZER_FILE, META_FILE = "model.pt", "optimizer.pt", "meta.json"


def _host(obj):
    """A copy of obj with every tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, Mapping):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _steps(root: str) -> List[int]:
    """The complete step directories under root, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.exists(os.path.join(root, d, META_FILE)))


def _read_meta(root: str, step: int) -> Dict:
    with open(os.path.join(root, str(step), META_FILE)) as f:
        return json.load(f)


class _Policy:
    """One rolling set of step directories: keep the `keep` newest, or with
    by_val the `keep` of lowest val_loss."""

    def __init__(self, root: str, keep: int, by_val: bool):
        self.root, self.keep, self.by_val = root, keep, by_val

    def save(self, step: int, payload, val_loss: float, extra: Optional[dict],
             link_from: Optional[str] = None) -> str:
        """Write step `step`: payload, a function that returns the model's
        state dict and the optimizer's state (full, on the host); with
        link_from (a step directory of the same state) hard-link its tensor
        files instead. Returns the directory."""
        meta = {"val_loss": float(val_loss), **(extra or {})}
        tmp = os.path.join(self.root, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            for name in (MODEL_FILE, OPTIMIZER_FILE) if link_from else ():
                os.link(os.path.join(link_from, name), os.path.join(tmp, name))
        except OSError:  # no hard links here: write the files
            link_from = None
            shutil.rmtree(tmp)
            os.makedirs(tmp)
        if link_from is None:
            model_sd, opt = payload()
            torch.save(model_sd, os.path.join(tmp, MODEL_FILE))
            torch.save(opt, os.path.join(tmp, OPTIMIZER_FILE))
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        final = os.path.join(self.root, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.steps()
        if self.by_val:
            ranked = sorted(steps, key=lambda s: (_read_meta(self.root, s)["val_loss"], -s))
            drop = ranked[self.keep:]
        else:
            drop = steps[:-self.keep]
        for s in drop:
            shutil.rmtree(os.path.join(self.root, str(s)), ignore_errors=True)

    def steps(self) -> List[int]:
        return _steps(self.root)

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None


def _full_payload(state, mesh):
    """(model state dict, optimizer state) of `state`, full and on the host
    (collective on a process mesh)."""
    model_sd = full_state_dict(state.model, mesh)
    opt = _host(state.tx.full_state_dict())
    opt["train_step"] = int(state.step)
    return model_sd, opt


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh if mesh is not None and mesh.over_processes else None
        self._best = _Policy(os.path.join(self.directory, "best"), max_to_keep, by_val=True)
        self._last = _Policy(os.path.join(self.directory, "last"), 1, by_val=False)
        self._written = None  # ((step, state, state.step), directory) of the last save

    def _save(self, policy: _Policy, step: int, state, val_loss: float,
              extra: Optional[dict]) -> None:
        key = (step, id(state), int(state.step))
        if self.mesh is None:
            self._write(policy, step, key, lambda: _full_payload(state, None), val_loss, extra)
            return
        # every rank gathers the full tensors; the coordinator writes them
        payload = _full_payload(state, self.mesh)
        if is_coordinator():
            self._write(policy, step, key, lambda: payload, val_loss, extra)
        dist.barrier()

    def _write(self, policy: _Policy, step: int, key, payload, val_loss: float,
               extra: Optional[dict]) -> None:
        source = self._written[1] if self._written and self._written[0] == key else None
        if source is not None and not os.path.isdir(source):
            source = None
        self._written = (key, policy.save(step, payload, val_loss, extra, link_from=source))

    def _policies(self):
        """Resume priority: last (exact), then best."""
        return (self._last, self._best)

    def save(self, step: int, state, val_loss: float, extra: Optional[dict] = None) -> None:
        """Record a new BEST checkpoint (call on a validation improvement)."""
        self._save(self._best, step, state, val_loss, extra)

    save_best = save

    def save_last(self, step: int, state, val_loss: float,
                  extra: Optional[dict] = None) -> None:
        """Record the rolling LAST checkpoint (call every epoch)."""
        self._save(self._last, step, state, val_loss, extra)

    def latest_step(self) -> Optional[int]:
        for policy in self._policies():
            step = policy.latest()
            if step is not None:
                return step
        return None

    def best_step(self) -> Optional[int]:
        steps = self._best.steps()
        if not steps:
            return None
        return min(steps, key=lambda s: (_read_meta(self._best.root, s)["val_loss"], -s))

    def restore(self, state, step: Optional[int] = None) -> Tuple[Optional[object], Optional[Dict]]:
        """Load a checkpoint into `state` (a TrainState) in place: the LAST
        one when present, else the newest best; with `step`, the policy that
        holds that step. On a process mesh each rank cuts its part out of
        the full tensors. Returns (state, meta), or (None, None) if there is
        none."""
        policy = None
        if step is not None:
            policy = next((p for p in self._policies() if step in p.steps()), None)
            if policy is None:
                raise FileNotFoundError(f"step {step} not found under {self.directory}")
        else:
            policy = next((p for p in self._policies() if p.latest() is not None), None)
            if policy is None:
                return None, None
            step = policy.latest()
        path = os.path.join(policy.root, str(step))
        device = state.params[0].device if state.params else torch.device("cpu")
        load_full_state_dict_(
            state.model,
            torch.load(os.path.join(path, MODEL_FILE), map_location=device, weights_only=True),
            self.mesh)
        opt = torch.load(os.path.join(path, OPTIMIZER_FILE), map_location=device,
                         weights_only=True)
        state.step = int(opt.pop("train_step"))
        state.tx.load_full_state_dict(opt)
        return state, _read_meta(policy.root, step)

    def close(self) -> None:
        """Saves are synchronous: nothing is left in flight to wait for."""


def is_checkpoint_dir(directory: str) -> bool:
    """A directory of the port's checkpoints (best/, last/ or step
    directories at its root)."""
    return any(_steps(os.path.join(directory, sub)) for sub in ("best", "last", ""))


def load_params_from_checkpoint_dir(directory: str, step: Optional[int] = None
                                    ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Just the model's state dict (on the host) and meta of a checkpoint
    directory, for the inference CLIs: the newest best checkpoint first,
    then last, then step directories at the root."""
    directory = os.path.abspath(directory)
    for cand in (os.path.join(directory, "best"), os.path.join(directory, "last"), directory):
        steps = _steps(cand)
        if not steps or (step is not None and step not in steps):
            continue
        use = step if step is not None else steps[-1]
        state = torch.load(os.path.join(cand, str(use), MODEL_FILE), map_location="cpu",
                           weights_only=True)
        return state, _read_meta(cand, use)
    raise FileNotFoundError(f"no checkpoints under {directory}")
