"""The training loop: epochs, validation, early stopping, checkpoints
(counterpart of thermal3d/train/loop.py).

The reference's orchestration: a 0.8/0.2 split, the epoch-stepped schedule,
the best-on-validation checkpoint beside a rolling last one, early-stop
patience 10 and the max_batches quick-test cap. Step metrics stay on the
device and are fetched once per log_interval window. A resumed run restores
the model, the optimizer, the step and the loop's epoch, best_val and
patience; its loaders are built fresh, so their shuffle epoch restarts at 0,
as the JAX loop's do.

Over processes (core/distributed.py: one process a device, under torchrun or
cli.train --multihost) every rank runs this loop in lockstep on its mesh
position (cfg.mesh_shape / cfg.mesh_axes, core/mesh.py): the model is cut to
its tensor-parallel share, the loaders feed each 'data' position its rows
of every global batch (the final validation batch padded, its real rows
counted; a batch that a sample failing to load leaves short on one rank
skipped by every rank), the validation sums are all-reduced over 'data' so
every rank takes the same early-stop and checkpoint decisions, checkpoints
gather full tensors, and only the coordinator logs. The JAX loop's
fallback to the largest device count that divides the batch cannot drop
processes: an indivisible batch raises instead.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from thermal3d_torch.core import collectives
from thermal3d_torch.core.config import TrainConfig
from thermal3d_torch.core.distributed import is_coordinator, process_info
from thermal3d_torch.core.mesh import Mesh, make_mesh, resolve_shape, shard_model_
from thermal3d_torch.data.pipeline import BatchLoader, PinnedStage, split_index
from thermal3d_torch.train.checkpoint import CheckpointManager
from thermal3d_torch.train.logging import MetricLogger
from thermal3d_torch.train.state import create_train_state, make_lr_schedule
from thermal3d_torch.train.step import make_eval_step, make_train_step

SCALAR_KEYS = ("loss", "basic_loss", "edge_loss", "smoothness_loss", "detail_loss")


def training_mesh(cfg: TrainConfig, device: torch.device) -> Mesh:
    """The mesh of cfg.mesh_shape / cfg.mesh_axes over the processes of the
    job (one position a process; a single process without a group: the
    one-position mesh on `device`). Raises ValueError when the shape does
    not hold the world's process count: training runs one process per
    device, so a larger mesh needs torchrun (or --multihost)."""
    _, world = process_info()
    shape = resolve_shape(cfg.mesh_shape, world)
    if len(shape) != len(cfg.mesh_axes):
        raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} has {len(shape)} axes but "
                         f"mesh_axes names {len(cfg.mesh_axes)}: {tuple(cfg.mesh_axes)}")
    if int(np.prod(shape)) != world:
        need = int(np.prod([s for s in cfg.mesh_shape if s != -1]))
        raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} needs {need} processes (one a "
                         f"device) but this job has {world}: launch them with torchrun "
                         f"--nproc_per_node {need} -m thermal3d_torch.cli.train (or --multihost)")
    if world == 1:
        return make_mesh(shape, cfg.mesh_axes, devices=[device])
    return make_mesh(shape, cfg.mesh_axes)


def train_and_evaluate(model: torch.nn.Module, dataset, cfg: TrainConfig,
                       checkpoint_dir: Optional[str] = None,
                       logger: Optional[MetricLogger] = None, resume: bool = False,
                       enhance_impl: str = "auto", mesh: Optional[Mesh] = None
                       ) -> Dict[str, float]:
    """Train `model` (from trainable_model, full weights, on its device) on
    `dataset`. mesh: None builds training_mesh(cfg, device); on a mesh with
    a 'model' axis the model is sharded in place (core.mesh.shard_model_).
    Returns best_val_loss, epochs_run and final_step."""
    device = next(model.parameters()).device
    if mesh is None:
        mesh = training_mesh(cfg, device)
    if not mesh.over_processes and mesh.size > 1:
        raise ValueError(f"training runs one process per device, not one process over {mesh}: "
                         "launch one process a device with torchrun (or --multihost)")
    n_data = int(mesh.shape.get("data", 1))
    if cfg.batch_size % n_data:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by the data-parallel size "
                         f"{n_data} of a world of {process_info()[1]} process(es): processes "
                         "cannot be dropped; choose a batch size the 'data' axis divides")
    shard_model_(model, mesh)
    pid, data_group = mesh.coordinate("data"), mesh.group("data")
    log = logger.log if logger is not None else MetricLogger(use_wandb=False).log
    if not is_coordinator():
        log = lambda _metrics: None  # noqa: E731  (the coordinator logs)

    train_idx, val_idx = split_index(len(dataset), cfg.val_fraction, cfg.seed)
    # a batch one 'data' rank cannot fill is skipped by every rank (a vote)
    agree = mesh.all_agree if n_data > 1 else None
    train_loader = BatchLoader(dataset, train_idx, cfg.batch_size, shuffle=True, seed=cfg.seed,
                               process_id=pid, process_count=n_data, agree=agree)
    val_loader = BatchLoader(dataset, val_idx, cfg.batch_size, shuffle=False, drop_last=False,
                             process_id=pid, process_count=n_data, agree=agree)
    steps_per_epoch = max(1, len(train_loader))
    state = create_train_state(model, cfg, steps_per_epoch, mesh=mesh)
    lr_schedule = make_lr_schedule(cfg, steps_per_epoch)

    ckpt = CheckpointManager(checkpoint_dir, mesh=mesh) if checkpoint_dir else None
    start_epoch, best_val, patience_counter = 0, math.inf, 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        start_epoch = int(meta.get("epoch", 0))
        best_val = float(meta.get("best_val", meta.get("val_loss", math.inf)))
        patience_counter = int(meta.get("patience", 0))
    train_step = make_train_step(model, cfg, enhance_impl, mesh=mesh)
    eval_step = make_eval_step(model, cfg, enhance_impl)
    stage = PinnedStage(device)

    global_step = state.step
    epochs_run = 0

    def flush_logs(pending):
        """One host fetch for a window of per-step device scalars."""
        if not pending:
            return 0.0, 0
        keys = [k for k in SCALAR_KEYS if k in pending[0][1]]
        fetched = torch.stack([torch.stack([m[k] for k in keys]) for _, m in pending]).cpu()
        run, n = 0.0, 0
        for (gs, _), row in zip(pending, fetched.tolist()):
            vals = dict(zip(keys, row))
            loss = vals["loss"]
            if np.isfinite(loss):
                run += loss
                n += 1
            log({
                "batch_loss": loss,
                "basic_loss": vals.get("basic_loss", math.nan),
                "edge_loss": vals.get("edge_loss", 0.0) * cfg.loss.edge_weight,
                "smoothness_loss": vals.get("smoothness_loss", 0.0) * cfg.loss.smoothness_weight,
                "detail_loss": vals.get("detail_loss", 0.0) * cfg.loss.detail_weight,
                "learning_rate": lr_schedule(gs - 1),
                "global_step": gs,
            })
        pending.clear()
        return run, n

    for epoch in range(start_epoch, cfg.epochs):
        epoch_t0 = time.time()
        running, nb = 0.0, 0
        pending = []  # (global_step, device-scalar dict) awaiting one fetch
        for bi, batch in enumerate(train_loader):
            if cfg.max_batches is not None and bi >= cfg.max_batches:
                break
            if "pointmap1" not in batch:
                continue
            state, metrics = train_step(state, stage.put(batch))
            global_step += 1
            pending.append((global_step, {k: metrics[k] for k in SCALAR_KEYS if k in metrics}))
            # the first batch, then every log_interval (the reference's
            # `batch_idx % log_interval == 0`)
            if cfg.log_interval and (global_step - 1) % cfg.log_interval == 0:
                r, n = flush_logs(pending)
                running += r
                nb += n
                # no sample panels: the reference's logger drops them
                # without wandb (ROADMAP: not carried over)
        r, n = flush_logs(pending)
        running += r
        nb += n
        if nb:
            log({"epoch": epoch + 1, "train_loss": running / nb,
                        "epoch_seconds": time.time() - epoch_t0})

        # validation (plain L1); a short last batch is padded to the batch
        # size (this rank's rows of it) and averaged over its real samples
        # only: a rank whose slice is all padding still joins the step
        local_bs = cfg.batch_size // n_data
        val_sum, val_n = 0.0, 0
        for bi, batch in enumerate(val_loader):
            if cfg.max_batches is not None and bi >= cfg.max_batches:
                break
            if "pointmap1" not in batch:
                continue
            n_rows = batch["thermal1"].shape[0]
            n_real = min(n_rows, val_loader.local_real_count(bi))
            if n_rows < local_bs:
                pad = local_bs - n_rows
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
            per_sample = eval_step(state, stage.put(batch)).cpu().numpy()
            val_sum += float(per_sample[:n_real].sum())
            val_n += n_real
        epochs_run = epoch + 1
        if n_data > 1:  # the global sums: every rank decides alike below
            sums = torch.tensor([val_sum, float(val_n)], dtype=torch.float64, device=device)
            collectives.all_reduce_(sums, data_group)
            val_sum, val_n = float(sums[0]), int(sums[1])
        if not val_n:
            continue
        val_loss = val_sum / val_n
        log({"epoch": epoch + 1, "val_loss": val_loss})

        improved = val_loss < best_val
        if improved:
            best_val = val_loss
            patience_counter = 0
        else:
            patience_counter += 1
        if ckpt is not None:
            meta = {"epoch": epoch + 1, "best_val": best_val, "patience": patience_counter}
            if improved:
                ckpt.save_best(epoch + 1, state, val_loss, meta)
            ckpt.save_last(epoch + 1, state, val_loss, meta)
        if patience_counter >= cfg.early_stop_patience:
            break

    if ckpt is not None:
        ckpt.close()
    return {"best_val_loss": best_val, "epochs_run": epochs_run, "final_step": global_step}
