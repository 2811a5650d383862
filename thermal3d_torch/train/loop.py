"""The training loop: epochs, validation, early stopping, checkpoints
(counterpart of thermal3d/train/loop.py), on one device.

The reference's orchestration: a 0.8/0.2 split, the epoch-stepped schedule,
the best-on-validation checkpoint beside a rolling last one, early-stop
patience 10 and the max_batches quick-test cap. Step metrics stay on the
device and are fetched once per log_interval window. A resumed run restores
the model, the optimizer, the step and the loop's epoch, best_val and
patience; its loaders are built fresh, so their shuffle epoch restarts at 0,
as the JAX loop's do.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from thermal3d_torch.core.config import TrainConfig
from thermal3d_torch.data.pipeline import BatchLoader, PinnedStage, split_index
from thermal3d_torch.train.checkpoint import CheckpointManager
from thermal3d_torch.train.logging import MetricLogger
from thermal3d_torch.train.state import create_train_state, make_lr_schedule
from thermal3d_torch.train.step import make_eval_step, make_train_step

SCALAR_KEYS = ("loss", "basic_loss", "edge_loss", "smoothness_loss", "detail_loss")
MULTI_GPU = "ROADMAP Queue 1 item 11, multi-GPU"


def check_single_device(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for the TPU mesh options of TrainConfig."""
    if tuple(cfg.mesh_shape) not in ((-1,), (1,)) or cfg.zero1:
        raise NotImplementedError(f"mesh_shape {tuple(cfg.mesh_shape)} / zero1 are not "
                                  f"ported: one device only ({MULTI_GPU})")


def train_and_evaluate(model: torch.nn.Module, dataset, cfg: TrainConfig,
                       checkpoint_dir: Optional[str] = None,
                       logger: Optional[MetricLogger] = None, resume: bool = False,
                       enhance_impl: str = "auto") -> Dict[str, float]:
    """Train `model` (from trainable_model, on its device) on `dataset`.
    Returns best_val_loss, epochs_run and final_step."""
    check_single_device(cfg)
    device = next(model.parameters()).device
    if logger is None:
        logger = MetricLogger(use_wandb=False)

    train_idx, val_idx = split_index(len(dataset), cfg.val_fraction, cfg.seed)
    train_loader = BatchLoader(dataset, train_idx, cfg.batch_size, shuffle=True, seed=cfg.seed)
    val_loader = BatchLoader(dataset, val_idx, cfg.batch_size, shuffle=False, drop_last=False)
    steps_per_epoch = max(1, len(train_loader))
    state = create_train_state(model, cfg, steps_per_epoch)
    lr_schedule = make_lr_schedule(cfg, steps_per_epoch)

    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    start_epoch, best_val, patience_counter = 0, math.inf, 0
    if resume and ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        start_epoch = int(meta.get("epoch", 0))
        best_val = float(meta.get("best_val", meta.get("val_loss", math.inf)))
        patience_counter = int(meta.get("patience", 0))
    train_step = make_train_step(model, cfg, enhance_impl)
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
            logger.log({
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
            logger.log({"epoch": epoch + 1, "train_loss": running / nb,
                        "epoch_seconds": time.time() - epoch_t0})

        # validation (plain L1); a short last batch is padded to the batch
        # size and averaged over its real samples only
        val_sum, val_n = 0.0, 0
        for bi, batch in enumerate(val_loader):
            if cfg.max_batches is not None and bi >= cfg.max_batches:
                break
            if "pointmap1" not in batch:
                continue
            n_rows = batch["thermal1"].shape[0]
            n_real = min(n_rows, val_loader.local_real_count(bi))
            if n_rows < cfg.batch_size:
                pad = cfg.batch_size - n_rows
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
            per_sample = eval_step(state, stage.put(batch)).cpu().numpy()
            val_sum += float(per_sample[:n_real].sum())
            val_n += n_real
        epochs_run = epoch + 1
        if not val_n:
            continue
        val_loss = val_sum / val_n
        logger.log({"epoch": epoch + 1, "val_loss": val_loss})

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
