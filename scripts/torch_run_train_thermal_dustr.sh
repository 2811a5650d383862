#!/bin/bash
# Training wrapper of the PyTorch/CUDA port (counterpart of
# run_train_thermal_dustr.sh: img 224, frame_skip 3, thermal-aware
# multi-scale loss). Runs on the card; arguments given to this script are
# passed last, so they override a default (e.g. --device cpu).
set -euo pipefail

DATASET_DIR="${DATASET_DIR:-/data/freiburg}"
PSEUDO_GT_DIR="${PSEUDO_GT_DIR:-pseudo_gt}"
WEIGHTS="${WEIGHTS:-checkpoints/DUSt3R_ViTLarge_BaseDecoder_224_linear.pth}"
OUTPUT_MODEL="${OUTPUT_MODEL:-checkpoints/thermal_dustr_ft}"
EPOCHS="${EPOCHS:-50}"
BATCH_SIZE="${BATCH_SIZE:-4}"
LR="${LR:-5e-4}"

python -m thermal3d_torch.cli.train \
    --dataset_dir "$DATASET_DIR" \
    --pseudo_gt_dir "$PSEUDO_GT_DIR" \
    --weights "$WEIGHTS" \
    --output_model "$OUTPUT_MODEL" \
    --epochs "$EPOCHS" \
    --batch_size "$BATCH_SIZE" \
    --lr "$LR" \
    --img_size 224 224 \
    --frame_skip 3 \
    --log_interval 100 \
    --use_thermal_aware_loss \
    --multi_scale \
    "$@"
