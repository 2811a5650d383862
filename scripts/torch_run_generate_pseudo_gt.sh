#!/bin/bash
# Pseudo-GT wrapper of the PyTorch/CUDA port (counterpart of
# run_generate_pseudo_gt.sh: MASt3R-512 at 512², frame_skip 5). Set
# CALIB_FILE to use a thermal calibration instead of the estimate.
# Arguments given to this script are passed last and override a default.
set -euo pipefail

DATASET_DIR="${DATASET_DIR:-/data/freiburg}"
OUTPUT_DIR="${OUTPUT_DIR:-pseudo_gt}"
WEIGHTS="${WEIGHTS:-checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth}"
CALIB_FILE="${CALIB_FILE:-}"

EXTRA=()
if [[ -n "$CALIB_FILE" ]]; then EXTRA+=(--calib_file "$CALIB_FILE"); fi

python -m thermal3d_torch.cli.pseudo_gt \
    --dataset_dir "$DATASET_DIR" \
    --output_dir "$OUTPUT_DIR" \
    --weights "$WEIGHTS" \
    --img_size 512 512 \
    --frame_skip 5 \
    "${EXTRA[@]}" \
    "$@"
