#!/bin/bash
# Evaluation wrapper of the PyTorch/CUDA port (counterpart of
# run_evaluate_thermal_dustr.sh: img 224). MODEL is a .pth or a checkpoint
# directory of the training CLI. Arguments given to this script are passed
# last and override a default (e.g. --no_vis).
set -euo pipefail

MODEL="${MODEL:-checkpoints/thermal_dustr_ft_best.pth}"
THERMAL_DIR="${THERMAL_DIR:-/data/freiburg/test/night/ImagesIR}"
PSEUDO_GT_DIR="${PSEUDO_GT_DIR:-pseudo_gt_test_set/night/depth}"
OUTPUT_DIR="${OUTPUT_DIR:-thermal_evaluation_results}"

python -m thermal3d_torch.cli.evaluate \
    --model "$MODEL" \
    --thermal_dir "$THERMAL_DIR" \
    --pseudo_gt_dir "$PSEUDO_GT_DIR" \
    --output_dir "$OUTPUT_DIR" \
    --img_size 224 224 \
    "$@"
