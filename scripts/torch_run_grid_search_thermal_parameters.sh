#!/bin/bash
# Grid-search wrapper of the PyTorch/CUDA port (counterpart of
# run_grid_search_thermal_parameters.sh): edge {0.3,0.5,0.7} × smoothness
# {0.1,0.3,0.5}, 2-epoch runs. Arguments given to this script are passed
# last and override a default (e.g. --edge_weights 0.5 --epochs 1).
set -euo pipefail

DATASET_DIR="${DATASET_DIR:-/data/freiburg}"
PSEUDO_GT_DIR="${PSEUDO_GT_DIR:-pseudo_gt}"
WEIGHTS="${WEIGHTS:-checkpoints/DUSt3R_ViTLarge_BaseDecoder_224_linear.pth}"

python -m thermal3d_torch.cli.grid_search \
    --dataset_dir "$DATASET_DIR" \
    --pseudo_gt_dir "$PSEUDO_GT_DIR" \
    --weights "$WEIGHTS" \
    --edge_weights 0.3 0.5 0.7 \
    --smoothness_weights 0.1 0.3 0.5 \
    --epochs 2 \
    "$@"
