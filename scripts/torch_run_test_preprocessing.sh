#!/bin/bash
# Preprocessing smoke test of the PyTorch/CUDA port on one thermal PNG
# (counterpart of run_test_preprocessing.sh): single-image inference, then
# the frame's contrast-enhanced range and fixed-range mean, on the card.
set -euo pipefail

IMG="${1:?usage: torch_run_test_preprocessing.sh <thermal.png> [output_dir]}"
OUT="${2:-preprocess_smoke}"

python -m thermal3d_torch.cli.infer --img_path "$IMG" --output_dir "$OUT" --no_vis
python - "$IMG" <<'PY'
import sys

import torch

from thermal3d_torch.core.device import resolve_device
from thermal3d_torch.preprocess.enhance import enhance_thermal_contrast, enhance_thermal_fixed_range
from thermal3d_torch.preprocess.io import load_thermal_image

gray = load_thermal_image(sys.argv[1], normalize=True)
if gray is None:
    sys.exit(f"decode failed: {sys.argv[1]}")
frame = torch.from_numpy(gray).to(resolve_device(None))
enh = enhance_thermal_contrast(frame).cpu().numpy()
fixed = enhance_thermal_fixed_range(frame).cpu().numpy()
print(f"decoded {gray.shape}; contrast-enhanced range [{enh.min():.3f},{enh.max():.3f}]; "
      f"fixed-range mean {fixed.mean():.3f}")
PY
