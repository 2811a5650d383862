"""Where the port runs (counterpart of thermal3d/core/platform.py).

Entry points run on the card. The CPU is used only when the caller names it,
as the tests do; a missing card is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None → 'cuda' (raises without CUDA); an explicit device is checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "thermal3d_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor on `device`: numpy input is copied there, a tensor
    moved (a no-op for one already there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)
