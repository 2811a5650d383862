"""The port stands alone: thermal3d_torch and chip_smoke.py import nothing of
JAX, Flax or the JAX package (not even its JAX-free modules), nor the test
oracle, nor cv2, PIL, matplotlib or wandb (the card's machine has none of
them); its workflow wrappers name neither jax nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|cv2|PIL|matplotlib|wandb)\b"
    r"|from\s+(jax|flax|cv2|PIL|matplotlib|wandb)\b"
    r"|import\s+thermal3d(?!_torch)\b|from\s+thermal3d(?!_torch)\b)"
    r"|torch_oracle", re.MULTILINE)


def _port_files():
    return sorted(ROOT.glob("thermal3d_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_wrappers_name_no_jax_or_reference():
    """The workflow wrappers scripts/torch_run_*.sh run the port's CLIs and
    name neither jax nor a module of the JAX package."""
    wrappers = sorted(ROOT.glob("scripts/torch_run_*.sh"))
    assert len(wrappers) == 5
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)}" for f in wrappers
            for m in re.finditer(r"thermal3d\.|jax", f.read_text(), re.IGNORECASE)]
    assert not hits, hits


def test_pattern_catches_what_it_must():
    for bad in ("import jax", "from jax import numpy", "import flax.linen as nn",
                "from thermal3d.core import config", "import thermal3d",
                "    from thermal3d.models import rope", "from tests import torch_oracle",
                "import cv2", "from PIL import Image", "    import matplotlib.pyplot as plt",
                "        import wandb", "from wandb import Image"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from thermal3d_torch.models import rope", "import thermal3d_torch",
               "import torch", "jaxlike = 1"):
        assert not FORBIDDEN.search(ok), ok


def test_importing_the_port_loads_no_jax():
    """Every port module imports in a fresh interpreter without loading jax,
    flax, thermal3d, cv2, PIL, matplotlib or wandb."""
    mods = sorted(".".join(f.relative_to(ROOT).with_suffix("").parts)
                  for f in ROOT.glob("thermal3d_torch/**/*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'flax', 'thermal3d', 'cv2', 'PIL', 'matplotlib', 'wandb')]\n"
              "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
