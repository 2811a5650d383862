"""Modules of the benchmark found by name under a run's root.

A request path, a per-layer metric and a network family's reference each sit
in a file of their own and are loaded from it by file, so that a later
change adds one with a new file and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"benchmark: no module {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(root: Path, cfg: dict):
    """The reference module of a configuration's family:
    benchmark/reference/<cfg["reference"]>.py under `root`."""
    name = cfg["reference"]
    return load_module(Path(root) / "benchmark" / "reference" / f"{name}.py",
                       "benchmark_reference_" + name)
