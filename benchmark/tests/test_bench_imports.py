"""The benchmark loads no module whose top-level name is jax, jaxlib, flax or
thermal3d (compared whole: the port's name begins with the JAX package's),
and the reference loads nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.imports import FORBIDDEN, forbidden_loaded, loaded
from benchmark.tests.conftest import REPO

RUN_TINY = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from benchmark.tests.conftest import build_tiny_root
from benchmark.run import run_cell, load_module
import benchmark.control
root = Path({tmp!r})
spec = build_tiny_root(root)
for cell in spec["workloads"]:
    run_cell(root, spec, cell, 1, 0.2, True, "cpu", log=lambda *a, **k: None,
             start=time.perf_counter())
for p in (Path({repo!r}) / "benchmark" / "metrics").glob("*.py"):
    load_module(p, "m_" + p.stem.replace(".", "_"))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {repo!r})
import benchmark.reference.model, benchmark.reference.preprocess, benchmark.reference.geometry
import benchmark.weights
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level_names(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    names = top_level_names(RUN_TINY.format(repo=str(REPO), tmp=str(tmp_path)))
    assert "thermal3d_torch" in names  # the run did drive the port
    assert not set(names) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = top_level_names(REFERENCE_ONLY.format(repo=str(REPO)))
    assert not set(names) & {"thermal3d_torch", *FORBIDDEN}


def test_names_are_compared_whole():
    modules = {"thermal3d_torch": None, "thermal3d_torch.kernels": None, "jaxtyping": None}
    assert forbidden_loaded(modules) == []
    assert loaded(("thermal3d_torch",), modules) == ["thermal3d_torch"]
    assert forbidden_loaded({"jax.numpy": None, "thermal3d.core": None}) == ["jax", "thermal3d"]
