"""Fixtures of the benchmark's own tests (run with `python -m pytest
benchmark/tests` from the repo root; CPU only, tiny sizes).

`tiny_root` builds a checkout-shaped directory whose BENCHMARK.json has the
real cells, paths, metrics, families and limits, with the configurations cut
to a tiny width by their family's `tiny_config` and the traffic to a few
small requests by its path's `TINY`, so that a whole run of the harness fits
a CPU test.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.modules import family, load_module

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True)
def _few_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def tiny_config(cfg: dict, dtype: str) -> dict:
    """The configuration cut to a tiny width by its family's module."""
    return family(REPO, cfg).tiny_config(cfg, dtype)


def tiny_traffic(traffic: dict) -> dict:
    """The traffic mix cut to a few small requests by its path's `TINY`."""
    path = load_module(REPO / "benchmark" / "paths" / f"{traffic['path']}.py",
                       "benchmark_path_" + traffic["path"])
    return dict(traffic, **path.TINY)


def build_tiny_root(tmp: Path, dtype: str = "float32", limits=None) -> dict:
    """A tiny copy of the benchmark under `tmp`; returns its BENCHMARK.json.
    `limits` ({cell: {number: limit}}) replaces the cells' limits files."""
    bench = tmp / "benchmark"
    for sub in ("paths", "metrics", "reference"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub, dirs_exist_ok=True)
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (tmp / c["file"]).write_text(json.dumps(tiny_config(cfg, dtype)))
    for w in spec["workloads"]:
        name = f"{w['traffic']}.json"
        traffic = tiny_traffic(json.loads((REPO / "benchmark" / "traffic" / name).read_text()))
        (bench / "traffic" / name).write_text(json.dumps(traffic))
        lim = (limits or {}).get(w["name"])
        if lim is None:
            lim = json.loads((REPO / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        (bench / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


@pytest.fixture
def tiny_root(tmp_path):
    spec = build_tiny_root(tmp_path)
    return tmp_path, spec


def workload(spec: dict, path: str) -> dict:
    """The spec's cell whose traffic runs the request path `path`."""
    for w in spec["workloads"]:
        traffic = json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        if traffic["path"] == path:
            return w
    raise KeyError(path)
