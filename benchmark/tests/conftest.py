"""Fixtures of the benchmark's own tests (run with `python -m pytest
benchmark/tests` from the repo root; CPU only, tiny sizes).

`tiny_root` builds a checkout-shaped directory whose BENCHMARK.json has the
real cells, paths, metrics and limits, with the configurations cut to a tiny
width and the traffic to a few small requests, so that a whole run of the
harness fits a CPU test.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_MODEL = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2, dec_embed_dim=48,
                  dec_depth=2, dec_num_heads=2)
TINY_DPT = dict(feature_dim=32, last_dim=16, dpt_layer_dims=[8, 16, 24, 32])
TINY_TRAFFIC = {
    "serve": dict(frames=4, height=40, width=48, pool=3, warmup_requests=2, trace_requests=4,
                  checked_requests=2, scene_cells=[3, 4]),
    "pseudo_gt": dict(pairs=2, size=64, max_shift=4, pool=3, warmup_requests=2,
                      trace_requests=4, checked_requests=2, scene_cells=[3, 3]),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture(autouse=True)
def _few_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def tiny_config(cfg: dict, dtype: str) -> dict:
    cfg = dict(cfg, dtype=dtype, **TINY_MODEL)
    if cfg["head_type"] == "linear":
        cfg["img_size"] = [32, 32]
    else:
        cfg.update(img_size=[64, 64], **TINY_DPT)
    return cfg


def build_tiny_root(tmp: Path, dtype: str = "float32", limits=None) -> dict:
    """A tiny copy of the benchmark under `tmp`; returns its BENCHMARK.json.
    `limits` ({cell: {number: limit}}) replaces the cells' limits files."""
    bench = tmp / "benchmark"
    for sub in ("paths", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, bench / sub, dirs_exist_ok=True)
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (tmp / c["file"]).write_text(json.dumps(tiny_config(cfg, dtype)))
    for w in spec["workloads"]:
        name = f"{w['traffic']}.json"
        traffic = json.loads((REPO / "benchmark" / "traffic" / name).read_text())
        traffic.update(TINY_TRAFFIC[traffic["path"]])
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
