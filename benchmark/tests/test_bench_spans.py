"""The readers of the program's spans (`program_span` metrics over
thermal3d_torch.core.profiling's registry) on each request path's Program,
run on the CPU at a tiny size under a profiler."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import loop
from benchmark.run import load_module, metric_module
from benchmark.tests.conftest import REPO, tiny_config, tiny_traffic
from benchmark.weights import make_weights

READERS = {"serve": ("dispatch_ms.serve", "host_copy_ms.serve"),
           "pseudo_gt": ("dispatch_ms.pgt", "geometry_ms.pgt", "host_copy_ms.pgt",
                         "heads_ms.pgt")}
HOST_ONLY = {"heads_ms.pgt"}  # device ms: None without a card
CELLS = {"serve": ("dustr224_linear", "thermal-u16-b128"),
         "pseudo_gt": ("mastr512_catmlpdpt", "rgb-pairs-b8")}


def traced_slice(path_name: str, n: int = 3, seed: int = 2**31 + 5):
    """n requests of the path's Program under torch.profiler, the registry
    emptied first; returns a run as the readers see it."""
    from thermal3d_torch.core import profiling

    config, traffic_name = CELLS[path_name]
    cfg = tiny_config(json.loads((REPO / "benchmark" / "configs" / f"{config}.json")
                                 .read_text()), "float32")
    traffic = tiny_traffic(json.loads((REPO / "benchmark" / "traffic" / f"{traffic_name}.json")
                                      .read_text()))
    path = load_module(REPO / "benchmark" / "paths" / f"{path_name}.py", "spans_" + path_name)
    pool = path.make_pool(traffic, seed, "cpu")
    program = path.Program(cfg, traffic, make_weights(cfg, seed, "cpu"), "cpu")
    requests = ((i, path.request(pool, i % traffic["pool"])) for i in range(10 * n))
    program.finish(program.submit(next(requests)[1]))  # warm, untraced
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        loop.run_slice(program, requests, traffic["clients"], n, lambda: None)
    return SimpleNamespace(trace=SimpleNamespace(requests=n))


@pytest.mark.parametrize("path_name", sorted(READERS))
def test_span_readers_on_a_traced_slice(path_name):
    run = traced_slice(path_name)
    for name in READERS[path_name]:
        value = metric_module(REPO, name).read(run)
        if name in HOST_ONLY:
            assert value is None, name
        else:
            assert value is not None and value > 0, name


@pytest.mark.parametrize("path_name", sorted(READERS))
def test_span_readers_refuse_what_is_not_the_slice(path_name, monkeypatch):
    """None where the distinct request ids are not the slice's requests,
    without a traced slice, and on a program whose profiling module has no
    registry (a parent commit's)."""
    from thermal3d_torch.core import profiling

    run = traced_slice(path_name, n=2)
    for name in READERS[path_name]:
        reader = metric_module(REPO, name).read
        assert reader(SimpleNamespace(trace=SimpleNamespace(requests=3))) is None, name
        assert reader(SimpleNamespace(trace=None)) is None, name
    monkeypatch.delattr(profiling, "totals")
    for name in READERS[path_name]:
        assert metric_module(REPO, name).read(run) is None, name
