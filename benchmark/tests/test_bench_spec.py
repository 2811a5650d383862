"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its file: configuration, traffic, path, limits and metric readers."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.run import load_module, metric_module
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and all(text_ok(w) for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (REPO / p).is_dir()


def test_names_units_and_texts():
    names = [e["name"] for e in SPEC["configs"] + SPEC["workloads"] + METRICS]
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for name in names:
        assert NAME.match(name), name
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and text_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert text_ok(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in SPEC["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from benchmark.run import cell_metrics

    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in cell_metrics(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(SPEC, w["name"], True)


def test_a_layer_is_named_alike_in_every_metric():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_file_agrees_with_the_spec(metric):
    module = metric_module(REPO, metric["name"])
    assert module.UNIT == metric["unit"] and module.SOURCE == metric["source"]
    if "layer" in metric:
        assert module.LAYER == metric["layer"] and module.MOVES == metric["moves"]
    assert callable(module.read)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=[w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    config = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg = json.loads((REPO / config["file"]).read_text())
    for key in config["reduced"]:
        assert key in cfg.get("published", {}) and cfg["published"][key] != cfg[key]
        assert not key.endswith(("_dim", "_rank", "_heads")) and "ratio" not in key
    traffic = json.loads((REPO / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    path = load_module(REPO / "benchmark" / "paths" / f"{traffic['path']}.py", "p")
    assert path.UNITS and callable(path.check) and callable(path.make_pool)
    limits = json.loads((REPO / "benchmark" / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=[c["name"] for c in SPEC["configs"]])
def test_config_names_its_family(config):
    """A configuration file names its family's module, which gives the
    weights' layout, the tiny form of the tests and the tensors that the
    weights' head_out_scale and z_bias set."""
    from benchmark.modules import family

    cfg = json.loads((REPO / config["file"]).read_text())
    assert NAME.match(cfg["reference"])
    module = family(REPO, cfg)
    assert callable(module.param_shapes) and callable(module.tiny_config)
    if "head_out_scale" in cfg["weights"]:
        assert callable(module.head_out_weights)
    if "z_bias" in cfg["weights"]:
        assert callable(module.z_channels)


def test_files_under_paths_are_named_from_name_characters():
    for p in (REPO / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
