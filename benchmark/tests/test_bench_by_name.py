"""The harness finds a cell, a configuration, a traffic mix and a metric by
name from files: a later change adds them with new files and new
BENCHMARK.json entries, and edits no file that is there."""

from __future__ import annotations

import json
import re
import time

from benchmark.run import cell_metrics, run_cell
from benchmark.tests.conftest import REPO, build_tiny_root

DUMMY_METRIC = '''"""Frames a request (a dummy per-layer metric of the test)."""

UNIT = "frames"
SOURCE = "host_clock"
LAYER = "entry"
MOVES = "frames_per_s"


def read(run):
    return float(run.units)
'''


def test_a_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    spec = build_tiny_root(tmp_path)
    serve = next(w for w in spec["workloads"] if w["config"] == "dustr224_linear")
    config = next(c for c in spec["configs"] if c["name"] == "dustr224_linear")
    bench = tmp_path / "benchmark"

    cfg = json.loads((tmp_path / config["file"]).read_text())
    cfg["dec_depth"] = 1
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / f"{serve['traffic']}.json").read_text())
    traffic["frames"] = 3
    (bench / "traffic" / "dummy-traffic.json").write_text(json.dumps(traffic))
    (bench / "limits" / "dummy-cell.json").write_text(json.dumps({"depth_rel_rms": 1e-4}))
    (bench / "metrics" / "dummy_units.serve.py").write_text(DUMMY_METRIC)
    spec["configs"].append(dict(config, name="dummy_cfg", file="benchmark/configs/dummy_cfg.json"))
    cell = dict(serve, name="dummy-cell", config="dummy_cfg", traffic="dummy-traffic")
    spec["workloads"].append(cell)
    for m in spec["end_to_end"]:
        if "workloads" in m and serve["name"] in m["workloads"]:
            m["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_units.serve", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "frames_per_s",
                              "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_cell(tmp_path, spec, cell, 5, 0.3, True, "cpu", log=lambda *a, **k: None,
                   start=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["dummy_units.serve"]["value"] == 3.0
    untraced = run_cell(tmp_path, spec, cell, 5, 0.3, False, "cpu", log=lambda *a, **k: None,
                        start=time.perf_counter())
    assert {"frames_per_s", "latency_p95_ms", "setup_s"} <= set(untraced["metrics"])
    assert "dummy_units.serve" not in untraced["metrics"]


def test_per_layer_metrics_follow_their_workloads():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        e2e = {m["name"] for m in cell_metrics(spec, w["name"], False)}
        for m in cell_metrics(spec, w["name"], True):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_the_harness_names_no_cell_config_traffic_or_metric():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    names = ([w["name"] for w in spec["workloads"]] + [c["name"] for c in spec["configs"]]
             + [w["traffic"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    for module in ("run.py", "loop.py", "trace.py", "inputs.py", "weights.py", "control.py",
                   "compare.py", "program.py", "counts.py", "peaks.py", "imports.py"):
        src = (REPO / "benchmark" / module).read_text()
        for name in names:
            assert not re.search(rf"(?<![\w.]){re.escape(name)}(?![\w])", src), (module, name)
