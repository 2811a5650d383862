"""The harness finds a cell, a configuration, a traffic mix and a metric by
name from files: a later change adds them with new files and new
BENCHMARK.json entries, and edits no file that is there."""

from __future__ import annotations

import hashlib
import json
import re
import time

from benchmark.run import cell_metrics, load_module, run_cell
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
    assert {"frames_per_s", "setup_s"} <= set(untraced["metrics"])
    assert "dummy_units.serve" not in untraced["metrics"]


def test_per_layer_metrics_follow_their_workloads():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        e2e = {m["name"] for m in cell_metrics(spec, w["name"], False)}
        for m in cell_metrics(spec, w["name"], True):
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_the_harness_names_no_cell_config_traffic_or_metric():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    families = {json.loads((REPO / c["file"]).read_text())["reference"] for c in spec["configs"]}
    names = ([w["name"] for w in spec["workloads"]] + [c["name"] for c in spec["configs"]]
             + [w["traffic"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]] + sorted(families))
    for module in ("run.py", "loop.py", "trace.py", "inputs.py", "weights.py", "control.py",
                   "compare.py", "program.py", "counts.py", "peaks.py", "imports.py",
                   "modules.py"):
        src = (REPO / "benchmark" / module).read_text()
        for name in names:
            assert not re.search(rf"(?<![\w.]){re.escape(name)}(?![\w])", src), (module, name)
        for name in families:  # nor imports a family's module by its dotted or file path
            assert not re.search(rf"reference[./]{re.escape(name)}(?![\w])", src), (module, name)



# A model of another family, added as new files only: its reference module,
# configuration, traffic mix, request path, limits and one per-layer metric.
TOY_FAMILY = '''"""A toy family of the test: a plain ViT encoder (pre-norm blocks, a
learned position embedding) with a linear depth head, in float32."""

import math

import torch
import torch.nn.functional as F


def param_shapes(cfg):
    d, p = cfg["dim"], cfg["patch_size"]
    s = (cfg["img_size"][0] // p) * (cfg["img_size"][1] // p)
    out = [("patch.weight", (d, 3, p, p)), ("patch.bias", (d,)), ("pos_embed", (1, s, d))]
    for i in range(cfg["blocks"]):
        b = f"blocks.{i}"
        for name, rows, cols in (("qkv", 3 * d, d), ("proj", d, d), ("fc1", 4 * d, d),
                                 ("fc2", d, 4 * d)):
            out += [(f"{b}.{name}.weight", (rows, cols)), (f"{b}.{name}.bias", (rows,))]
        out += [(f"{b}.norm{j}.{k}", (d,)) for j in (1, 2) for k in ("weight", "bias")]
    return out + [("norm.weight", (d,)), ("norm.bias", (d,)), ("head.weight", (p * p, d)),
                  ("head.bias", (p * p,))]


def tiny_config(cfg, dtype):
    return dict(cfg, dtype=dtype, dim=16, blocks=2, heads=2, img_size=[16, 16])


def forward(params, cfg, img):
    """img [B, H, W, 3] -> depth [B, H, W]."""
    w = {k: v.float() for k, v in params.items()}
    p, heads = cfg["patch_size"], cfg["heads"]
    x = F.conv2d(img.float().permute(0, 3, 1, 2), w["patch.weight"], w["patch.bias"], stride=p)
    b, d, gh, gw = x.shape
    x = x.flatten(2).transpose(1, 2) + w["pos_embed"]
    for i in range(cfg["blocks"]):
        n = f"blocks.{i}."
        h = F.layer_norm(x, (d,), w[n + "norm1.weight"], w[n + "norm1.bias"], 1e-6)
        qkv = F.linear(h, w[n + "qkv.weight"], w[n + "qkv.bias"])
        q, k, v = qkv.reshape(b, -1, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads), dim=-1) @ v
        x = x + F.linear(a.transpose(1, 2).reshape(b, -1, d), w[n + "proj.weight"],
                         w[n + "proj.bias"])
        h = F.layer_norm(x, (d,), w[n + "norm2.weight"], w[n + "norm2.bias"], 1e-6)
        h = F.gelu(F.linear(h, w[n + "fc1.weight"], w[n + "fc1.bias"]))
        x = x + F.linear(h, w[n + "fc2.weight"], w[n + "fc2.bias"])
    x = F.layer_norm(x, (d,), w["norm.weight"], w["norm.bias"], 1e-6)
    out = F.linear(x, w["head.weight"], w["head.bias"])
    return F.pixel_shuffle(out.transpose(1, 2).reshape(b, p * p, gh, gw), p)[:, 0]
'''

TOY_PATH = '''"""A toy request path of the test: a request is a batch of RGB frames,
and its depth is computed by a program written apart from the family's
reference (unfolded patches, scaled_dot_product_attention)."""

from pathlib import Path

import torch
import torch.nn.functional as F

from benchmark.compare import Gaps
from benchmark.inputs import generator
from benchmark.modules import family

UNITS = "frames"
TINY = dict(frames=2, pool=3, warmup_requests=2, trace_requests=2, checked_requests=2)
ROOT = Path(__file__).resolve().parents[2]


def units(traffic):
    return traffic["frames"]


def make_pool(traffic, seed, device):
    shape = (traffic["pool"], traffic["frames"], traffic["size"], traffic["size"], 3)
    gen = generator(traffic, seed, device)
    return torch.rand(shape, generator=gen, device=device).cpu().numpy()


def request(pool, index):
    return pool[index]


class Program:
    def __init__(self, cfg, traffic, weights, device, variant=None):
        self.cfg, self.device = cfg, torch.device(device)
        self.w = {k: v.float() for k, v in weights.items()}

    def submit(self, frames):
        w, cfg = self.w, self.cfg
        p, heads = cfg["patch_size"], cfg["heads"]
        x = torch.from_numpy(frames).to(self.device)
        b, hh, ww, _ = x.shape
        patches = F.unfold(x.permute(0, 3, 1, 2), p, stride=p).transpose(1, 2)
        t = patches @ w["patch.weight"].flatten(1).T + w["patch.bias"] + w["pos_embed"]
        d = t.shape[-1]
        for i in range(cfg["blocks"]):
            n = f"blocks.{i}."
            h = F.layer_norm(t, (d,), w[n + "norm1.weight"], w[n + "norm1.bias"], 1e-6)
            qkv = (h @ w[n + "qkv.weight"].T + w[n + "qkv.bias"]).unflatten(-1, (3, heads, -1))
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).flatten(2)
            t = t + a @ w[n + "proj.weight"].T + w[n + "proj.bias"]
            h = F.layer_norm(t, (d,), w[n + "norm2.weight"], w[n + "norm2.bias"], 1e-6)
            h = F.gelu(h @ w[n + "fc1.weight"].T + w[n + "fc1.bias"])
            t = t + h @ w[n + "fc2.weight"].T + w[n + "fc2.bias"]
        t = F.layer_norm(t, (d,), w["norm.weight"], w["norm.bias"], 1e-6)
        out = t @ w["head.weight"].T + w["head.bias"]
        return out.reshape(b, hh // p, ww // p, p, p).permute(0, 1, 3, 2, 4).reshape(b, hh, ww)

    def finish(self, token):
        return {"depth": token.cpu().numpy()}


def check(cfg, traffic, params, samples, pool, device, variant=None):
    forward = family(ROOT, cfg).forward
    gaps = Gaps()
    for index, out in samples:
        ref = forward(params, cfg, torch.from_numpy(pool[index]).to(device))
        gaps.add("depth", torch.from_numpy(out["depth"]).to(device), ref)
    return gaps.readings()
'''

TOY_CONFIG = {"reference": "toyvit", "img_size": [224, 224], "patch_size": 4, "dim": 768,
              "blocks": 12, "heads": 12, "dtype": "bfloat16",
              "weights": {"stream": 1, "bias_std": 0.02, "norm_std": 0.02}}
TOY_TRAFFIC = {"path": "toy_depth", "frames": 2, "size": 16, "pool": 3, "clients": 2,
               "warmup_requests": 2, "trace_requests": 2, "checked_requests": 2, "stream": 2}


def tree_digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def appended_only(old, new) -> bool:
    """`new` is `old` with entries appended to its lists and nothing else."""
    if isinstance(old, dict):
        return (isinstance(new, dict) and set(old) == set(new)
                and all(appended_only(old[k], new[k]) for k in old))
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(appended_only(a, b) for a, b in zip(old, new)))
    return old == new


def test_a_model_of_another_family_joins_as_new_files_only(tmp_path):
    spec = build_tiny_root(tmp_path)
    old_spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    before = tree_digest(tmp_path)
    bench = tmp_path / "benchmark"
    files = {bench / "reference" / "toyvit.py": TOY_FAMILY,
             bench / "paths" / "toy_depth.py": TOY_PATH,
             bench / "traffic" / "toy-frames.json": json.dumps(TOY_TRAFFIC),
             bench / "limits" / "toy-cell.json": json.dumps({"depth_rel_rms": 1e-4}),
             bench / "metrics" / "toy_units.toy.py": DUMMY_METRIC}
    for path, text in files.items():
        assert not path.exists(), path
        path.write_text(text)
    toy = load_module(bench / "reference" / "toyvit.py", "toy_family")
    config = bench / "configs" / "toyvit_tiny.json"
    assert not config.exists()
    config.write_text(json.dumps(toy.tiny_config(TOY_CONFIG, "float32")))

    spec["configs"].append({"name": "toyvit_tiny", "source": "https://arxiv.org/abs/2010.11929",
                            "file": "benchmark/configs/toyvit_tiny.json", "reduced": [],
                            "why": "a toy family of the test"})
    cell = {"name": "toy-cell", "config": "toyvit_tiny", "traffic": "toy-frames", "chips": 1,
            "why": "a toy cell of the test"}
    spec["workloads"].append(cell)
    next(m for m in spec["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "toy-cell")
    spec["per_layer"].append({"name": "toy_units.toy", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "frames_per_s",
                              "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    traced = run_cell(tmp_path, spec, cell, 2**31 + 7, 0.3, True, "cpu",
                      log=lambda *a, **k: None, start=time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert traced["metrics"] == {"toy_units.toy": {"value": 2.0, "unit": "frames"}}
    untraced = run_cell(tmp_path, spec, cell, 2**31 + 7, 0.3, False, "cpu",
                        log=lambda *a, **k: None, start=time.perf_counter())
    assert untraced["correct"], untraced["checks"]
    assert set(untraced["metrics"]) == {"frames_per_s", "setup_s"}

    after = tree_digest(tmp_path)
    changed = sorted(p for p, h in before.items() if p != "BENCHMARK.json" and after.get(p) != h)
    assert not changed, changed
    assert appended_only(old_spec, json.loads((tmp_path / "BENCHMARK.json").read_text()))
