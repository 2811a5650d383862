"""Run one cell of BENCHMARK.json and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The harness holds no name of a cell,
configuration, family, traffic mix, path or metric: it reads the cell from
BENCHMARK.json and finds, by name,
  the configuration    the `file` of BENCHMARK.json's entry (the family's
                       keys, the dtype, how the weights are made),
  the family           benchmark/reference/<configuration's "reference">.py
                       (the weights' layout, the plain reference),
  the traffic mix      benchmark/traffic/<traffic>.json (parameters only),
  the request path     benchmark/paths/<traffic's "path">.py (the pool, the
                       program's calls, the check against the reference),
  the limits           benchmark/limits/<cell>.json (each number compared),
  each metric          benchmark/metrics/<metric>.py (its reader).

A run makes the input pool and the weights from --seed, builds the program,
runs the closed loop (warm-up, then --seconds of measured window, then the
drain), with --trace 1 a profiled slice of a fixed number of requests, and
then, the program freed, checks a seeded sample of the window's requests
against the float32 reference. The end-to-end metrics (--trace 0) or the
per-layer ones (--trace 1) and the numbers compared go into the last line.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

from benchmark.imports import forbidden_loaded  # noqa: E402
from benchmark.modules import load_module  # noqa: E402

# every kernel and build cache the program or a library keeps, at fixed paths
# inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
CACHE_ROOT = ".bench_cache"


@dataclass
class Run:
    """What a metric's reader reads."""

    workload: dict
    cfg: dict
    traffic: dict
    units_name: str  # "frames", "pairs": what one unit of a request is
    units: int  # units a request
    setup_seconds: float
    window: Any  # loop.Window
    trace: Any = None  # trace.Trace of the profiled slice, with --trace 1


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def metric_module(root: Path, name: str):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(spec: dict, cell: str, traced: bool):
    """The metric entries the cell reports: end-to-end ones untraced,
    per-layer ones traced (by their "workloads", or where the end-to-end
    metric they move is reported)."""
    def applies(entry):
        return "workloads" not in entry or cell in entry["workloads"]

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def run_cell(root: Path, spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device, variant: Optional[str] = None, log=print,
             start: float = PROCESS_START, readings_out: Optional[dict] = None
             ) -> Dict[str, Any]:
    """One run of `cell` on `device` → the result line's object. `variant`
    builds the program's lower-precision path (benchmark/control.py);
    `readings_out` receives every reading, compared or not."""
    import torch

    from benchmark import loop
    from benchmark.inputs import request_order
    from benchmark.weights import make_weights

    device = torch.device(device)
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / config["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{cell['name']}.json")
    path = load_module(root / "benchmark" / "paths" / f"{traffic['path']}.py",
                       "benchmark_path_" + traffic["path"])
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    pool = path.make_pool(traffic, seed, device)
    weights = make_weights(cfg, seed, device, root)
    program = path.Program(cfg, traffic, weights, device, variant)
    del weights  # the program holds its own copy; the reference makes them anew
    order = request_order(traffic, seed)
    requests = ((i, path.request(pool, i)) for i in order)
    sampler = loop.Sampler(traffic["checked_requests"], seed)
    units = path.units(traffic)
    window = loop.run_window(program, requests, traffic["clients"], traffic["warmup_requests"],
                             seconds, units, sampler, sync)
    run = Run(cell, cfg, traffic, path.UNITS, units, window.start - start, window)
    device_info: Dict[str, Any] = {"platform": "gpu" if on_card else device.type,
                                   "kind": torch.cuda.get_device_name(device) if on_card
                                   else "cpu", "count": 1}
    if trace:
        run.trace = traced_slice(program, requests, traffic, on_card, sync)
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device) if on_card
                                        else 0)
    if on_card:
        log(f"card: {card_line()}", file=sys.stderr)

    del program  # the reference runs in the memory the program held
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    params = make_weights(cfg, seed, device, root)
    readings = path.check(cfg, traffic, params, sampler.items, pool, device, variant)
    if readings_out is not None:
        readings_out.update(readings)
    checks = {name: {"value": readings.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    correct = bool(sampler.items) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for entry in cell_metrics(spec, cell["name"], trace):
        value = metric_module(root, entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {"correct": correct, "attempted": len(window.requests), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = run.trace.breakdown
        log(f"launch counters a request: {json.dumps(run.trace.counters)}", file=sys.stderr)
    for name in sorted(set(readings) - set(limits)):
        log(f"reading {name} {readings[name]!r} (not compared)", file=sys.stderr)
    log(f"checked {len(sampler.items)} of {sampler.seen} window requests", file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    # a NaN or infinite reading goes out as a string: the line stays JSON
    result["checks"] = {
        name: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
               "limit": c["limit"]} for name, c in checks.items()}
    return result


def program_counters() -> Dict[str, int]:
    """The port's K1, K2 and K3 launch counts so far."""
    import importlib

    image_ops = importlib.import_module("thermal3d_torch.kernels.image_ops")
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    return {"K1": image_ops.percentile_enhance.launches,
            "K2": fa.fused_rope_attention.launches,
            "K3": fa.fused_rope_cross_attention.launches}


def traced_slice(program, requests, traffic, on_card: bool, sync):
    from torch.profiler import ProfilerActivity, profile

    from benchmark import loop
    from benchmark.trace import reduce_profile

    n = traffic["trace_requests"]
    before = program_counters()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        sl = loop.run_slice(program, requests, traffic["clients"], n, sync)
    after = program_counters()
    counters = {k: (after[k] - before[k]) / n for k in after}
    return reduce_profile(prof, sl.seconds, n, counters)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative whole number")

    root = Path.cwd()
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, str(root / CACHE_ROOT / sub))
    spec = load_json(root / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"benchmark: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    found = forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded before the run: {found}", file=sys.stderr)
        return 4
    result = run_cell(root, spec, cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
