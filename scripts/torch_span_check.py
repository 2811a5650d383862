"""What the port's spans (thermal3d_torch/core/profiling.py) cost and leave in a
traced benchmark run, on the card.

    python3 scripts/torch_span_check.py --workload <cell> --seed <n> [--seconds 30]
        [--root <checkout>] [--cost]

runs one traced run of a benchmark cell (benchmark/run.py's run_cell, as
`python3 -m benchmark.run --trace 1` does) from the checkout `--root` (default:
the current directory; its own `benchmark/` and `thermal3d_torch/`), and
prints one JSON line: the run's metrics and idle-gap breakdown, the traced
slice's host-clock seconds a request, its device events a request, how many
of the profiler's events are user annotations (on the device timeline and
in all), and the spans' totals a request (where the program has the span
registry). `--cost` adds the µs a span costs with no profiler and under
one, with and without device events, beside torch.profiler.record_function.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def span_cost(device, n_off: int = 200_000, n_on: int = 5_000) -> dict:
    """µs a `with` of a span costs: off (no profiler) and on (under
    torch.profiler with CPU and CUDA activities), host-only and with
    device events, beside record_function off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from thermal3d_torch.core import profiling

    def each(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def host():
        with profiling.annotate("cost.host"):
            pass

    def on_device():
        with profiling.annotate("cost.device", device):
            pass

    def record_function():
        with torch.profiler.record_function("cost.record_function"):
            pass

    out = {"off_us": each(host, n_off), "off_device_us": each(on_device, n_off),
           "record_function_off_us": each(record_function, n_off // 10)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_us"] = each(host, n_on)
        out["on_device_us"] = each(on_device, n_on)
    torch.cuda.synchronize(device)
    profiling.clear()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--root", default=".")
    parser.add_argument("--cost", action="store_true")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))

    import torch
    from torch.autograd import DeviceType

    import benchmark.trace as bench_trace
    from benchmark.run import card_line, load_json, run_cell
    from thermal3d_torch.core import profiling

    reduce_profile = bench_trace.reduce_profile
    seen: dict = {}

    def counting_reduce(prof, window_s, requests, counters, top=10):
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        seen.update(
            user_annotation_device_events=sum(e.is_user_annotation for e in device),
            user_annotation_events=sum(e.is_user_annotation for e in events),
            device_events_per_request=len(device) / requests)
        return reduce_profile(prof, window_s, requests, counters, top)

    bench_trace.reduce_profile = counting_reduce
    spec = load_json(root / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    profiling_clear = getattr(profiling, "clear", None)
    if profiling_clear is not None:
        profiling_clear()
    result = run_cell(root, spec, cell, args.seed, args.seconds, True, "cuda:0",
                      log=lambda *a, **k: None)
    line = {"root": str(root), "workload": args.workload, "seed": args.seed,
            "card": card_line(), "torch": torch.__version__, "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "idle_gaps": result["breakdown"]["idle_gaps"], **seen}
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    requests = traffic["trace_requests"]
    line["slice_s_per_request"] = result["device"]["window_s"] / requests
    totals = getattr(profiling, "totals", None)
    if totals is not None:
        line["spans_per_request"] = {
            name: {k: (v / requests if v is not None and k != "requests" else v)
                   for k, v in t.items()} for name, t in totals().items()}
    if args.cost and totals is not None:
        line["span_cost"] = span_cost(torch.device("cuda:0"))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
