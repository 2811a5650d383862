"""Readings the limits of a cell are set from: the sound program's on many
seeds, and the controls' on a few, in one process at the cell's own size.

    python -m benchmark.control --workload <cell> --seconds 3 \
        --seeds 11 12 13 ... --variants sound int8 fp8

Each (seed, variant) runs the cell's timed path as a run does (pool and
weights from the seed, the closed loop at the cell's load for `--seconds`,
the seeded sample checked against the float32 reference) and prints one JSON
line with every reading. Variants: 'sound' (the program as configured),
'int8' (the program's own int8 trunk, a bfloat16 configuration's next
precision down), 'fp8' (the reference with its products' operands in
float8 e4m3 in the place of the program's outputs), and for the pseudo-GT
path 'geometry_bf16' (the reference geometry in bfloat16 in the place of the
program's intrinsics and poses). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark.run import load_json, run_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variants", nargs="+", default=["sound", "int8"])
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    root = Path.cwd()
    spec = load_json(root / "BENCHMARK.json")
    cell = next(w for w in spec["workloads"] if w["name"] == args.workload)
    for seed in args.seeds:
        for variant in args.variants:
            readings: dict = {}
            result = run_cell(root, spec, cell, seed, args.seconds, False, args.device,
                              variant=None if variant == "sound" else variant,
                              log=lambda *a, **k: None, start=time.perf_counter(),
                              readings_out=readings)
            print(json.dumps({"workload": cell["name"], "seed": seed, "variant": variant,
                              "readings": readings, "attempted": result["attempted"],
                              "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
