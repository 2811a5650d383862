"""Single-device serving rate of two checkouts of the repo, in turns on one card.

    python scripts/torch_serving_ab.py TREE_A TREE_B [--rounds 1] [-- BENCH_FLAGS...]

Runs the port's bench (`python -m thermal3d_torch.bench`, headline only, one
device, the default flags below) from each checkout in the order A, B, B, A
(repeated --rounds times), each run in a process of its own, so that both
trees meet the same card and host in the same call. Prints the card's name
and power limit, one JSON line a run, and a last line with each tree's
rates a batch and the ratio of B's mean to A's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BENCH_FLAGS = ["--batch", "64", "--sweep", "8", "32", "--iters", "30", "--no_secondary"]


def run_bench(tree: str, flags) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-m", "thermal3d_torch.bench", *flags],
                         cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"bench in {tree} exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    rates = {line["batch"]: line["value"]}
    rates.update({s["batch"]: round(s["fps"], 2) for s in line.get("sweep", [])})
    return rates


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--rounds", type=int, default=1)
    argv = sys.argv[1:] if argv is None else list(argv)
    bench_flags = BENCH_FLAGS
    if "--" in argv:  # what follows goes to the bench as it is
        argv, bench_flags = argv[:argv.index("--")], argv[argv.index("--") + 1:]
    args = p.parse_args(argv)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for which in ("a", "b", "b", "a"):
            rates = run_bench(getattr(args, f"tree_{which}"), bench_flags)
            runs[which].append(rates)
            print(json.dumps({"tree": which, "frames_per_s": rates}), flush=True)
    summary = {}
    for batch in runs["a"][0]:
        mean = {w: sum(r[batch] for r in runs[w]) / len(runs[w]) for w in runs}
        summary[str(batch)] = {"a": [r[batch] for r in runs["a"]],
                               "b": [r[batch] for r in runs["b"]],
                               "b_over_a": round(mean["b"] / mean["a"], 4)}
    print(json.dumps({"serving_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
