"""Host time of one call of the serving path's kernel wrappers, for two
checkouts of the repo in turns on one card.

    python scripts/torch_launch_cost.py TREE_A TREE_B [--rounds 3] [--blocks 50]

Runs, in a process of its own from each checkout (A, B, B, A, repeated
--rounds times), blocks of CALLS calls of K1 (`percentile_enhance` on
[1,16,16]) and of K2 and K3 (`fused_rope_attention` on [1,16,192],
`fused_rope_cross_attention` on [1,16,64] x 3: one bf16 head of 64, the
tensor-core kernel) after a warm-up, and takes each wrapper's median host
microseconds a call over the blocks (a block ends with a synchronize, so
its time is the host's time to launch CALLS calls plus the tail of its last
kernel). The kernels are tiny, so the host, not the card, sets the pace:
the number is what a host-bound serving batch pays a launch, 57 times a
batch (K1 once, K2 and K3 56 times). Prints the card's name and power
limit, one JSON line a run, and a last line with each tree's medians and
B - A a call and a serving batch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CALLS = 200  # calls a block
LAUNCHES_PER_BATCH = {"K1": 1, "K2": 40, "K3": 16}  # DUSt3R-224 serving

RUN = r"""
import importlib, json, statistics, sys, time
import torch

blocks = int(sys.argv[1])
calls = int(sys.argv[2])
fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
from thermal3d_torch.kernels.image_ops import percentile_enhance
from thermal3d_torch.models.rope import make_grid_positions, rope_tables

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
gray = torch.rand((1, 16, 16), generator=gen, device=dev)
qkv = torch.randn((1, 16, 192), generator=gen, device=dev).to(torch.bfloat16)
q, k, v = (torch.randn((1, 16, 64), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(3))
cos, sin = (t.to(dev) for t in rope_tables(make_grid_positions(4, 4), 64))
wrappers = {"K1": lambda: percentile_enhance(gray),
            "K2": lambda: fa.fused_rope_attention(qkv, cos, sin, 1, 0.125),
            "K3": lambda: fa.fused_rope_cross_attention(q, k, v, cos, sin, 1, 0.125)}
for fn in wrappers.values():  # build, load and warm up
    for _ in range(calls):
        fn()
torch.cuda.synchronize()
us = {}
for name, fn in wrappers.items():
    per_call = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    us[name] = statistics.median(per_call)
print(json.dumps(us))
"""


def run_tree(tree: str, blocks: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", RUN, str(blocks), str(CALLS)], cwd=tree,
                         env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"launch timing in {tree} exited {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a")
    p.add_argument("tree_b")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--blocks", type=int, default=50)
    args = p.parse_args(argv)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for which in ("a", "b", "b", "a"):
            us = run_tree(getattr(args, f"tree_{which}"), args.blocks)
            runs[which].append(us)
            print(json.dumps({"tree": which, "us_per_call": us}), flush=True)
    summary = {}
    for name in runs["a"][0]:
        med = {w: statistics.median(r[name] for r in runs[w]) for w in runs}
        summary[name] = {"a": [r[name] for r in runs["a"]], "b": [r[name] for r in runs["b"]],
                         "median_a": med["a"], "median_b": med["b"],
                         "b_minus_a_us": med["b"] - med["a"]}
    batch_us = sum(LAUNCHES_PER_BATCH[n] * s["b_minus_a_us"] for n, s in summary.items())
    print(json.dumps({"launch_cost": summary, "b_minus_a_ms_per_serving_batch": batch_us / 1e3}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
