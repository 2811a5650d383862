#!/usr/bin/env python3
"""What a serving artifact's program runs on the host, and what the loader
drops from it.

Exports DUSt3R-224's native serving program at one batch size
(thermal3d_torch/infer/export.py), then counts its graph's call_function
nodes by target as `ExportedProgram.module()` gives them and as
`ServingArtifact.load` serves them (without the `_assert_tensor_metadata`
checks and the casts of a tensor to its own dtype, `_without_dtype_checks`),
and checks that both give the same outputs on seeded raw frames. Prints one
JSON line.

    python3 scripts/torch_export_graph.py --device cpu --model_preset tiny  # ~15 s
    python3 scripts/torch_export_graph.py                                   # the card, full width

Without --device it needs one CUDA card (bf16 weights and compute, batch 32
of [320, 416] raw frames, as chip_smoke.py's phase 11).
"""

import argparse
import collections
import dataclasses
import io
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from thermal3d_torch.cli.common import apply_preset  # noqa: E402
from thermal3d_torch.core.config import DUSTR_224_LINEAR  # noqa: E402
from thermal3d_torch.infer import export  # noqa: E402
from thermal3d_torch.infer.engine import InferenceEngine  # noqa: E402


def counts(module: torch.nn.Module) -> collections.Counter:
    return collections.Counter(str(n.target) for n in module.graph.nodes
                               if n.op == "call_function")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None, help="'cpu' or the card (default)")
    p.add_argument("--model_preset", default="full", choices=["full", "tiny"])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--raw_hw", type=int, nargs=2, default=[320, 416])
    args = p.parse_args(argv)
    tiny = args.model_preset == "tiny"
    dtype = "float32" if tiny else "bfloat16"
    cfg = apply_preset(DUSTR_224_LINEAR, args.model_preset, (32, 32) if tiny else (224, 224),
                       dtype)
    engine = InferenceEngine(dataclasses.replace(cfg), params_dtype=None if tiny else dtype,
                             device=args.device, seed=0)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "a.npz")
        export.save_serving_artifact(path, engine, batch_sizes=(args.batch,),
                                     input_hw=tuple(args.raw_hw), platforms=None)
        art = export.ServingArtifact.load(path, device=engine.device)
        with np.load(path) as z:
            program = torch.export.load(io.BytesIO(z[f"program_{args.batch}"].tobytes()))
    full = program.module()
    full.validate_inputs = False
    rng = np.random.default_rng(0)
    raw = (rng.uniform(21000.0, 26000.0, (args.batch, *args.raw_hw)) / 65535.0).astype(np.float32)
    served = art.infer(raw)
    with torch.inference_mode():
        out = full(art._weights, torch.from_numpy(raw).to(engine.device))
    equal = all(np.array_equal(out[k].cpu().numpy(), served[k]) for k in served)
    before, after = counts(full), counts(art._fns[args.batch])
    print(json.dumps(dict(
        device=str(engine.device), model_preset=args.model_preset, batch=args.batch,
        nodes_exported=sum(before.values()), nodes_served=sum(after.values()),
        dropped={k: before[k] - after[k] for k in before if before[k] != after[k]},
        top_served=after.most_common(8), outputs_equal=equal)))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
