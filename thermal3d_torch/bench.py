"""Benchmark of the port: thermal frames/s of DUSt3R-224 monocular depth on one
card — `python -m thermal3d_torch.bench` (counterpart of the repo's bench.py).

The headline serves batches of raw [320, 416] thermal frames through the
full-width bf16 InferenceEngine (resize, K1 enhance, thermal head, ViT-L
encoder, dual decoder through K2/K3, linear head). Steps are serialised on
the device: each step's depth is mixed back into the next step's raw input,
as bench.py does, so no step starts before the one before it has ended; the
clock stops after a synchronize. Decode is excluded. The best of two passes
is reported. Secondaries: the int8 serving frontier of bench.py, the same
engine with its trunk GEMMs in int8 (kernels/quant.py) at scope 'fc1' and
'all', each with static activation scales calibrated on 4 frames, with its
frames/s and two drifts of its depth against the bf16 depth on the same
unperturbed input (median-scaled AbsRel, the parity protocol; raw depth rel
RMS) and drift_ok (AbsRel ≤ 1%); a training step (full-width DUSt3R-224,
float32 master weights, bf16 compute, 512² pseudo-GT resized in the step;
steps serialise through the weights) and a MASt3R-512 pseudo-GT step (bf16,
fed back like the headline). `--int8 [--int8_scope S] [--int8_static_acts]`
serves the headline in int8 instead, with no int8 secondaries. `--ndev N`
serves the headline over a data-parallel mesh of the host's first N cards
(the InferenceEngine mesh path: a replica a card, each batch split over
them) at N times the batch, and reports the aggregate frames/s with its
per-card share, as bench.py's --ndev does.

Prints ONE JSON line in bench.py's shape: metric, value, unit, vs_baseline
(against the 500 frames/s of BASELINE.json), secondary_metrics, and the
device. Without CUDA it exits 1 before printing a result, unless
`--device cpu` is given (with `--model_preset tiny`, a CPU check of the
plumbing: its metrics are named `..._cpu_check_...` and compare with no
baseline).

    python -m thermal3d_torch.bench                       # on the card
    python -m thermal3d_torch.bench --sweep 16 32 64 128  # headline at each batch
    python -m thermal3d_torch.bench --int8 --int8_scope fc1 --int8_static_acts
    python -m thermal3d_torch.bench --ndev 4                # 4 cards, batch 4 x 64
    python -m thermal3d_torch.bench --device cpu --model_preset tiny --iters 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

BASELINE_FPS = 500.0  # BASELINE.json: the north-star target, frames/s on one chip
RAW_HW = (320, 416)
# the headline batch, from the sweep on the H100 recorded in PERF.md
SERVING_BATCH = 64
TRAIN_BATCH = 4  # TrainConfig's default
PAIR_BATCH = 4  # bench.py's MASt3R-512 batch
CALIB_FRAMES = 4  # bench.py's int8 calibration sample
DRIFT_GATE = 0.01  # BASELINE.json: AbsRel within 1%


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="thermal3d_torch benchmark (one JSON line)")
    p.add_argument("--batch", type=int, default=None,
                   help=f"headline frames a step (default {SERVING_BATCH} x --ndev)")
    p.add_argument("--ndev", type=int, default=1,
                   help="serve the headline over a data-parallel mesh of N devices")
    p.add_argument("--iters", type=int, default=30, help="timed steps a pass (two passes)")
    p.add_argument("--train_batch", type=int, default=TRAIN_BATCH)
    p.add_argument("--pair_batch", type=int, default=PAIR_BATCH)
    p.add_argument("--sweep", type=int, nargs="+", default=None,
                   help="also time the headline at these batches (a 'sweep' field)")
    p.add_argument("--no_secondary", action="store_true", help="headline only")
    p.add_argument("--int8", action="store_true",
                   help="serve the headline with the int8 trunk GEMMs (no int8 secondaries)")
    p.add_argument("--int8_scope", type=str, default="all", choices=["all", "mlp", "fc1"])
    p.add_argument("--int8_static_acts", action="store_true",
                   help="static activation scales from one calibration forward")
    p.add_argument("--model_preset", type=str, default="full", choices=["full", "tiny"])
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (the default) or 'cpu' for a plumbing check")
    return p


def _metric(name: str, device) -> str:
    """A device metric's name; a CPU run says so in the name instead."""
    if device.type == "cuda":
        return name
    return name.replace("per_chip", "cpu_check").replace("aggregate", "cpu_check_aggregate")


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of_two(torch, device, run, n_iters: int) -> float:
    """Seconds of the faster of two passes of n_iters run() calls, each
    ending in a synchronize."""
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            run()
        _sync(torch, device)
        best = min(best, time.perf_counter() - t0)
    return best


def _config(base, preset: str, tiny_hw):
    from thermal3d_torch.cli.common import apply_preset

    if preset == "tiny":
        return apply_preset(base, "tiny", tiny_hw, "float32")
    return dataclasses.replace(base, compute_dtype="bfloat16")


def _raw_frames(torch, device, batch: int):
    """bench.py's raw input: [batch, 320, 416] counts 21000-26000 / 65535."""
    return (torch.linspace(21000.0, 26000.0, batch * RAW_HW[0] * RAW_HW[1], device=device)
            .reshape(batch, *RAW_HW) / 65535.0)


def serving_fps(torch, device, preset: str, batch: int, n_iters: int, int8_only=None,
                static_acts: bool = False, mesh=None) -> dict:
    """Headline: device-serialised DUSt3R-224 serving at `batch` frames; int8
    trunk GEMMs when int8_only is a SCOPE_TO_ONLY tuple (static activation
    scales from CALIB_FRAMES frames with static_acts; over `mesh`, a
    data-parallel engine). The result's "depth" is the warm-up step's, on
    the unperturbed input."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine

    cfg = _config(DUSTR_224_LINEAR, preset, (64, 64))
    int8 = {}
    if int8_only is not None:
        int8 = dict(quantize_int8=True, int8_only=int8_only,
                    int8_calibration=_raw_frames(torch, device, CALIB_FRAMES)
                    if static_acts else None)
    engine = InferenceEngine(cfg, params_dtype=None if preset == "tiny" else "bfloat16",
                             seed=0, device=device, mesh=mesh, **int8)
    raw0 = _raw_frames(torch, device, batch)
    state = {"raw": raw0}

    def step():
        depth = engine.infer_async(state["raw"])["depth"]
        # the next input depends on this depth: the steps run one after another
        feedback = torch.tanh(depth.float().mean(dim=(1, 2)))[:, None, None] * 1e-4
        state["raw"], state["depth"] = raw0 * (1.0 + feedback), depth

    step()  # warm-up, on raw0
    depth0 = state["depth"].double().cpu().numpy()
    dt = _best_of_two(torch, device, step, n_iters)
    if not bool(torch.isfinite(state["depth"]).all()):
        raise RuntimeError("serving: non-finite depth")
    return {"batch": batch, "fps": batch * n_iters / dt, "step_ms": 1e3 * dt / n_iters,
            "depth": depth0}


def int8_secondaries(torch, device, preset: str, batch: int, n_iters: int, head: dict) -> list:
    """bench.py's int8 frontier: bf16 (the headline), then scopes fc1 and
    all with static activation scales, each with its drift against the
    headline's depth on the same input."""
    import numpy as np

    from thermal3d_torch.evaluation.metrics import compute_depth_metrics
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY

    ref = head["depth"]
    rows = [{"config": "bf16", "fps": head["fps"], "abs_rel_drift": 0.0,
             "depth_drift_rel_rms": 0.0, "drift_ok": True}]
    for scope in ("fc1", "all"):
        run = serving_fps(torch, device, preset, batch, n_iters, SCOPE_TO_ONLY[scope], True)
        # over the whole batch as one map, as bench.py scores it
        w = ref.shape[-1]
        abs_rel = compute_depth_metrics(run["depth"].reshape(-1, w), ref.reshape(-1, w),
                                        median_scaling=True, device=device)["abs_rel"]
        rows.append({"config": f"int8_{scope}_static_acts", "fps": run["fps"],
                     "vs_baseline": run["fps"] / BASELINE_FPS if device.type == "cuda" else None,
                     "abs_rel_drift": abs_rel,
                     "depth_drift_rel_rms": float(np.linalg.norm(run["depth"] - ref)
                                                  / np.linalg.norm(ref)),
                     "drift_ok": bool(abs_rel <= DRIFT_GATE)})
    return rows


def train_fps(torch, device, preset: str, batch: int, n_iters: int) -> dict:
    """A training step of `batch` pairs; steps serialise through the weights."""
    import numpy as np

    from thermal3d_torch.core.config import DUSTR_224_LINEAR, TrainConfig
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.state import create_train_state
    from thermal3d_torch.train.step import make_train_step

    cfg = _config(DUSTR_224_LINEAR, preset, (64, 64))
    model = trainable_model(cfg, device, seed=0)
    tcfg = TrainConfig(batch_size=batch, use_enhanced_loss=True)
    state = create_train_state(model, tcfg, steps_per_epoch=1000)
    train_step = make_train_step(model, tcfg)
    h, w = cfg.img_size
    gt = 64 if preset == "tiny" else 512  # pseudo-GT arrives at MASt3R's 512²
    rng = np.random.default_rng(1)

    def u(lo, hi, *shape):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=device)

    data = {"thermal1": u(21000.0, 26000.0, batch, h, w, 3),
            "thermal2": u(21000.0, 26000.0, batch, h, w, 3),
            "pointmap1": u(0.1, 5.0, batch, gt, gt, 3), "pointmap2": u(0.1, 5.0, batch, gt, gt, 3)}
    out = {}

    def step():
        out["metrics"] = train_step(state, data)[1]

    step()  # warm-up
    _sync(torch, device)
    dt = _best_of_two(torch, device, step, n_iters)
    return {"metric": _metric("train_frames_per_sec_per_chip_dustr224", device),
            "value": batch * n_iters / dt, "unit": "frames/s", "vs_baseline": None,
            "batch": batch, "loss": float(out["metrics"]["loss"]),
            "step_ms": 1e3 * dt / n_iters}


def pseudo_gt_pps(torch, device, preset: str, batch: int, n_iters: int) -> dict:
    """A MASt3R-512 pseudo-GT step of `batch` pairs, fed back like the headline."""
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    cfg = _config(MASTR_512_CATMLPDPT, preset, (64, 64))
    gen = PseudoGTGenerator(cfg, batch_size=batch, seed=0, device=device,
                            params_dtype=None if preset == "tiny" else "bfloat16")
    h, w = cfg.img_size
    g = torch.Generator(device=device).manual_seed(0)
    rgb1 = torch.rand((batch, h, w, 3), generator=g, device=device)
    rgb2 = torch.rand((batch, h, w, 3), generator=g, device=device)
    state = {"rgb1": rgb1}

    def step():
        out = gen.run_pairs_async(state["rgb1"], rgb2)
        feedback = torch.tanh(out["depth1"].mean(dim=(1, 2)))[:, None, None, None] * 1e-4
        state["rgb1"], state["pose"] = rgb1 * (1.0 + feedback), out["poses"]

    step()  # warm-up
    _sync(torch, device)
    dt = _best_of_two(torch, device, step, n_iters)
    return {"metric": _metric("pseudo_gt_pairs_per_sec_per_chip_mastr512", device),
            "value": batch * n_iters / dt, "unit": "pairs/s", "vs_baseline": None,
            "batch": batch, "pose00": float(state["pose"][0, 0, 0]),
            "step_ms": 1e3 * dt / n_iters}


def main(argv=None) -> int:
    import torch

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.int8_static_acts and not args.int8:
        parser.error("--int8_static_acts requires --int8")
    if args.device is None and not torch.cuda.is_available():
        print("thermal3d_torch.bench: CUDA is not available; pass --device cpu for a CPU "
              "check of the plumbing", file=sys.stderr)
        return 1
    from thermal3d_torch.core.device import resolve_device

    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY

    ndev = args.ndev
    if args.batch is None:
        args.batch = SERVING_BATCH * ndev
    mesh = None
    if ndev > 1:
        from thermal3d_torch.cli.common import make_dp_mesh

        mesh = make_dp_mesh(ndev, args.batch, parser.error, args.device)
        device = mesh.data_devices()[0]
    int8_only = SCOPE_TO_ONLY[args.int8_scope] if args.int8 else None
    head = serving_fps(torch, device, args.model_preset, args.batch, args.iters, int8_only,
                       args.int8_static_acts, mesh)
    name = "thermal_frames_per_sec_per_chip_dustr224" if ndev == 1 else \
        "thermal_frames_per_sec_aggregate_dustr224"
    result = {
        "metric": _metric(name, device),
        "value": round(head["fps"], 2),
        "unit": "frames/s",
        # the 500 frames/s target is a card's: aggregate mode compares its per-card share
        "vs_baseline": (round(head["fps"] / ndev / BASELINE_FPS, 3)
                        if device.type == "cuda" else None),
        **({"ndev": ndev, "per_chip": round(head["fps"] / ndev, 2)} if ndev > 1 else {}),
        "batch": args.batch, "iters": args.iters, "step_ms": round(head["step_ms"], 3),
        "model_preset": args.model_preset,
        "device": {"type": device.type, "kind": kind},
    }
    if args.int8:
        result.update(int8=True, int8_scope=args.int8_scope,
                      int8_static_acts=args.int8_static_acts)
    if args.sweep:
        result["sweep"] = [{k: round(v, 3) if isinstance(v, float) else v for k, v in
                            serving_fps(torch, device, args.model_preset, b, args.iters,
                                        int8_only, args.int8_static_acts, mesh).items()
                            if k != "depth"}
                           for b in args.sweep]
    if not args.no_secondary and ndev == 1:  # the secondaries measure one card
        n = max(1, args.iters // 3)
        secondary = [] if args.int8 else int8_secondaries(
            torch, device, args.model_preset, args.batch, args.iters, head)
        secondary += [
            dict(config=f"train_dustr224_b{args.train_batch}",
                 **train_fps(torch, device, args.model_preset, args.train_batch, n)),
            dict(config=f"pseudo_gt_mastr512_b{args.pair_batch}",
                 **pseudo_gt_pps(torch, device, args.model_preset, args.pair_batch, n)),
        ]
        result["secondary_metrics"] = [
            {k: round(v, 5) if isinstance(v, float) else v for k, v in s.items()}
            for s in secondary]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
