"""Parity gate — `python -m thermal3d_torch.cli.parity` (counterpart of
thermal3d/cli/parity.py): one command, exit 1 on failure, for CI.

Modes (combinable), with the JAX CLI's flags, exit codes and report:
  * --ours_dir/--theirs_dir: compare saved *_depth.npy trees frame by frame;
    gates on per-frame median-scaled AbsRel <= --gate.
  * --golden_dir [--model]: run the InferenceEngine on the thermal frames
    recorded in a pseudo_gt_test_set-style golden directory and report the
    depth metrics against the golden depths; with --reference_metrics (a
    JSON of the reference's metrics on the same set, e.g. {"abs_rel":
    0.08}) gates on the relative AbsRel drift <= --gate.
  * --int8 (with --golden_dir): also build the int8 engine (--int8_scope,
    default fc1) and gate its AbsRel drift against the float engine's.
  * --full-gate (with --model, --golden_dir): strict checkpoint loading
    (convert/from_pth.py) → full-depth per-layer activation diff against the
    independent oracle (evaluation/oracle.py) in float32 with TF32 off →
    golden metrics → int8 drift, and one PASS/FAIL JSON line whose stages
    read pass, fail or skipped.

    python -m thermal3d_torch.cli.parity --full-gate --model ckpt.pth \\
        --golden_dir pseudo_gt_test_set/day

Runs on the card unless --device cpu, on one device: --ndev > 1 is a
parser error (the JAX CLI has no --ndev); --scan_layers is accepted and the
model runs unrolled (cli/common.py::apply_scan).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from thermal3d_torch.cli.common import (add_preset_flag, apply_preset, apply_scan, refuse_ndev)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Reference-parity gate (1% AbsRel), PyTorch/CUDA")
    p.add_argument("--ours_dir", type=str, default=None)
    p.add_argument("--theirs_dir", type=str, default=None,
                   help="reference depth .npy dir matched to --ours_dir by filename")
    p.add_argument("--model", type=str, default=None, help=".pth checkpoint")
    p.add_argument("--golden_dir", type=str, default=None,
                   help="pseudo_gt_test_set-style dir (*_depth.npy + *_thermal_path.txt)")
    p.add_argument("--remap", type=str, nargs="*", default=[],
                   help="OLD=NEW path-prefix substitutions for *_thermal_path.txt entries")
    p.add_argument("--reference_metrics", type=str, default=None,
                   help="JSON of the reference's metrics on the same golden set")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int8_scope", type=str, default="fc1", choices=["all", "mlp", "fc1"])
    p.add_argument("--gate", type=float, default=0.01,
                   help="maximum allowed AbsRel (dir mode) / relative AbsRel drift")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--model_variant", type=str, default="dustr224_linear",
                   choices=["dustr224_linear", "dustr512_dpt", "mastr512_catmlpdpt"],
                   help="architecture of --model (as cli.infer)")
    p.add_argument("--img_size", type=int, nargs=2, default=None,
                   help="defaults to the model variant's native resolution")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--report", type=str, default=None, help="write the full JSON report here")
    p.add_argument("--full-gate", dest="full_gate", action="store_true",
                   help="strict checkpoint load → oracle activation diff → golden metrics → "
                        "int8 drift; one PASS/FAIL JSON line")
    p.add_argument("--oracle_tol", type=float, default=2e-4,
                   help="full-gate per-layer activation tolerance, relative to each layer's "
                        "activation scale")
    return add_preset_flag(p)


def _full_gate_convert(args, config):
    """Stage 1: load the checkpoint once and check its keys and shapes against
    the model strictly. Returns (stage report, raw state dict or None,
    (model state, thermal head state) or None)."""
    import torch

    from thermal3d_torch.convert.from_pth import (is_wrapper_state_dict,
                                                  load_torch_checkpoint, split_checkpoint)
    from thermal3d_torch.models.dustr import AsymmetricCroCo3DStereo

    try:
        state = load_torch_checkpoint(args.model)
        model_sd, head_sd = split_checkpoint(state, config, wrapper=is_wrapper_state_dict(state))
        with torch.device("meta"):
            want = {k: tuple(v.shape) for k, v in AsymmetricCroCo3DStereo(config)
                    .state_dict().items()}
        got = {k: tuple(v.shape) for k, v in model_sd.items()}
        missing, unknown = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        if missing or unknown or bad:
            raise ValueError(f"strict load failed: missing {missing[:8]}, unknown "
                             f"{unknown[:8]}, shape mismatch {bad[:8]}")
        converted = len(model_sd) + len(head_sd or {})
        return ({"ok": True, "converted": converted, "skipped": len(state) - converted},
                state, (model_sd, head_sd))
    except Exception as e:  # a rejected checkpoint fails the stage, with its diff
        return ({"ok": False, "error": str(e)[:2000]}, None, None)


def _full_gate_oracle(args, config, raw_state, model_state, device):
    """Stage 2: the checkpoint in the oracle (raw_state, its 'model.' prefix
    stripped) and in the port's model (model_state, as loaded), both
    float32 with TF32 off on `device`; every layer's max|Δ| against
    oracle_tol × max(1, its activation scale), then the outputs."""
    import numpy as np
    import torch

    from thermal3d_torch.core.device import exact_float32_convs
    from thermal3d_torch.evaluation import oracle as oracle_mod
    from thermal3d_torch.models.dustr import frozen_model

    try:
        cfg = dataclasses.replace(config, compute_dtype="float32")
        # a wrapper (ThermalDUSt3R) checkpoint prefixes the model with 'model.'
        base_sd = {k[len("model."):]: v for k, v in raw_state.items()
                   if k.startswith("model.")} or raw_state
        with torch.device(device):  # the oracle's own init, on the card
            oracle = oracle_mod.OracleDustr(cfg).eval()
        load = oracle.load_state_dict(
            {k: v for k, v in base_sd.items() if k in oracle.state_dict()}, strict=False)
        if load.missing_keys:
            return {"ok": False, "error": "checkpoint lacks tensors the "
                    f"oracle needs: {load.missing_keys[:8]}"}
        model = frozen_model(cfg, device, model_state)
        rng = np.random.default_rng(0)
        h, w = cfg.img_size
        img1 = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
        img2 = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
        with oracle_mod.exact_float32(), exact_float32_convs(torch.float32):
            t_acts, (tout1, tout2) = oracle_mod.capture_oracle_activations(oracle, img1, img2)
            f_acts, (pred1, pred2) = oracle_mod.capture_model_activations(model, img1, img2)
        drift = oracle_mod.per_layer_drift(t_acts, f_acts)
        # the oracle returns (pts, conf) tuples for the linear head and
        # {'pts3d','conf'[,desc,desc_conf]} dicts for the DPT family
        if isinstance(tout1, dict):
            pairs = [("pts3d_1", pred1["pts3d"], tout1["pts3d"]),
                     ("conf_1", pred1["conf"], tout1["conf"]),
                     ("pts3d_2", pred2["pts3d_in_other_view"], tout2["pts3d"]),
                     ("conf_2", pred2["conf"], tout2["conf"])]
            for k in ("desc", "desc_conf"):
                if k in tout1:
                    pairs.append((f"{k}_1", pred1[k], tout1[k]))
                    pairs.append((f"{k}_2", pred2[k], tout2[k]))
        else:
            (tp1, tc1), (tp2, tc2) = tout1, tout2
            pairs = [("pts3d_1", pred1["pts3d"], tp1), ("conf_1", pred1["conf"], tc1),
                     ("pts3d_2", pred2["pts3d_in_other_view"], tp2),
                     ("conf_2", pred2["conf"], tc2)]
        for name, ours, theirs in pairs:
            ours, theirs = ours.float().cpu().numpy(), theirs.float().cpu().numpy()
            drift[name] = (float(np.abs(ours - theirs).max()), float(np.abs(theirs).max()))
    except Exception as e:  # any shape or layout mismatch is a FAIL, not a crash
        return {"ok": False, "error": f"oracle diff crashed: {e}"}
    worst_name, worst_rel = None, 0.0
    for name, (delta, scale) in drift.items():
        rel = delta / max(1.0, scale)
        if rel > worst_rel:
            worst_name, worst_rel = name, rel
    return {"ok": bool(worst_rel <= args.oracle_tol), "layers": len(drift),
            "worst_layer": worst_name, "worst_rel": worst_rel, "tol": args.oracle_tol}


def _make_engine(args, config, state, head_state, int8: bool):
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.kernels.quant import SCOPE_TO_ONLY

    kw = dict(quantize_int8=True, int8_only=SCOPE_TO_ONLY[args.int8_scope]) if int8 else {}
    return InferenceEngine(config, state_dict=state, thermal_head_state=head_state,
                           use_thermal_head=True, device=args.device, **kw)


def _stages(report, failures):
    """The full gate's per-stage pass / fail / skipped (a stage that never ran
    is 'skipped', never a spurious pass)."""

    def stage(key, fail_labels):
        rep = report.get(key)
        if rep is None:
            return "skipped"
        if key.startswith("full_gate"):
            return "pass" if rep.get("ok") else "fail"
        return "fail" if any(f in failures for f in fail_labels) else "pass"

    return {"convert": stage("full_gate_convert", ()),
            "oracle": stage("full_gate_oracle", ()),
            "golden_metrics": stage("golden_bf16", ("golden frames unresolvable",
                                                    "reference AbsRel drift gate")),
            "int8_drift": stage("golden_int8", ("int8 drift gate",))}


def _golden(args, report, failures):
    """The golden-engine modes: --full-gate's first stages, the float engine's
    metrics, the reference drift and the int8 drift, into report."""
    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, DUSTR_512_DPT, MASTR_512_CATMLPDPT
    from thermal3d_torch.core.device import resolve_device
    from thermal3d_torch.evaluation.parity import compare_engine_to_golden

    base = {"dustr224_linear": DUSTR_224_LINEAR, "dustr512_dpt": DUSTR_512_DPT,
            "mastr512_catmlpdpt": MASTR_512_CATMLPDPT}[args.model_variant]
    if args.img_size is None:
        args.img_size = list(base.img_size)
    config = apply_preset(base, args.model_preset, args.img_size, args.compute_dtype)
    config = apply_scan(config, args.scan_layers)
    state = head_state = None  # no --model: seeded random weights
    if args.full_gate:
        conv_rep, raw_state, loaded = _full_gate_convert(args, config)
        report["full_gate_convert"] = conv_rep
        print(f"full-gate convert(strict): {'PASS' if conv_rep['ok'] else 'FAIL'} "
              f"({conv_rep.get('converted', 0)} tensors converted)")
        if not conv_rep["ok"]:
            # a checkpoint the strict load rejects cannot feed the later
            # stages: they are skipped (and marked so in the JSON line)
            failures.append("strict conversion")
            print(conv_rep["error"])
            return
        state, head_state = loaded
        oracle_rep = _full_gate_oracle(args, config, raw_state, state,
                                       resolve_device(args.device))
        report["full_gate_oracle"] = oracle_rep
        if oracle_rep["ok"]:
            print(f"full-gate oracle diff: PASS ({oracle_rep['layers']} layers, worst "
                  f"{oracle_rep['worst_layer']} rel {oracle_rep['worst_rel']:.2e} <= "
                  f"{oracle_rep['tol']:.0e})")
        else:
            failures.append("oracle activation diff")
            print(f"full-gate oracle diff: FAIL — {oracle_rep.get('error') or oracle_rep}")
    elif args.model:
        state, head_state = load_pth(args.model, config)
    remap = dict(s.split("=", 1) for s in args.remap) or None
    golden = dict(thermal_root_remap=remap, max_frames=args.max_frames,
                  batch_size=args.batch_size)
    m = compare_engine_to_golden(_make_engine(args, config, state, head_state, int8=False),
                                 args.golden_dir, **golden)
    report["golden_bf16"] = m
    if "error" in m or "abs_rel" not in m:
        # {} = thermal frames resolved but no *_depth.npy matched: as much a
        # gate failure as frames that do not resolve
        print(f"golden: {m.get('error', 'no golden depth files matched')}")
        failures.append("golden frames unresolvable")
        return
    print(f"golden AbsRel (bf16): {m['abs_rel']:.5f}")
    if args.reference_metrics:
        with open(args.reference_metrics) as f:
            ref = json.load(f)["abs_rel"]
        drift = abs(m["abs_rel"] - ref) / max(ref, 1e-9)
        report["abs_rel_drift_vs_reference"] = drift
        ok = drift <= args.gate
        print(f"vs reference AbsRel {ref:.5f}: drift {drift:.2%} -> "
              f"{'PASS' if ok else 'FAIL'} (gate {args.gate:.0%})")
        if not ok:
            failures.append("reference AbsRel drift gate")
    if args.int8:
        m8 = compare_engine_to_golden(_make_engine(args, config, state, head_state, int8=True),
                                      args.golden_dir, **golden)
        report["golden_int8"] = m8
        drift8 = abs(m8["abs_rel"] - m["abs_rel"]) / max(m["abs_rel"], 1e-9)
        report["int8_abs_rel_drift"] = drift8
        ok8 = drift8 <= args.gate
        print(f"int8[{args.int8_scope}] AbsRel {m8['abs_rel']:.5f}: drift {drift8:.2%} -> "
              f"{'PASS' if ok8 else 'FAIL'}")
        if not ok8:
            failures.append("int8 drift gate")


def main(argv=None):
    from thermal3d_torch.evaluation.parity import compare_depth_dirs

    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_ndev(parser, args, "cli.parity compares on one device")
    # a CI gate must fail loudly on a half-specified comparison: a silently
    # skipped mode would print PASS for a check that never ran
    if bool(args.ours_dir) != bool(args.theirs_dir):
        parser.error("--ours_dir and --theirs_dir must be given together")
    if (args.int8 or args.reference_metrics or args.model) and not args.golden_dir:
        parser.error("--int8/--reference_metrics/--model require --golden_dir "
                     "(they gate the golden-engine mode)")
    if args.full_gate:
        if not (args.model and args.golden_dir):
            parser.error("--full-gate requires --model and --golden_dir")
        args.int8 = True  # the int8 drift gate is part of the full gate
    report, failures = {}, []

    if args.ours_dir and args.theirs_dir:
        r = compare_depth_dirs(args.ours_dir, args.theirs_dir, device=args.device)
        report["dirs"] = r
        s = r["summary"]
        ok = bool(s["n_compared"]) and s["n_missing"] == 0 and all(
            v.get("abs_rel_vs_reference", float("inf")) <= args.gate
            for v in r["per_frame"].values() if not v.get("missing"))
        print(f"dir parity: {s['n_compared']}/{s['n_frames']} frames, "
              f"mean AbsRel {s['mean_abs_rel']:.5f}, "
              f"bit-equal {s['all_bit_equal']} -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append("dir-mode AbsRel gate")

    if args.golden_dir:
        _golden(args, report, failures)

    if not report:
        parser.error("need --ours_dir/--theirs_dir and/or --golden_dir")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=float)
    if args.full_gate:
        print(json.dumps({"full_gate": "FAIL" if failures else "PASS",
                          "stages": _stages(report, failures),
                          **({"failures": failures} if failures else {})}))
    if failures:
        print(f"PARITY GATE FAILED: {', '.join(failures)}")
        raise SystemExit(1)
    print("PARITY GATE PASSED")
    return report


if __name__ == "__main__":
    main()
