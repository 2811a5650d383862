#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (thermal3d_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from thermal3d_torch/kernels/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving shapes, in bf16 and f32, and time kernel, plain version, the
     PyTorch library yardstick and the card's bound;
  4. drive the serving path: a full-width bf16 DUSt3R-224 InferenceEngine
     (seeded random weights) answers batches of synthetic raw thermal frames
     [32, 320, 416]; its depth is held against the same engine run with the
     plain versions (attention_impl='torch', enhance_impl='plain'), and the
     kernels' launch counts over those batches must be K1 = n, K2 = 40·n,
     K3 = 16·n; one more batch runs under torch.profiler for the device
     time by layer and the device's idle share; then a float32 engine is
     held against its plain twin;
  5. print a JSON line of the kernels and, last, the device line.
Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; f32 CUDA cores
N_BATCHES = 4
BATCH = 32
RAW_HW = (320, 416)
# outputs of the bf16 kernel engine vs its plain twin, as max|Δ| / max|ref|:
# both run the same bf16 trunk and differ only where a kernel's f32
# summation order flips a bf16 rounding, which 32 residual blocks of random
# weights carry on and the exp heads amplify (measured 3-4% on an H100)
BF16_ENGINE_REL_LIMIT = 1e-1
# ... and vs a float32 twin, the kernels' bf16 error may be at most this
# many times the plain bf16 path's (plus 1e-3)
BF16_NOISE_FACTOR = 2.0
# the same in float32, where only summation order differs
F32_ENGINE_REL_LIMIT = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events over `reps`
    calls after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, limit: float) -> None:
    ok = err <= limit
    log(f"  {name}: max_abs_err {err:.3e} (limit {limit:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({err:.3e} > {limit:.1e})")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip()


def phase_build():
    from thermal3d_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernel libraries")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def k1_cases(torch):
    """K1 at [32, 224, 224], inputs as the serving path hands them over
    (per-image min/max normalised), with a flat and a bimodal frame."""
    from thermal3d_torch.kernels.image_ops import (GRID, percentile_enhance,
                                                   percentile_enhance_plain, search_target)

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((BATCH, 224, 224), generator=gen, device="cuda")
    x[0] = 0.0  # a flat frame normalises to zeros
    half = torch.rand((224, 224), generator=gen, device="cuda") < 0.5
    x[1] = torch.where(half, 0.2, 0.8) + 0.01 * torch.randn((224, 224), generator=gen,
                                                             device="cuda")
    x = (x - x.amin(dim=(1, 2), keepdim=True)) / (
        x.amax(dim=(1, 2), keepdim=True) - x.amin(dim=(1, 2), keepdim=True)).clamp(min=1e-30)
    x = x.contiguous()
    out = percentile_enhance(x)
    ref = percentile_enhance_plain(x)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # the same arithmetic step for step: expected bit-identical; 1 ulp at 1.0
    check("K1 percentile_enhance [32,224,224] f32", err, 1.2e-7)
    b, n = x.shape[0], x.shape[1] * x.shape[2]
    q = torch.floor(x.reshape(b, n) * GRID)
    k_lo = math.ceil(search_target(2.0, n))
    k_hi = math.ceil(search_target(98.0, n))
    ms = cuda_ms(lambda: percentile_enhance(x))
    plain_ms = cuda_ms(lambda: percentile_enhance_plain(x), reps=5)
    library_ms = cuda_ms(lambda: (torch.kthvalue(q, k_lo, dim=1), torch.kthvalue(q, k_hi, dim=1)))
    nbytes = 2 * b * n * 4
    ops = (2 * 16 + 4) * b * n  # 16 search passes of 2 compares + the rescale
    bnd, by = bound_ms(nbytes, ops, "float32")
    case = dict(shape=[b, 224, 224], dtype="float32", max_abs_err=err, limit=1.2e-7,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd, bound_by=by)
    log(f"  K1 ms {ms:.4f} plain {plain_ms:.4f} library(kthvalue x2) {library_ms:.4f} "
        f"bound {bnd:.4f} ({by})")
    return [case]


def attention_cases(torch, cross: bool):
    """K2 at encoder and decoder widths (K3 at decoder width), S=196, D=64."""
    import torch.nn.functional as F

    from thermal3d_torch.kernels.flash_attention import (fused_rope_attention,
                                                         fused_rope_attention_plain,
                                                         fused_rope_cross_attention,
                                                         rope_attention_plain, rot_lanes)
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    s, d = 196, 64
    cos, sin = rope_tables(make_grid_positions(14, 14, device="cuda"), d)
    widths = [(768, 12)] if cross else [(1024, 16), (768, 12)]
    cases = []
    for c, nh in widths:
        for dt in (torch.bfloat16, torch.float32):
            dname = "bfloat16" if dt == torch.bfloat16 else "float32"
            gen = torch.Generator(device="cuda").manual_seed(c)
            scale = 1.0 / math.sqrt(d)
            if cross:
                q, k, v = (torch.randn((BATCH, s, c), generator=gen, device="cuda").to(dt)
                           for _ in range(3))
                kern = lambda: fused_rope_cross_attention(q, k, v, cos, sin, nh, scale)  # noqa: E731
                plain = lambda: rope_attention_plain(q, k, v, cos, sin, nh, scale)  # noqa: E731
                nbytes = 4 * BATCH * s * c * q.element_size()
            else:
                qkv = torch.randn((BATCH, s, 3 * c), generator=gen, device="cuda").to(dt)
                q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
                kern = lambda: fused_rope_attention(qkv, cos, sin, nh, scale)  # noqa: E731
                plain = lambda: fused_rope_attention_plain(qkv, cos, sin, nh, scale)  # noqa: E731
                nbytes = 4 * BATCH * s * c * qkv.element_size()
            nbytes += 2 * s * d * 4  # the cos/sin tables

            def heads(t):
                return t.reshape(BATCH, s, nh, d).transpose(1, 2)

            def roped(t):
                tf = heads(t).float()
                return (tf * cos + rot_lanes(tf) * sin).to(dt)

            qr, kr, vh = roped(q), roped(k), heads(v).contiguous()
            library = lambda: F.scaled_dot_product_attention(qr, kr, vh)  # noqa: E731
            out = kern()
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            # f32: summation order only; bf16: the output is rounded to bf16
            # (1 ulp at |x| < 2 is 2^-7) and a flipped rounding of p adds one more
            limit = 2e-5 if dt == torch.float32 else 2.0 ** -6
            name = ("K3 fused_rope_cross_attention" if cross else "K2 fused_rope_attention")
            check(f"{name} [{BATCH},{s},{c}] H={nh} {dname}", err, limit)
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain)
            library_ms = cuda_ms(library)
            flops = 4 * BATCH * nh * s * s * d
            bnd, by = bound_ms(nbytes, flops, dname)
            log(f"    ms {ms:.4f} plain {plain_ms:.4f} library(sdpa) {library_ms:.4f} "
                f"bound {bnd:.4f} ({by})")
            cases.append(dict(shape=[BATCH, s, c], heads=nh, dtype=dname, max_abs_err=err,
                              limit=limit, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bnd, bound_by=by))
    return cases


def raw_frames(np, seed: int):
    """Synthetic raw thermal frames: counts 21000-26000 / 65535, a smooth
    gradient plus noise."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, RAW_HW[1], dtype=np.float32)
    raw = 21000.0 + 5000.0 * (0.6 * ramp + 0.4 * rng.uniform(size=(BATCH, *RAW_HW)))
    return (raw / 65535.0).astype(np.float32)


def rel_err(a, b, np) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check_outputs(out, np):
    shapes = {"pointmap1": (BATCH, 224, 224, 3), "pointmap2": (BATCH, 224, 224, 3),
              "confidence1": (BATCH, 224, 224), "confidence2": (BATCH, 224, 224),
              "depth": (BATCH, 224, 224)}
    for k, shp in shapes.items():
        if out[k].shape != shp or not np.isfinite(out[k]).all():
            raise AssertionError(f"engine output {k}: shape {out[k].shape} (want {shp}) "
                                 f"or non-finite values")


# device work by layer, matched on lower-cased kernel names (first match wins)
LAYERS = (("K2/K3 rope_attention", ("rope_attention",)),
          ("K1 percentile_enhance", ("percentile_enhance",)),
          ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
          ("LayerNorm", ("layer_norm",)),
          ("GELU", ("gelu",)),
          ("conv", ("conv",)),
          ("copies", ("memcpy", "memset")))


def profile_batch(torch, fn):
    """One warmed-up call of fn under torch.profiler: device time by layer,
    the device's busy time (union of its kernel and copy spans) and the host
    wall time of the call; idle share = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        log("profile: the profiler recorded no device events")
        return dict(wall_ms=wall_ms, device_events=0)
    by_layer, by_kernel = {}, {}
    busy_us, cur_end = 0.0, -math.inf
    for start, end, name in spans:
        ms = (end - start) / 1e3
        low = name.lower()
        layer = next((lay for lay, keys in LAYERS if any(k in low for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
        busy_us += max(0.0, end - max(start, cur_end))
        cur_end = max(cur_end, end)
    busy_ms = busy_us / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile (one infer() of {BATCH} frames, profiler on): wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    log(f"  device ms by layer: {json.dumps(by_layer)}")
    for name, ms in top:
        log(f"  {ms:9.3f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                device_events=len(spans), by_layer=by_layer)


def phase_engine(torch, np):
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.kernels.flash_attention import (fused_rope_attention,
                                                         fused_rope_cross_attention)
    from thermal3d_torch.kernels.image_ops import percentile_enhance

    counters = (percentile_enhance, fused_rope_attention, fused_rope_cross_attention)
    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    ref_eng = InferenceEngine(dataclasses.replace(cfg, attention_impl="torch"),
                              state_dict=eng.model.state_dict(), params_dtype="bfloat16",
                              enhance_impl="plain")
    log(f"engine: two full-width bf16 engines built in {time.perf_counter() - t0:.1f} s")
    frames = [raw_frames(np, seed) for seed in range(N_BATCHES)]
    check_outputs(eng.infer(frames[0]), np)  # warm-up
    torch.cuda.synchronize()

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [eng.infer(f) for f in frames]  # numpy results: waits for the card
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    fps = BATCH * N_BATCHES / elapsed
    log(f"engine: {N_BATCHES} batches of {BATCH} raw frames {RAW_HW} in {elapsed:.4f} s: "
        f"{fps:.2f} frames/s; launches {launches}")
    want = {"percentile_enhance": N_BATCHES, "fused_rope_attention": 40 * N_BATCHES,
            "fused_rope_cross_attention": 16 * N_BATCHES}
    if launches != want:
        raise AssertionError(f"the serving path did not run through the kernels: "
                             f"launches {launches}, want {want}")
    for out in outs:
        check_outputs(out, np)

    t0 = time.perf_counter()
    for f in frames:
        dev_out = eng.infer_async(f)
    torch.cuda.synchronize()
    fps_device = BATCH * N_BATCHES / (time.perf_counter() - t0)
    del dev_out
    log(f"engine: infer_async (no host copy of results) {fps_device:.2f} frames/s")
    breakdown = profile_batch(torch, lambda: eng.infer(frames[0]))

    # bf16 against float32: a float32 engine with the same bf16-rounded
    # weights, on the plain versions, is the reference both bf16 engines are
    # measured against; the kernels' bf16 error must stay within the bf16
    # noise of the plain bf16 path
    gold_eng = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, attention_impl="torch"),
                               state_dict=eng.model.state_dict(), enhance_impl="plain")
    ref = ref_eng.infer(frames[0])
    gold = gold_eng.infer(frames[0])
    errs = {k: rel_err(outs[0][k], ref[k], np) for k in ref}
    noise = {k: rel_err(ref[k], gold[k], np) for k in ref}
    kern_err = {k: rel_err(outs[0][k], gold[k], np) for k in ref}
    log(f"engine bf16 kernels vs bf16 plain twin, max|Δ|/max|ref|: {errs} "
        f"(limit {BF16_ENGINE_REL_LIMIT})")
    log(f"engine bf16 vs f32 (same weights): plain {noise}, kernels {kern_err} "
        f"(limit: kernels <= {BF16_NOISE_FACTOR} x plain + 1e-3)")
    if max(errs.values()) > BF16_ENGINE_REL_LIMIT or any(
            kern_err[k] > BF16_NOISE_FACTOR * noise[k] + 1e-3 for k in ref):
        raise AssertionError(f"bf16 engine disagrees with its plain twin: {errs}, "
                             f"vs f32: plain {noise}, kernels {kern_err}")
    del eng, ref_eng, gold_eng, outs

    # float32 twins on a few frames: a tight check of the whole path's wiring
    f32 = InferenceEngine(DUSTR_224_LINEAR, seed=1)
    f32_ref = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, attention_impl="torch"),
                              state_dict=f32.model.state_dict(), enhance_impl="plain")
    small = frames[1][:4]
    a, b = f32.infer(small), f32_ref.infer(small)
    errs32 = {k: rel_err(a[k], b[k], np) for k in b}
    log(f"engine f32 vs plain twin, max|Δ|/max|ref|: {errs32} (limit {F32_ENGINE_REL_LIMIT})")
    if max(errs32.values()) > F32_ENGINE_REL_LIMIT:
        raise AssertionError(f"f32 engine disagrees with its plain twin: {errs32}")
    return dict(fps=fps, fps_device=fps_device, batch=BATCH, raw_hw=list(RAW_HW),
                n_batches=N_BATCHES, launches=launches, breakdown=breakdown,
                bf16_rel_err=errs,
                bf16_plain_vs_f32=noise, bf16_kernels_vs_f32=kern_err, f32_rel_err=errs32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()

    log("kernels vs plain versions at the serving shapes:")
    k1 = k1_cases(torch)
    k2 = attention_cases(torch, cross=False)
    k3 = attention_cases(torch, cross=True)
    engine = phase_engine(torch, np)

    def entry(name, source, replaces, cases, main_case):
        m = cases[main_case]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=engine["launches"][name],
                    max_abs_err=max(c["max_abs_err"] for c in cases), ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    library_ms=m["library_ms"], main_case=m, cases=cases)

    kernels = [
        entry("percentile_enhance", "thermal3d_torch/kernels/csrc/percentile_enhance.cu",
              "thermal3d/kernels/image_ops.py:44", k1, 0),
        entry("fused_rope_attention", "thermal3d_torch/kernels/csrc/rope_attention.cu",
              "thermal3d/kernels/flash_attention.py:310", k2, 0),
        entry("fused_rope_cross_attention", "thermal3d_torch/kernels/csrc/rope_attention.cu",
              "thermal3d/kernels/flash_attention.py:415", k3, 0),
    ]
    print(card, flush=True)
    print(json.dumps({"engine": engine}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
