#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (thermal3d_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from thermal3d_torch/kernels/csrc with nvcc (one
     nvcc process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card, in bf16
     and f32, and time kernel, plain version, the PyTorch library yardstick
     and the card's bound: K1 at the serving shape [32,224,224], at full
     Freiburg frames [4,512,640] and at [1,16,16]; K2/K3 at the serving
     shapes (S=196) and the MASt3R-512 shapes (S=1024); K4/K5/K6 at both,
     and with Sq=196 against Sk=1024; K2-K6 also in bf16 at head_dim 32,
     both S. Each K2-K6 case records the kernel
     that served it: bf16 with head_dim 64 the tensor-core kernel (its own
     count moves), float32, and bf16 at head_dim 32, a CUDA-core kernel (K2/K3:
     one-shot at S=196, key-tile at S=1024);
  4. drive the serving path: a full-width bf16 DUSt3R-224 InferenceEngine
     (seeded random weights) answers batches of synthetic raw thermal frames
     [32, 320, 416]; its depth is held against the same engine run with the
     plain versions (attention_impl='torch', enhance_impl='plain'), and the
     kernels' launch counts over those batches must be K1 = n, K2 = 40·n,
     K3 = 16·n, and the tensor-core kernel's own count K2 + K3; one more
     batch runs under torch.profiler for the device time by layer and the
     device's idle share; then a float32 engine is held against its plain
     twin, with the tensor-core count 0 there;
  5. drive the pseudo-GT path: a full-width, full-depth bf16
     MASt3R-512 PseudoGTGenerator (seeded random weights) turns batches of 4
     synthetic RGB pairs [4, 512, 512, 3] into the eight pseudo-GT arrays,
     with launch counts K2 = 48·n, K3 = 24·n (all on the tensor-core
     kernel: its count 72·n); pairs/s with and without the
     host copies; the outputs against a plain twin (attention_impl='torch')
     and a float32 twin; the geometry against float64 numpy; one step under
     torch.profiler; then attention_impl='pallas' (K4 = 72·n) at full depth,
     with one step under torch.profiler,
     and 'pallas_grouped4' (K5) and 'pallas_multihead' (K6) at encoder and
     decoder depth 2 (10·n each), each against its plain twin, all on the
     tensor-core K4-K6 kernel (its count equal to theirs);
  6. print JSON lines of the two paths and of the kernels and, last, the
     device line.
Without CUDA it exits non-zero before printing any result.

    python3 chip_smoke.py --compare-k2k3 OTHER_CSRC_DIR

holds this checkout's tensor-core K2/K3 kernel against a build of another
checkout's csrc/rope_attention_tc.cu instead (torch.equal on the bf16 K2/K3
shapes of both paths, times in turns) and exits non-zero if any differs.
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
PAIR_BATCH = 4  # pairs a pseudo-GT step (bench.py's MASt3R-512 batch)
N_PAIR_BATCHES = 3  # timed pseudo-GT steps after one warm-up step
PGT_KEYS = ("pointmap1", "pointmap2", "confidence1", "confidence2", "depth1", "depth2")
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
# pseudo-GT outputs of a kernel route, max|Δ|/max|ref| on PGT_KEYS: against a
# float32 twin (plain attention, the same bf16-rounded weights) at most
# BF16_NOISE_FACTOR × the bf16 plain twin's own error against it, plus 1e-3,
# as for the engine; and so, by the triangle inequality, against the bf16
# plain twin at most (1 + BF16_NOISE_FACTOR) × that error, plus 1e-3. (A
# fixed 0.1 against the plain twin, as for the engine, was set before the
# first run and failed there at 0.163: over 24+12 blocks at S=1024 the exp
# heads amplify bf16 roundings of random weights more than at 224.)
# geometry of the generator's own pointmaps against a float64 numpy restatement:
# the focal medians are f32 quotients (a few ulp); the f32 Umeyama pose must
# fit the valid points as well as the f64 one (residual within 0.1%) and be a
# rotation
GEOM_FOCAL_RTOL = 1e-5
GEOM_RESIDUAL_RTOL = 1e-3
GEOM_ORTHO_ATOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, replays: int = 3) -> float:
    """Mean device milliseconds of one fn() call: after `warmup` eager
    calls, `reps` calls are captured in one CUDA graph, which is replayed
    `replays` times between CUDA events. A replay needs no host work per
    launch, so the time is the card's, not the launch rate of the Python
    wrappers (which bounds an eager loop of calls shorter than ~0.1 ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    return ms


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


# K1 shapes: the serving batch, full 640x512 Freiburg frames (over the
# one-block kernel's old limit of 116,096 pixels an image) and one small image
K1_SHAPES = ((BATCH, 224, 224), (4, 512, 640), (1, 16, 16))


def k1_cases(torch):
    """K1 at K1_SHAPES, inputs as the serving path hands them over (per-image
    min/max normalised), with a flat and a bimodal frame where the batch has
    room for them."""
    from thermal3d_torch.kernels.image_ops import (GRID, percentile_enhance,
                                                   percentile_enhance_plain, search_target)

    cases = []
    for b, h, w in K1_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.rand((b, h, w), generator=gen, device="cuda")
        if b > 2:
            x[0] = 0.0  # a flat frame normalises to zeros
            half = torch.rand((h, w), generator=gen, device="cuda") < 0.5
            x[1] = torch.where(half, 0.2, 0.8) + 0.01 * torch.randn((h, w), generator=gen,
                                                                     device="cuda")
        x = (x - x.amin(dim=(1, 2), keepdim=True)) / (
            x.amax(dim=(1, 2), keepdim=True) - x.amin(dim=(1, 2), keepdim=True)).clamp(min=1e-30)
        x = x.contiguous()
        out = percentile_enhance(x)
        ref = percentile_enhance_plain(x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # the same order statistics and rescale: expected bit-identical; 1 ulp at 1.0
        check(f"K1 percentile_enhance [{b},{h},{w}] f32", err, 1.2e-7)
        n = h * w
        q = torch.floor(x.reshape(b, n) * GRID)
        k_lo = math.ceil(search_target(2.0, n))
        k_hi = math.ceil(search_target(98.0, n))
        ms = cuda_ms(lambda: percentile_enhance(x))
        plain_ms = cuda_ms(lambda: percentile_enhance_plain(x), reps=5)
        library_ms = cuda_ms(lambda: (torch.kthvalue(q, k_lo, dim=1),
                                      torch.kthvalue(q, k_hi, dim=1)))
        nbytes = 2 * b * n * 4
        ops = (3 * 4 + 4) * b * n  # 3 quantisations of 4 ops a pixel + the rescale
        bnd, by = bound_ms(nbytes, ops, "float32")
        cases.append(dict(shape=[b, h, w], dtype="float32", max_abs_err=err, limit=1.2e-7,
                          ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd,
                          bound_by=by))
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library(kthvalue x2) {library_ms:.4f} "
            f"bound {bnd:.4f} ({by}); {ms / bnd:.2f}x bound")
        del x, q, out, ref
    return cases


def attention_cases(torch, cross: bool, batch: int = BATCH, grid=(14, 14), widths=None,
                    reps: int = 20, dtypes=("bfloat16", "float32")):
    """K2 (K3 with cross=True) on a grid×grid patch grid: the serving
    shapes (S=196) by default, MASt3R-512's (S=1024) with grid (32, 32);
    `widths` are (C, heads), D=64 by default. bf16 with D=64 runs the
    tensor-core kernel; float32 and other head dims the CUDA-core one-shot
    kernel, or the key-tile kernel where K/V of a head do not fit in shared
    memory. Each case records the kernel that served it."""
    import torch.nn.functional as F

    from thermal3d_torch.kernels import flash_attention as fa
    from thermal3d_torch.kernels.flash_attention import (fused_rope_attention,
                                                         fused_rope_attention_plain,
                                                         fused_rope_cross_attention,
                                                         rope_attention_plain, rot_lanes)
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    s = grid[0] * grid[1]
    positions = make_grid_positions(*grid, device="cuda")
    if widths is None:
        widths = [(768, 12)] if cross else [(1024, 16), (768, 12)]
    cases = []
    for c, nh in widths:
        d = c // nh
        cos, sin = rope_tables(positions, d)
        for dname in dtypes:
            dt = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(c)
            scale = 1.0 / math.sqrt(d)
            if cross:
                q, k, v = (torch.randn((batch, s, c), generator=gen, device="cuda").to(dt)
                           for _ in range(3))
                kern = lambda: fused_rope_cross_attention(q, k, v, cos, sin, nh, scale)  # noqa: E731
                plain = lambda: rope_attention_plain(q, k, v, cos, sin, nh, scale)  # noqa: E731
                nbytes = 4 * batch * s * c * q.element_size()
            else:
                qkv = torch.randn((batch, s, 3 * c), generator=gen, device="cuda").to(dt)
                q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
                kern = lambda: fused_rope_attention(qkv, cos, sin, nh, scale)  # noqa: E731
                plain = lambda: fused_rope_attention_plain(qkv, cos, sin, nh, scale)  # noqa: E731
                nbytes = 4 * batch * s * c * qkv.element_size()
            nbytes += 2 * s * d * 4  # the cos/sin tables

            def heads(t):
                return t.reshape(batch, s, nh, d).transpose(1, 2)

            def roped(t):
                tf = heads(t).float()
                return (tf * cos + rot_lanes(tf) * sin).to(dt)

            qr, kr, vh = roped(q), roped(k), heads(v).contiguous()
            library = lambda: F.scaled_dot_product_attention(qr, kr, vh)  # noqa: E731
            on_tc = dt == torch.bfloat16 and d == 64
            route = fa.attention_route(dt, d)
            if (route == fa.TENSOR_CORE) != on_tc:
                raise AssertionError(f"K2/K3 {dname} D={d}: routed to {route}")
            tc_before = fa.rope_attention_tc.launches
            out = kern()
            if (fa.rope_attention_tc.launches > tc_before) != on_tc:
                raise AssertionError(f"K2/K3 {dname} S={s} D={d}: tensor-core kernel "
                                     f"{'not ' if on_tc else ''}launched")
            served = (fa.TENSOR_CORE if on_tc else "one_shot"
                      if fa.smem_bytes(s, d, dt) <= fa.SMEM_LIMIT else "key_tile")
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            # f32: summation order only; bf16: the output is rounded to bf16
            # (1 ulp at |x| < 2 is 2^-7) and a flipped rounding of p adds one
            # more (the key-tile loop rounds p against a running max)
            limit = 2e-5 if dt == torch.float32 else 2.0 ** -6
            name = ("K3 fused_rope_cross_attention" if cross else "K2 fused_rope_attention")
            check(f"{name} [{batch},{s},{c}] H={nh} D={d} {dname}", err, limit)
            ms = cuda_ms(kern, reps=reps)
            plain_ms = cuda_ms(plain, reps=reps)
            library_ms = cuda_ms(library, reps=reps)
            flops = 4 * batch * nh * s * s * d
            bnd, by = bound_ms(nbytes, flops, dname)
            tflops = flops / ms / 1e9
            log(f"    {served}: ms {ms:.4f} plain {plain_ms:.4f} library(sdpa) "
                f"{library_ms:.4f} bound {bnd:.4f} ({by}); {tflops:.1f} TFLOP/s, "
                f"{ms / bnd:.2f}x bound, {ms / library_ms:.2f}x sdpa")
            cases.append(dict(shape=[batch, s, c], heads=nh, head_dim=d, dtype=dname,
                              kernel=served, max_abs_err=err, limit=limit, ms=ms,
                              plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd, bound_by=by,
                              tflops=tflops, ms_over_bound=ms / bnd,
                              ms_over_library=ms / library_ms))
            del qr, kr, vh, q, k, v
            torch.cuda.empty_cache()
    return cases


# K4/K5/K6 shapes [B, H, Sq, Sk, D]: MASt3R-512's encoder (8 = 4 pairs × 2
# views, 16 heads) and decoder (4 pairs, 12 heads) at S=1024, DUSt3R-224's
# at the serving S=196 (a ragged last tile of 4 keys and 68 query rows),
# and Sq=196 against Sk=1024
PLAIN_ATTENTION_SHAPES = ((8, 16, 1024, 1024, 64), (4, 12, 1024, 1024, 64),
                          (BATCH, 16, 196, 196, 64), (BATCH, 12, 196, 196, 64),
                          (4, 12, 196, 1024, 64))
# bf16 at head_dim 32 (no configured model): the CUDA-core kernel in bf16
PLAIN_ATTENTION_D32 = ((BATCH, 16, 196, 196, 32), (PAIR_BATCH, 16, 1024, 1024, 32))


def plain_attention_cases(torch, name: str, shapes=PLAIN_ATTENTION_SHAPES,
                          dtypes=("bfloat16", "float32"), reps: int = 10):
    """One of K4 (flash_attention_pallas), K5 (flash_attention_grouped) or K6
    (flash_attention_multihead) on [B,S,H,D] q/k/v handed over as
    [B,H,S,D] views, as attention_bshd hands them on the main path. bf16
    with D=64 runs the tensor-core kernel, float32 and other head dims the
    CUDA-core one; each case records the kernel that served it."""
    import torch.nn.functional as F

    from thermal3d_torch.kernels import flash_attention as fa

    kern_fn = getattr(fa, name)
    cases = []
    for b, h, sq, sk, d in shapes:
        for dname in dtypes:
            dt = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(h + sq)
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
            k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dt)
                    .transpose(1, 2) for _ in range(2))
            scale = 1.0 / math.sqrt(d)
            kern = lambda: kern_fn(q, k, v, scale)  # noqa: E731
            plain = lambda: fa.attention_plain(q, k, v, scale)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
            served = fa.attention_route(dt, d)
            if (served == fa.TENSOR_CORE) != (dt == torch.bfloat16 and d == 64):
                raise AssertionError(f"{name} {dname} D={d}: routed to {served}")
            tc_before, fn_before = fa.softmax_attention_tc.launches, kern_fn.launches
            out = kern()
            if kern_fn.launches != fn_before + 1 or \
                    fa.softmax_attention_tc.launches - tc_before != (served == fa.TENSOR_CORE):
                raise AssertionError(f"{name} {dname} D={d}: launches {kern_fn.launches - fn_before}"
                                     f", tensor-core {fa.softmax_attention_tc.launches - tc_before}")
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            limit = 2e-5 if dt == torch.float32 else 2.0 ** -6  # as for K2/K3
            check(f"{name} [{b},{h},{sq},{d}] Sk={sk} {dname}", err, limit)
            ms = cuda_ms(kern, reps=reps)
            plain_ms = cuda_ms(plain, reps=reps)
            library_ms = cuda_ms(library, reps=reps)
            nbytes = 2 * b * h * (sq + sk) * d * q.element_size()
            flops = 4 * b * h * sq * sk * d
            bnd, by = bound_ms(nbytes, flops, dname)
            tflops = flops / ms / 1e9
            log(f"    {served}: ms {ms:.4f} plain {plain_ms:.4f} library(sdpa) "
                f"{library_ms:.4f} bound {bnd:.4f} ({by}); {tflops:.1f} TFLOP/s, "
                f"{ms / bnd:.2f}x bound, {ms / library_ms:.2f}x sdpa")
            cases.append(dict(shape=[b, h, sq, d], sk=sk, dtype=dname, kernel=served,
                              max_abs_err=err, limit=limit, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bnd, bound_by=by, tflops=tflops,
                              ms_over_bound=ms / bnd, ms_over_library=ms / library_ms))
            del q, k, v
            torch.cuda.empty_cache()
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


# device work by layer, matched on lower-cased kernel names (first match wins;
# cuDNN's conv kernels carry "fprop"/"dgrad" and are matched before the GEMMs)
LAYERS = (("K2/K3 rope_attention", ("rope_attention",)),
          ("K4-K6 softmax_attention", ("softmax_attention",)),
          ("K1 percentile_enhance", ("percentile_enhance",)),
          ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd", "implicit")),
          ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
          ("LayerNorm", ("layer_norm",)),
          ("GELU", ("gelu",)),
          ("copies", ("memcpy", "memset")))


def profile_batch(torch, fn, what: str = f"one infer() of {BATCH} frames"):
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
    log(f"profile ({what}, profiler on): wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    log(f"  device ms by layer: {json.dumps(by_layer)}")
    for name, ms in top:
        log(f"  {ms:9.3f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                device_events=len(spans), by_layer=by_layer)


def kernel_counters():
    """The launch counters of K1-K6, in order, then the tensor-core K2/K3
    kernel's own and the tensor-core K4-K6 kernel's own (every bf16 launch
    with head_dim 64 goes through them)."""
    from thermal3d_torch.kernels import flash_attention as fa
    from thermal3d_torch.kernels.image_ops import percentile_enhance

    return (percentile_enhance, fa.fused_rope_attention, fa.fused_rope_cross_attention,
            fa.flash_attention_pallas, fa.flash_attention_grouped,
            fa.flash_attention_multihead, fa.rope_attention_tc, fa.softmax_attention_tc)


def run_counted(fn, want_by_name):
    """Set every kernel count to 0, run fn(), read the counts: they must
    equal want_by_name (a kernel not named must not launch at all)."""
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    result = fn()
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: want_by_name.get(c.__name__, 0) for c in counters}
    if launches != want:
        raise AssertionError(f"the path did not run through its kernels: launches "
                             f"{launches}, want {want}")
    return result, {k: v for k, v in launches.items() if v}


def phase_engine(torch, np):
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine
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

    def serve():
        t0 = time.perf_counter()
        outs = [eng.infer(f) for f in frames]  # numpy results: waits for the card
        return outs, time.perf_counter() - t0

    want = {"percentile_enhance": N_BATCHES, "fused_rope_attention": 40 * N_BATCHES,
            "fused_rope_cross_attention": 16 * N_BATCHES, "rope_attention_tc": 56 * N_BATCHES}
    (outs, elapsed), launches = run_counted(serve, want)
    fps = BATCH * N_BATCHES / elapsed
    log(f"engine: {N_BATCHES} batches of {BATCH} raw frames {RAW_HW} in {elapsed:.4f} s: "
        f"{fps:.2f} frames/s; launches {launches}")
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
    # the float32 engine runs the CUDA-core K2/K3 kernels, none on tensor cores
    a, f32_launches = run_counted(lambda: f32.infer(small), {
        "percentile_enhance": 1, "fused_rope_attention": 40, "fused_rope_cross_attention": 16})
    log(f"engine f32: launches {f32_launches}")
    b = f32_ref.infer(small)
    errs32 = {k: rel_err(a[k], b[k], np) for k in b}
    log(f"engine f32 vs plain twin, max|Δ|/max|ref|: {errs32} (limit {F32_ENGINE_REL_LIMIT})")
    if max(errs32.values()) > F32_ENGINE_REL_LIMIT:
        raise AssertionError(f"f32 engine disagrees with its plain twin: {errs32}")
    return dict(fps=fps, fps_device=fps_device, batch=BATCH, raw_hw=list(RAW_HW),
                n_batches=N_BATCHES, launches=launches, f32_launches=f32_launches,
                breakdown=breakdown,
                bf16_rel_err=errs,
                bf16_plain_vs_f32=noise, bf16_kernels_vs_f32=kern_err, f32_rel_err=errs32)


def rgb_pairs(np, seed: int):
    """A batch of synthetic RGB pairs [PAIR_BATCH, 512, 512, 3] in [0, 1]:
    smooth colour ramps plus noise, view 2 a shifted copy of view 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512), indexing="ij")
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1)[None]
    rgb1 = 0.7 * base + 0.3 * rng.uniform(size=(PAIR_BATCH, 512, 512, 3))
    rgb2 = np.roll(rgb1, 8, axis=2) * 0.95 + 0.05 * rng.uniform(size=rgb1.shape)
    return rgb1.astype(np.float32), rgb2.astype(np.float32)


def check_pgt_outputs(out, np):
    shapes = {"pointmap1": (PAIR_BATCH, 512, 512, 3), "pointmap2": (PAIR_BATCH, 512, 512, 3),
              "confidence1": (PAIR_BATCH, 512, 512), "confidence2": (PAIR_BATCH, 512, 512),
              "depth1": (PAIR_BATCH, 512, 512), "depth2": (PAIR_BATCH, 512, 512),
              "intrinsics": (PAIR_BATCH, 3, 3), "poses": (PAIR_BATCH, 4, 4)}
    if sorted(out) != sorted(shapes):
        raise AssertionError(f"pseudo-GT keys {sorted(out)}")
    for k, shp in shapes.items():
        # a focal median is NaN where a view has no pixel with Z > 0 (as in
        # the JAX generator); every other value must be finite
        vals = out[k] if k != "intrinsics" else np.nan_to_num(out[k], nan=0.0)
        if out[k].shape != shp or out[k].dtype != np.float32 or not np.isfinite(vals).all():
            raise AssertionError(f"pseudo-GT output {k}: shape {out[k].shape} (want {shp}), "
                                 f"dtype {out[k].dtype} or non-finite values")


def geometry_f64(pm1, pm2, np):
    """Intrinsics and relative pose of one pair, restated in float64 numpy
    from the same float32 pointmaps: (fx, fy, R, t, ok, x, y) with x, y the
    valid source/target points [N, 3]."""
    h, w = pm1.shape[:2]
    p1, p2 = pm1.astype(np.float64), pm2.astype(np.float64)
    z = p1[..., 2]
    v, u = np.mgrid[0:h, 0:w]
    mask = z > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        fx = np.nanmedian(np.where(mask, (u - w / 2) / (p1[..., 0] / np.where(mask, z, 1)), np.nan))
        fy = np.nanmedian(np.where(mask, (v - h / 2) / (p1[..., 1] / np.where(mask, z, 1)), np.nan))
    valid = ((p1[..., 2] > 0) & (p2[..., 2] > 0) & np.isfinite(p1).all(-1)
             & np.isfinite(p2).all(-1))
    x, y = p1[valid], p2[valid]
    mx, my = x.mean(0), y.mean(0)
    cov = (y - my).T @ (x - mx) / len(x) if len(x) else np.zeros((3, 3))
    uu, d, vt = np.linalg.svd(cov)
    s = np.ones(3)
    s[-1] = -1.0 if np.linalg.det(uu) * np.linalg.det(vt) < 0 else 1.0
    r = uu @ np.diag(s) @ vt
    t = my - r @ mx
    ok = len(x) >= 10 and int((d > np.finfo(np.float32).eps).sum()) >= 2
    return fx, fy, r, t, ok, x, y


def check_geometry(out, np):
    """The generator's intrinsics and poses against geometry_f64 on its own
    pointmaps. Focal lengths to GEOM_FOCAL_RTOL; a pose must be a rotation
    and fit the valid points as well as the float64 pose (its residual within
    GEOM_RESIDUAL_RTOL), or be the identity where the float64 pose is not ok."""
    report = []
    for i in range(out["pointmap1"].shape[0]):
        fx, fy, r64, t64, ok, x, y = geometry_f64(out["pointmap1"][i], out["pointmap2"][i], np)
        k = out["intrinsics"][i].astype(np.float64)
        pose = out["poses"][i].astype(np.float64)
        for got, want, name in ((k[0, 0], fx, "fx"), (k[1, 1], fy, "fy")):
            if not (np.isnan(got) and np.isnan(want)) and \
                    abs(got - want) > GEOM_FOCAL_RTOL * abs(want):
                raise AssertionError(f"pair {i}: {name} {got} vs float64 {want}")
        r, t = pose[:3, :3], pose[:3, 3]
        if not ok:
            if not np.array_equal(pose, np.eye(4)):
                raise AssertionError(f"pair {i}: float64 finds no pose, the card's is {pose}")
            report.append(dict(pair=i, identity=True))
            continue
        ortho = np.abs(r.T @ r - np.eye(3)).max()
        res = float(((y - x @ r.T - t) ** 2).sum(1).mean())
        res64 = float(((y - x @ r64.T - t64) ** 2).sum(1).mean())
        report.append(dict(pair=i, focal_rel=[float(abs(k[0, 0] / fx - 1)),
                                              float(abs(k[1, 1] / fy - 1))],
                           ortho=float(ortho), det=float(np.linalg.det(r)),
                           residual=res, residual_f64=res64,
                           r_diff=float(np.abs(r - r64).max()),
                           t_diff=float(np.abs(t - t64).max())))
        if ortho > GEOM_ORTHO_ATOL or np.linalg.det(r) < 0 or \
                res > res64 * (1 + GEOM_RESIDUAL_RTOL) + 1e-12:
            raise AssertionError(f"pair {i}: pose disagrees with float64: {report[-1]}")
    log(f"pseudo-GT geometry vs float64: {json.dumps(report)}")
    return report


def phase_pseudo_gt(torch, np):
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    cfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    gen = PseudoGTGenerator(cfg, params_dtype="bfloat16", seed=0)
    log(f"pseudo-GT: full-width bf16 MASt3R-512 generator built in "
        f"{time.perf_counter() - t0:.1f} s")
    weights = gen.model.state_dict()
    pairs = [rgb_pairs(np, seed) for seed in range(N_PAIR_BATCHES)]
    n = N_PAIR_BATCHES

    def drive(g):
        t0 = time.perf_counter()
        outs = [g.run_pairs(*p) for p in pairs]  # numpy results: waits for the card
        return outs, time.perf_counter() - t0

    check_pgt_outputs(gen.run_pairs(*pairs[0]), np)  # warm-up
    torch.cuda.synchronize()
    (outs, elapsed), launches = run_counted(
        lambda: drive(gen),
        {"fused_rope_attention": 48 * n, "fused_rope_cross_attention": 24 * n,
         "rope_attention_tc": 72 * n})
    pps = PAIR_BATCH * n / elapsed
    log(f"pseudo-GT: {n} steps of {PAIR_BATCH} pairs in {elapsed:.4f} s: {pps:.3f} pairs/s "
        f"(run_pairs, host copies included); launches {launches}")
    for out in outs:
        check_pgt_outputs(out, np)
    t0 = time.perf_counter()
    for p in pairs:
        dev_out = gen.run_pairs_async(*p)
    torch.cuda.synchronize()
    pps_device = PAIR_BATCH * n / (time.perf_counter() - t0)
    del dev_out
    log(f"pseudo-GT: run_pairs_async (no host copies) {pps_device:.3f} pairs/s")
    breakdown = profile_batch(torch, lambda: gen.run_pairs(*pairs[0]),
                              f"one run_pairs() of {PAIR_BATCH} pairs")
    geometry = check_geometry(outs[0], np)

    def rel(a, b):
        return {k: rel_err(a[k], b[k], np) for k in b}

    def hold(out, twin, gold, what):
        """out (a kernel route) against its bf16 plain twin and its float32
        twin; see BF16_NOISE_FACTOR above."""
        errs, noise, vs_f32 = rel(out, twin), rel(twin, gold), rel(out, gold)
        f = BF16_NOISE_FACTOR
        log(f"pseudo-GT {what}, max|Δ|/max|ref| (gated on {', '.join(PGT_KEYS)}; "
            f"intrinsics/poses printed only):\n  vs bf16 plain twin {json.dumps(errs)}"
            f"\n  plain twin vs f32 {json.dumps(noise)}\n  vs f32 {json.dumps(vs_f32)}")
        bad = [k for k in PGT_KEYS if vs_f32[k] > f * noise[k] + 1e-3
               or errs[k] > (1 + f) * noise[k] + 1e-3]
        if bad:
            raise AssertionError(f"pseudo-GT {what}: outside the bf16 noise on {bad}")
        return dict(vs_plain_twin=errs, plain_twin_vs_f32=noise, vs_f32=vs_f32)

    def twins(config, state):
        """Outputs of the bf16 plain twin and the float32 plain twin on pairs[0]."""
        outs_ = []
        for dt in ("bfloat16", None):
            c = dataclasses.replace(config, attention_impl="torch",
                                    compute_dtype=dt or "float32")
            g = PseudoGTGenerator(c, state_dict=state, params_dtype=dt)
            outs_.append(run_counted(lambda: g.run_pairs(*pairs[0]), {})[0])  # no kernel
            del g
            torch.cuda.empty_cache()
        return outs_

    ref, gold = twins(cfg, weights)
    held = hold(outs[0], ref, gold, "bf16 'auto' (K2/K3)")
    del gen
    torch.cuda.empty_cache()

    # attention_impl='pallas': RoPE on the heads, then K4, at full depth
    gen_p = PseudoGTGenerator(dataclasses.replace(cfg, attention_impl="pallas"),
                              state_dict=weights, params_dtype="bfloat16")
    gen_p.run_pairs(*pairs[0])  # warm-up
    torch.cuda.synchronize()
    (outs_p, elapsed_p), launches_p = run_counted(
        lambda: drive(gen_p), {"flash_attention_pallas": 72 * n, "softmax_attention_tc": 72 * n})
    pps_pallas = PAIR_BATCH * n / elapsed_p
    log(f"pseudo-GT 'pallas': {pps_pallas:.3f} pairs/s (run_pairs); launches {launches_p}")
    for out in outs_p:
        check_pgt_outputs(out, np)
    breakdown_p = profile_batch(torch, lambda: gen_p.run_pairs(*pairs[0]),
                                f"one 'pallas' run_pairs() of {PAIR_BATCH} pairs")
    held_p = hold(outs_p[0], ref, gold, "bf16 'pallas' (K4)")
    del gen_p, outs_p
    torch.cuda.empty_cache()

    # K5 and K6 at encoder and decoder depth 2: 2 + 4·2 launches a step
    small = dataclasses.replace(cfg, enc_depth=2, dec_depth=2)
    small_weights = PseudoGTGenerator(small, params_dtype="bfloat16",
                                      seed=1).model.state_dict()
    ref_small, gold_small = twins(small, small_weights)
    reduced = {}
    for impl, counter in (("pallas_grouped4", "flash_attention_grouped"),
                          ("pallas_multihead", "flash_attention_multihead")):
        g = PseudoGTGenerator(dataclasses.replace(small, attention_impl=impl),
                              state_dict=small_weights, params_dtype="bfloat16")
        (out_s,), launches_s = run_counted(lambda: [g.run_pairs(*pairs[0])],
                                           {counter: 10, "softmax_attention_tc": 10})
        log(f"pseudo-GT {impl!r} at depth 2: launches {launches_s}")
        check_pgt_outputs(out_s, np)
        reduced[impl] = dict(launches=launches_s,
                             **hold(out_s, ref_small, gold_small, f"bf16 {impl!r} at depth 2"))
        del g
    return dict(pairs_per_s=pps, pairs_per_s_device=pps_device, batch_pairs=PAIR_BATCH,
                n_steps=n, launches=launches, breakdown=breakdown, geometry=geometry,
                rel_err=held, pallas=dict(pairs_per_s=pps_pallas, launches=launches_p,
                                          breakdown=breakdown_p, rel_err=held_p),
                reduced_depth=reduced)


# --compare-k2k3: (K2 or K3, batch, grid side, width C, heads), the bf16
# K2/K3 calls of the serving path (DUSt3R-224) and the pseudo-GT path
# (MASt3R-512)
COMPARE_CASES = (("K2", BATCH, 14, 1024, 16), ("K2", BATCH, 14, 768, 12),
                 ("K3", BATCH, 14, 768, 12), ("K2", 2 * PAIR_BATCH, 32, 1024, 16),
                 ("K2", PAIR_BATCH, 32, 768, 12), ("K3", PAIR_BATCH, 32, 768, 12))


def compare_k2k3(torch, other_csrc: str) -> bool:
    """Build OTHER_CSRC/rope_attention_tc.cu with this checkout's nvcc flags
    and launch it and this checkout's build through the same wrapper on the
    same seeded inputs: torch.equal on each of COMPARE_CASES, and both timed
    as in phase 3, in turns (other, this, this, other). Prints one JSON
    line; returns whether every output was equal."""
    from pathlib import Path

    from thermal3d_torch.kernels import _build
    from thermal3d_torch.kernels import flash_attention as fa
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    lib_path = _build.BUILD_DIR / "libother_rope_attention_tc.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(Path(other_csrc) / "rope_attention_tc.cu")],
                   check=True, capture_output=True, text=True)
    libs = {"this": None, "other": fa.bind_tc_lib(_build.load(lib_path))}
    results = []
    for kind, batch, side, c, heads in COMPARE_CASES:
        s = side * side
        cos, sin = rope_tables(make_grid_positions(side, side, device="cuda"), c // heads)
        gen = torch.Generator(device="cuda").manual_seed(c + s)
        if kind == "K2":
            qkv = torch.randn((batch, s, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
            base, es = qkv.data_ptr(), qkv.element_size()
            ptrs, row_stride = (base, base + c * es, base + 2 * c * es), 3 * c
        else:
            qkv = [torch.randn((batch, s, c), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3)]
            ptrs, row_stride = tuple(t.data_ptr() for t in qkv), c
        outs = {w: torch.empty((batch, s, c), dtype=torch.bfloat16, device="cuda")
                for w in libs}

        def run(which):
            fa.rope_attention_tc(*ptrs, row_stride, cos, sin, outs[which], heads,
                                 1.0 / math.sqrt(c // heads),
                                 torch.cuda.current_stream().cuda_stream, lib=libs[which])

        run("this")
        run("other")
        torch.cuda.synchronize()
        equal = torch.equal(outs["this"], outs["other"])
        ms = {w: [] for w in libs}
        for which in ("other", "this", "this", "other"):
            ms[which].append(cuda_ms(lambda w=which: run(w)))
        results.append(dict(kernel=kind, shape=[batch, s, c], heads=heads, equal=equal,
                            this_ms=ms["this"], other_ms=ms["other"]))
        log(f"{kind} [{batch},{s},{c}] H={heads}: torch.equal {equal}; ms this {ms['this']} "
            f"other {ms['other']}")
        del qkv, outs
    all_equal = all(r["equal"] for r in results)
    print(json.dumps({"compare_k2k3": results, "all_equal": all_equal}), flush=True)
    return all_equal


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    if argv and (len(argv) != 2 or argv[0] != "--compare-k2k3"):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    if argv:
        log(card)
        return 0 if compare_k2k3(torch, argv[1]) else 1
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()

    log("kernels vs plain versions at the serving shapes:")
    k1 = k1_cases(torch)
    k2 = attention_cases(torch, cross=False)
    k3 = attention_cases(torch, cross=True)
    log("kernels vs plain versions at the MASt3R-512 shapes (S=1024):")
    mastr = dict(grid=(32, 32), reps=10)
    k2 += attention_cases(torch, cross=False, batch=2 * PAIR_BATCH, widths=[(1024, 16)], **mastr)
    k2 += attention_cases(torch, cross=False, batch=PAIR_BATCH, widths=[(768, 12)], **mastr)
    k3 += attention_cases(torch, cross=True, batch=PAIR_BATCH, **mastr)
    log("K2/K3 bf16 at head_dim 32 (the CUDA-core one-shot and key-tile kernels):")
    d32 = dict(widths=[(512, 16)], dtypes=("bfloat16",))
    for kw in (dict(), dict(batch=PAIR_BATCH, **mastr)):
        k2 += attention_cases(torch, cross=False, **d32, **kw)
        k3 += attention_cases(torch, cross=True, **d32, **kw)
    log("K4-K6 (bf16 also at head_dim 32, on the CUDA-core kernel):")
    k456 = {name: plain_attention_cases(torch, name)
            + plain_attention_cases(torch, name, PLAIN_ATTENTION_D32, ("bfloat16",))
            for name in ("flash_attention_pallas", "flash_attention_grouped",
                         "flash_attention_multihead")}
    engine = phase_engine(torch, np)
    pseudo_gt = phase_pseudo_gt(torch, np)

    # launches on each path's own run; `launches` is this slice's main path
    # (pseudo-GT) for K2-K6, the serving path for K1
    by_path = {}
    for path, counts in (("serving", engine["launches"]), ("serving_f32", engine["f32_launches"]),
                         ("pseudo_gt_auto", pseudo_gt["launches"]),
                         ("pseudo_gt_pallas", pseudo_gt["pallas"]["launches"]),
                         *((f"pseudo_gt_{impl}_depth2", r["launches"])
                           for impl, r in pseudo_gt["reduced_depth"].items())):
        for name, count in counts.items():
            by_path.setdefault(name, {})[path] = count

    def entry(name, source, replaces, cases, main_case, main_path):
        m = cases[main_case]
        extra = {}
        if name.startswith("fused_rope"):  # K2/K3: bf16 on tensor cores, f32 on CUDA cores
            extra = dict(source_cuda_core="thermal3d_torch/kernels/csrc/rope_attention.cu",
                         tensor_core_launches_by_path=by_path["rope_attention_tc"])
        elif name.startswith("flash_attention"):  # K4-K6: the same split
            extra = dict(source_cuda_core="thermal3d_torch/kernels/csrc/attention.cu",
                         tensor_core_launches_by_path=by_path["softmax_attention_tc"])
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    **extra, launches=by_path[name][main_path], launches_by_path=by_path[name],
                    max_abs_err=max(c["max_abs_err"] for c in cases), ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    library_ms=m["library_ms"], main_case=m, cases=cases)

    fa_src = "thermal3d/kernels/flash_attention.py"
    attn_src = "thermal3d_torch/kernels/csrc/attention_tc.cu"
    kernels = [
        entry("percentile_enhance", "thermal3d_torch/kernels/csrc/percentile_enhance.cu",
              "thermal3d/kernels/image_ops.py:44", k1, 0, "serving"),
        # main case: the S=1024 encoder call in bf16 (index 4: after the
        # four S=196 cases)
        entry("fused_rope_attention", "thermal3d_torch/kernels/csrc/rope_attention_tc.cu",
              f"{fa_src}:310", k2, 4, "pseudo_gt_auto"),
        entry("fused_rope_cross_attention", "thermal3d_torch/kernels/csrc/rope_attention_tc.cu",
              f"{fa_src}:415", k3, 2, "pseudo_gt_auto"),
        entry("flash_attention_pallas", attn_src, f"{fa_src}:91",
              k456["flash_attention_pallas"], 0, "pseudo_gt_pallas"),
        entry("flash_attention_grouped", attn_src, f"{fa_src}:227",
              k456["flash_attention_grouped"], 0, "pseudo_gt_pallas_grouped4_depth2"),
        entry("flash_attention_multihead", attn_src, f"{fa_src}:164",
              k456["flash_attention_multihead"], 0, "pseudo_gt_pallas_multihead_depth2"),
    ]
    print(card, flush=True)
    print(json.dumps({"engine": engine}), flush=True)
    print(json.dumps({"pseudo_gt": pseudo_gt}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
