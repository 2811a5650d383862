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
     Freiburg frames [4,512,640], at [1,16,16] and at one view of a training
     batch [4,224,224]; K2/K3 at the serving
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
  6. drive the file-driven entry points on a synthetic Freiburg tree written
     with the script's own PNG encoder (every row filter type): the port's
     decoder alone (frames/s on 1 and 8 threads); InferenceEngine.infer_paths
     over 100 uint16 640x512 frames and a corrupt file, in batches of 32
     (the 4th padded), depth only and all outputs, bit-equal to engine.infer
     on the same decoded batches (K1 = 4, K2 = 160, K3 = 64), one call of
     each under torch.profiler; cli.infer --no_vis (100 depth files);
     cli.evaluate against pseudo-GT depths at 640x512, its per-image metrics
     held against a float64 numpy restatement; generate_pseudo_gt on 9 RGB
     pairs with the full-depth bf16 MASt3R-512 (steps of 4, 4 and a padded
     1: K2 = 144, K3 = 72), every file equal to run_pairs on the same
     decoded pairs; cli.pseudo_gt --test_set on 10 frames;
  7. drive the training path: a float32 cli.infer in a fresh process (TF32
     at torch's defaults there) against the in-process float32 engine; the
     autograd Functions of K2 (encoder and decoder widths), K3 and K4 at the
     training shapes, bf16 and f32, against float64 autograd of the plain
     forward; one bf16 step's whole-model gradient against a float32 twin
     (attention_impl='torch', TF32 off); then a full-width, full-depth
     DUSt3R-224 with float32 master weights and bf16 compute takes a
     warm-up step and 10 steps on one batch of 4 synthetic raw-count thermal
     pairs with 512² pseudo-GT (v2 multi-scale loss): the loss falls,
     launches K1 = 2, K2 = 40, K3 = 16 a step (tensor-core count K2 + K3),
     steps/s and samples/s by CUDA events, peak memory, device ms by phase,
     one step and one forward under torch.profiler; last, cli.train on the
     phase-6 Freiburg tree and its pseudo-GT (2 epochs), resumed to a third
     epoch, and cli.infer from its checkpoint directory (bit-equal to an
     engine on the checkpoint's weights);
  8. print JSON lines of the paths (engine, pseudo_gt, files, training) and
     of the kernels and, last, the device line.
Without CUDA it exits non-zero before printing any result.

    python3 chip_smoke.py --compare-k2k3 OTHER_CSRC_DIR

holds this checkout's tensor-core K2/K3 kernel against a build of another
checkout's csrc/rope_attention_tc.cu instead (torch.equal on the bf16 K2/K3
shapes of both paths, times in turns) and exits non-zero if any differs.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; f32 CUDA cores
N_BATCHES = 4
BATCH = 32
RAW_HW = (320, 416)
PAIR_BATCH = 4  # pairs a pseudo-GT step (bench.py's MASt3R-512 batch)
N_PAIR_BATCHES = 3  # timed pseudo-GT steps after one warm-up step
TRAIN_BATCH = 4  # pairs a training step (TrainConfig's batch)
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
# one-block kernel's old limit of 116,096 pixels an image), one small image
# and one view of a training batch
K1_SHAPES = ((BATCH, 224, 224), (4, 512, 640), (1, 16, 16), (TRAIN_BATCH, 224, 224))


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
        ref_cpu = percentile_enhance_plain(x.cpu())
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_cpu = (out.cpu() - ref_cpu).abs().max().item()
        # the same order statistics and rescale, each step in IEEE float32
        # (the plain version divides by a tensor: see grid_value): bit-equal
        # to the plain version on the card and on the CPU
        check(f"K1 percentile_enhance [{b},{h},{w}] f32", err, 0.0)
        check(f"K1 percentile_enhance [{b},{h},{w}] f32 vs plain on the CPU", err_cpu, 0.0)
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
        cases.append(dict(shape=[b, h, w], dtype="float32", max_abs_err=err, limit=0.0,
                          max_abs_err_vs_cpu_plain=err_cpu,
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
          ("optimizer (foreach)", ("multi_tensor_apply",)),
          ("softmax", ("softmax",)),
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


# the file-driven phase: N_FRAMES decodable Freiburg-size thermal frames (3
# full serving batches and a padded 4th) plus one corrupt file; N_RGB RGB
# frames give N_RGB - 1 pairs at frame_skip 1 (pseudo-GT steps of 4, 4 and a
# padded 1)
N_FRAMES = 100
CORRUPT_AT = 37
FRAME_HW = (512, 640)
N_RGB = 10
# per-image metrics on the card against a float64 numpy restatement: the
# error metrics to 1e-5 relative; an accuracy is a count over n valid pixels,
# where a ratio within f32 rounding of a threshold may fall the other way, so
# it may also differ by one pixel (1/n)
METRIC_RTOL = 1e-5


def png_bytes(np, arr) -> bytes:
    """A PNG of uint8 gray/RGB or uint16 gray samples, written with the stdlib
    zlib; row y uses filter type y % 5 (None, Sub, Up, Average, Paeth), so
    every unfilter branch of the decoder runs."""
    import struct
    import zlib

    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    raw = (arr.astype(">u2").view(np.uint8) if depth == 16 else arr).reshape(h, -1)
    raw = raw.astype(np.int32)
    bpp = c * depth // 8
    up = np.vstack([np.zeros((1, raw.shape[1]), np.int32), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), raw[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kind = (np.arange(h) % 5)[:, None]
    pred = np.select([kind == k for k in range(5)],
                     [np.zeros_like(raw), left, up, (left + up) >> 1, paeth])
    rows = np.hstack([kind.astype(np.uint8), ((raw - pred) & 0xFF).astype(np.uint8)])

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0 if c == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_tree(np, root: str):
    """The phase's files: `thermal/` (N_FRAMES uint16 frames, raw counts
    21000-26000 with structure, and one corrupt file) and a Freiburg tree
    `ds/train/seq_00_day/00/{fl_rgb,fl_ir_aligned}` of N_RGB RGB8 frames and
    their thermal twins. Returns the sorted thermal paths."""
    import os

    h, w = FRAME_HW
    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    thermal_dir = os.path.join(root, "thermal")
    seq = os.path.join(root, "ds", "train", "seq_00_day", "00")
    for d in (thermal_dir, os.path.join(seq, "fl_rgb"), os.path.join(seq, "fl_ir_aligned")):
        os.makedirs(d)
    thermal = []
    for i in range(N_FRAMES + 1):
        path = os.path.join(thermal_dir, f"fl_ir_aligned_{1580000 + i}_{i:03d}.png")
        thermal.append(path)
        if i == CORRUPT_AT:
            with open(path, "wb") as f:
                f.write(b"\x89PNG\r\n\x1a\n not a png")
            continue
        blob = 0.5 + 0.5 * np.sin(6 * xx + 0.2 * i) * np.cos(4 * yy)
        frame = 0.5 * xx + 0.3 * blob + 0.2 * rng.uniform(size=(h, w))
        with open(path, "wb") as f:
            f.write(png_bytes(np, (21000 + 5000 * frame).astype(np.uint16)))
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1)
    for i in range(N_RGB):
        stamp = f"{1590000 + i}_{i:03d}"
        rgb = np.roll(0.7 * base, 8 * i, axis=1) + 0.3 * rng.uniform(size=base.shape)
        with open(os.path.join(seq, "fl_rgb", f"fl_rgb_{stamp}.png"), "wb") as f:
            f.write(png_bytes(np, (255 * rgb).astype(np.uint8)))
        with open(os.path.join(seq, "fl_ir_aligned", f"fl_ir_aligned_{stamp}.png"), "wb") as f:
            f.write(open(thermal[i], "rb").read())
    return sorted(thermal)


def metrics_f64(np, pred, gt):
    """The evaluation metrics of one frame restated in float64 numpy: mask
    gt > 0 and finite, median scaling (numpy's median averages the two
    middle values), AbsRel, RMSE and the accuracies."""
    mask = (gt > 0) & np.isfinite(gt)
    p, g = pred.astype(np.float64)[mask], gt.astype(np.float64)[mask]
    p = p * (np.median(g) / np.median(p))
    thresh = np.maximum(g / p, p / g)
    return dict(abs_rel=float(np.mean(np.abs(g - p) / g)),
                rmse=float(np.sqrt(np.mean((g - p) ** 2))),
                acc_1=float(np.mean(thresh < 1.25)), acc_2=float(np.mean(thresh < 1.25 ** 2)),
                n_valid=int(mask.sum()))


def hold_metrics(np, got, want, what):
    """got (float32, from the card) against want (metrics_f64)."""
    for k in ("abs_rel", "rmse", "acc_1", "acc_2"):
        limit = METRIC_RTOL * abs(want[k])
        if k.startswith("acc"):
            limit = max(METRIC_RTOL, 1.0 / want["n_valid"])
        if not abs(got[k] - want[k]) <= limit:
            raise AssertionError(f"{what}: {k} {got[k]} vs float64 {want[k]} (limit {limit:.2e})")


def phase_files(torch, np, card: str, engine_result: dict, pseudo_gt_result: dict, root: str):
    """The file-driven entry points at full width on synthetic Freiburg files:
    the decoder's rate, InferenceEngine.infer_paths (depth only and all
    outputs, bit-equal to engine.infer on the same decoded batches),
    cli.infer, generate_pseudo_gt (every file equal to run_pairs on the same
    decoded pairs), cli.pseudo_gt --test_set and cli.evaluate (per-image
    metrics against float64 numpy), each with its launch counts."""
    import glob
    import os

    from thermal3d_torch import native
    from thermal3d_torch.cli import evaluate as cli_evaluate
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import pseudo_gt as cli_pseudo_gt
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, MASTR_512_CATMLPDPT
    from thermal3d_torch.data.freiburg import build_rgb_pair_index
    from thermal3d_torch.evaluation.evaluator import _resize_nearest
    from thermal3d_torch.evaluation.metrics import batched_depth_metrics
    from thermal3d_torch.infer.engine import OUTPUT_KEYS, InferenceEngine
    from thermal3d_torch.preprocess.io import load_thermal_images_batch
    from thermal3d_torch.pseudo_gt.generator import (OUTPUT_DIRS, PseudoGTGenerator,
                                                     decode_rgb_pairs, generate_pseudo_gt,
                                                     pad_batch)

    serving = {"percentile_enhance": 4, "fused_rope_attention": 160,
               "fused_rope_cross_attention": 64, "rope_attention_tc": 224}
    n_steps = -(-(N_RGB - 1) // PAIR_BATCH)
    stepping = {"fused_rope_attention": 48 * n_steps, "fused_rope_cross_attention": 24 * n_steps,
                "rope_attention_tc": 72 * n_steps}
    t0 = time.perf_counter()
    paths = write_tree(np, root)
    survivors = [p for i, p in enumerate(paths) if i != CORRUPT_AT]
    log(f"files: wrote {len(paths)} thermal and {N_RGB} RGB PNGs {FRAME_HW} in "
        f"{time.perf_counter() - t0:.1f} s")

    # the decoder alone: one batch of every decodable frame, resized to 224²
    decode = {"default_threads": native.DEFAULT_THREADS, "frame_hw": list(FRAME_HW),
              "frames_per_s_by_threads": {}}
    native.load_thermal_batch(survivors[:8], (224, 224))  # build and warm up
    for threads in sorted({1, native.DEFAULT_THREADS, 8}):
        t0 = time.perf_counter()
        _, ok = native.load_thermal_batch(survivors, (224, 224), n_threads=threads)
        decode["frames_per_s_by_threads"][threads] = len(survivors) / (time.perf_counter() - t0)
        if not ok.all():
            raise AssertionError("decoder: a valid frame failed to decode")
    log(f"decode: {json.dumps(decode)}")

    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    eng = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    eng.infer_paths(survivors[:BATCH], batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    (depth_only, el_d), launches_d = run_counted(
        lambda: timed(lambda: eng.infer_paths(paths, batch_size=BATCH, outputs=("depth",))),
        serving)
    (full, el_f), launches_f = run_counted(
        lambda: timed(lambda: eng.infer_paths(paths, batch_size=BATCH)), serving)
    # once more each, for the spread between calls
    el_d2 = timed(lambda: eng.infer_paths(paths, batch_size=BATCH, outputs=("depth",)))[1]
    el_f2 = timed(lambda: eng.infer_paths(paths, batch_size=BATCH))[1]
    # the decoder's default thread count (one core left to the launching
    # thread) against all 8 threads, the JAX loader's count, in turns
    fps_by_threads = {native.DEFAULT_THREADS: [], 8: []}
    default_batch = native.load_thermal_batch
    try:
        for threads in (8, native.DEFAULT_THREADS, native.DEFAULT_THREADS, 8):
            native.load_thermal_batch = functools.partial(default_batch, n_threads=threads)
            el = timed(lambda: eng.infer_paths(paths, batch_size=BATCH, outputs=("depth",)))[1]
            fps_by_threads[threads].append(N_FRAMES / el)
    finally:
        native.load_thermal_batch = default_batch
    log(f"infer_paths depth only, frames/s by decode threads: {fps_by_threads}")
    if depth_only["paths"] != survivors or full["paths"] != survivors:
        raise AssertionError("infer_paths: the surviving paths are wrong")
    # the serial loop on the same decoded batches: bit-equal
    serial = {k: [] for k in OUTPUT_KEYS}
    for i in range(0, len(paths), BATCH):
        grays, _ = load_thermal_images_batch(paths[i:i + BATCH], out_hw=(224, 224))
        real = len(grays)
        out = eng.infer(np.stack(grays + [grays[-1]] * (BATCH - real)))
        for k in OUTPUT_KEYS:
            serial[k].append(out[k][:real])
    for k in OUTPUT_KEYS:
        if not np.array_equal(full[k], np.concatenate(serial[k])):
            raise AssertionError(f"infer_paths {k} differs from the serial decode -> infer loop")
    if not np.array_equal(depth_only["depth"], full["depth"]):
        raise AssertionError("infer_paths: the depth-only fetch differs from the full one")
    check_outputs({k: v[:BATCH] for k, v in full.items() if k != "paths"}, np)
    fps_d, fps_f = N_FRAMES / el_d, N_FRAMES / el_f
    log(f"infer_paths: {N_FRAMES} of {len(paths)} frames in batches of {BATCH}: depth only "
        f"{fps_d:.2f} frames/s, all outputs {fps_f:.2f} (infer(): fps "
        f"{engine_result['fps']:.2f}, fps_device {engine_result['fps_device']:.2f}); "
        f"launches {launches_d}; bit-equal to the serial loop")
    # where an infer_paths batch goes: the host's launch time of one batch,
    # then its device time, and one whole call under the profiler
    batch = np.stack(load_thermal_images_batch(survivors[:BATCH], out_hw=(224, 224))[0])
    launch_ms, device_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = eng.infer_async(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch_ms.append((t1 - t0) * 1e3)
        device_ms.append((time.perf_counter() - t1) * 1e3)
        del dev
    breakdown_d = profile_batch(torch, lambda: eng.infer_paths(paths, batch_size=BATCH,
                                                               outputs=("depth",)),
                                f"one infer_paths() of {len(paths)} frames, depth only")
    breakdown_f = profile_batch(torch, lambda: eng.infer_paths(paths, batch_size=BATCH),
                                f"one infer_paths() of {len(paths)} frames, all outputs")
    infer_paths = dict(frames=N_FRAMES, files=len(paths), batch=BATCH,
                       fps_depth_only=fps_d, fps_all_outputs=fps_f,
                       fps_depth_only_again=N_FRAMES / el_d2,
                       fps_all_outputs_again=N_FRAMES / el_f2,
                       fps_depth_only_by_decode_threads=fps_by_threads, launches=launches_d,
                       launches_all_outputs=launches_f, bit_equal_to_serial=True,
                       depth_only_equal_to_full=True, host_launch_ms_per_batch=launch_ms,
                       wait_after_launch_ms_per_batch=device_ms,
                       breakdown_depth_only=breakdown_d, breakdown_all_outputs=breakdown_f)
    del eng, depth_only, full, serial
    torch.cuda.empty_cache()

    # cli.infer --no_vis on the directory: N_FRAMES depth files
    inf_dir = os.path.join(root, "infer")
    _, launches_ci = run_counted(lambda: cli_infer.main([
        "--img_path", os.path.join(root, "thermal"), "--output_dir", inf_dir, "--no_vis",
        "--batch_size", str(BATCH)]), serving)
    want_files = sorted(os.path.basename(p)[:-4] + "_depth.npy" for p in survivors)
    if sorted(os.listdir(inf_dir)) != want_files:
        raise AssertionError("cli.infer: the depth files are not the surviving frames'")
    preds = [np.load(os.path.join(inf_dir, f)) for f in want_files]
    if any(p.shape != (224, 224) or not np.isfinite(p).all() for p in preds):
        raise AssertionError("cli.infer: a depth map has the wrong shape or non-finite values")
    log(f"cli.infer: {len(want_files)} depth files; launches {launches_ci}")

    # cli.evaluate against pseudo-GT depths at the frames' own size (nearest
    # resize to 224²), made from the cli.infer depths; the same engine
    # (seed, config) predicts the same depths
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir)
    rng = np.random.default_rng(9)
    gts = []
    for name, pred in zip(want_files, preds):
        up = _resize_nearest(np.abs(pred), FRAME_HW)
        gt = (up * rng.uniform(0.8, 1.25, FRAME_HW) + 0.05).astype(np.float32)
        gt[:40] = 0.0  # outside the mask
        np.save(os.path.join(gt_dir, name), gt)
        gts.append(_resize_nearest(gt, (224, 224)))
    ev_dir = os.path.join(root, "evaluation")
    summary, launches_ce = run_counted(lambda: cli_evaluate.main([
        "--thermal_dir", os.path.join(root, "thermal"), "--pseudo_gt_dir", gt_dir,
        "--output_dir", ev_dir, "--no_vis", "--batch_size", str(BATCH)]), serving)
    on_card = batched_depth_metrics(np.stack(preds), np.stack(gts), device="cuda")
    f64 = [metrics_f64(np, p, g) for p, g in zip(preds, gts)]
    worst = {k: 0.0 for k in ("abs_rel", "rmse", "acc_1", "acc_2")}
    for i, want in enumerate(f64):
        got = {k: float(v[i]) for k, v in on_card.items()}
        hold_metrics(np, got, want, f"evaluation, frame {i}")
        for k in worst:
            worst[k] = max(worst[k], abs(got[k] - want[k]) / max(abs(want[k]), 1e-30))
    mean64 = {k: float(np.mean([m[k] for m in f64])) for k in worst}
    hold_metrics(np, summary, dict(mean64, n_valid=min(m["n_valid"] for m in f64)),
                 "cli.evaluate summary")
    n_txt = len(glob.glob(os.path.join(ev_dir, "*_metrics.txt")))
    if summary["n_images"] != N_FRAMES or n_txt != N_FRAMES or not os.path.exists(
            os.path.join(ev_dir, "metrics_summary.txt")):
        raise AssertionError(f"cli.evaluate: {summary['n_images']} images, {n_txt} files")
    log(f"cli.evaluate: {summary}; per-image vs float64, worst relative {worst}; "
        f"launches {launches_ce}")

    # generate_pseudo_gt: MASt3R-512 at full depth, every file against run_pairs
    pcfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    gen = PseudoGTGenerator(pcfg, params_dtype="bfloat16", seed=0)
    ds = os.path.join(root, "ds")
    pairs = build_rgb_pair_index(ds, frame_skip=1)
    if len(pairs) != N_RGB - 1:
        raise AssertionError(f"pair index: {len(pairs)} pairs")
    gen.run_pairs(*rgb_pairs(np, 0))  # warm-up
    torch.cuda.synchronize()
    pgt_dir = os.path.join(root, "pseudo_gt")
    (n_written, el_p), launches_p = run_counted(
        lambda: timed(lambda: generate_pseudo_gt(pairs, pgt_dir, gen)), stepping)
    pps = n_written / el_p
    for i in range(0, len(pairs), PAIR_BATCH):
        rgb1, rgb2, kept = decode_rgb_pairs(pairs[i:i + PAIR_BATCH], pcfg.img_size)
        ref = gen.run_pairs(pad_batch(rgb1, PAIR_BATCH), pad_batch(rgb2, PAIR_BATCH))
        for j, pr in enumerate(kept):
            b1, b2 = (os.path.basename(pr[k])[:-4] for k in ("rgb_path1", "rgb_path2"))
            for d in OUTPUT_DIRS:
                name = {"depth1": b1, "depth2": b2}.get(d, f"{b1}_{b2}")
                got = np.load(os.path.join(pgt_dir, d, f"{name}.npy"))
                if not np.array_equal(got, ref[d][j], equal_nan=True):
                    raise AssertionError(f"generate_pseudo_gt {d}/{name} differs from run_pairs")
    log(f"generate_pseudo_gt: {n_written} pairs in {n_steps} steps, {pps:.3f} pairs/s "
        f"(decode, compute and npy writes; run_pairs: {pseudo_gt_result['pairs_per_s']:.3f}, "
        f"run_pairs_async {pseudo_gt_result['pairs_per_s_device']:.3f}); every file equal to "
        f"run_pairs; launches {launches_p}")
    del gen
    torch.cuda.empty_cache()

    # cli.pseudo_gt --test_set: N_RGB frames, monocular
    ts_dir = os.path.join(root, "test_set")
    n_ts, launches_ts = run_counted(lambda: cli_pseudo_gt.main([
        "--dataset_dir", ds, "--output_dir", ts_dir, "--test_set",
        "--batch_size", str(PAIR_BATCH)]), stepping)
    depth_files = sorted(glob.glob(os.path.join(ts_dir, "depth", "*_depth.npy")))
    txt = sorted(glob.glob(os.path.join(ts_dir, "depth", "*_thermal_path.txt")))
    if n_ts != N_RGB or len(depth_files) != N_RGB or len(txt) != N_RGB or any(
            np.load(f).shape != (512, 512) or not np.isfinite(np.load(f)).all()
            for f in depth_files) or not all(os.path.exists(open(t).read()) for t in txt):
        raise AssertionError(f"cli.pseudo_gt --test_set: {n_ts} frames, {len(depth_files)} "
                             f"depth and {len(txt)} path files")
    log(f"cli.pseudo_gt --test_set: {n_ts} frames; launches {launches_ts}")
    return dict(card=card, decode=decode, infer_paths=infer_paths,
                engine_fps=engine_result["fps"], engine_fps_device=engine_result["fps_device"],
                cli_infer=dict(files=len(want_files), launches=launches_ci),
                cli_evaluate=dict(summary=summary, launches=launches_ce,
                                  worst_rel_vs_f64=worst),
                generate_pseudo_gt=dict(pairs=n_written, steps=n_steps, pairs_per_s=pps,
                                        launches=launches_p, files_equal_to_run_pairs=True),
                pseudo_gt_pairs_per_s=pseudo_gt_result["pairs_per_s"],
                pseudo_gt_pairs_per_s_device=pseudo_gt_result["pairs_per_s_device"],
                test_set=dict(frames=n_ts, launches=launches_ts))


# the training phase: DUSt3R-224 at full width and depth, float32 master
# weights and bf16 compute (the JAX CLI's defaults), batch TRAIN_BATCH
N_TRAIN_STEPS = 10
TRAIN_GT_HW = (512, 512)  # the pseudo-GT's size, resized inside the step
# the backward of K2-K4 at the training shapes against float64 autograd of
# the plain forward on the same inputs, max|Δ|/max|ref| of each gradient:
# float32 is the closed form in float32 (sums of 196 products: ~1e-6); bf16
# stores P, dP and dS in bf16 as the JAX backward does, and dS = P(dP -
# rowsum) keeps dP's rounding where dS itself is small (the same arithmetic
# on the CPU reads 4.8e-3 to 9.4e-3 at these shapes)
TRAIN_BWD_LIMIT = {"bfloat16": 2.0 ** -5, "float32": 1e-5}
# one bf16 step's gradient against a float32 twin (same weights, plain
# attention, TF32 off), on the same enhanced views: the cosine of the flat
# gradient, and each tensor's |g_bf16 - g_f32| / |g_f32| (the CPU reads
# 0.99982 and at most 0.076 at full depth)
GRAD_COS_MIN = 0.999
GRAD_TENSOR_REL_MAX = 0.25
# a float32 cli.infer in a fresh process against the in-process float32
# engine on the same frames, max|Δ|/max|ref| (TF32 in either would read ~1e-3)
TF32_CLI_REL_LIMIT = 1e-5


def train_batch(torch, np, seed: int = 0, device: str = "cuda"):
    """A training batch on `device`: raw-count thermal pairs [B,224,224,3]
    (a ramp, a wave and noise; view 2 shifted 6 pixels) and 512² pointmaps
    of a tilted wavy surface with confidences."""
    rng = np.random.default_rng(seed)
    b = TRAIN_BATCH
    yy, xx = np.meshgrid(np.linspace(0, 1, 224), np.linspace(0, 1, 224), indexing="ij")
    t1 = 21000 + 5000 * (0.5 * xx + 0.3 * np.sin(8 * yy) + 0.2 * rng.uniform(size=(b, 224, 224)))
    t2 = np.roll(t1, 6, axis=2)
    gy, gx = np.meshgrid(*(np.linspace(-1, 1, n) for n in TRAIN_GT_HW), indexing="ij")
    z = 2 + 0.5 * np.sin(3 * gx) + gy
    pm = np.stack([gx * z, gy * z, z], -1)[None].repeat(b, 0)
    arrays = {"thermal1": np.repeat(t1[..., None], 3, -1), "thermal2": np.repeat(t2[..., None], 3, -1),
              "pointmap1": pm, "pointmap2": 1.05 * pm,
              "confidence1": 1 + rng.uniform(size=(b, *TRAIN_GT_HW)),
              "confidence2": 1 + rng.uniform(size=(b, *TRAIN_GT_HW))}
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def _rope_attention_f64(torch, q, k, v, cos, sin, nh, scale):
    """RoPE + softmax attention in float64 on [B, S, C] projections."""
    from thermal3d_torch.kernels.flash_attention import rot_lanes

    b, s, c = q.shape

    def heads(t):
        return t.reshape(b, s, nh, c // nh).transpose(1, 2)

    c64, s64 = cos.double(), sin.double()

    def rope(t):
        return t * c64 + rot_lanes(t) * s64

    p = torch.softmax(rope(heads(q)) @ rope(heads(k)).transpose(-1, -2) * scale, dim=-1)
    return (p @ heads(v)).transpose(1, 2).reshape(b, s, c)


# (what, kernel, batch, width C, heads) at the training shapes: the encoder
# runs on both views ([2B]), the decoder on each branch ([B])
TRAIN_BWD_CASES = (("K2 encoder", "K2", 2 * TRAIN_BATCH, 1024, 16),
                   ("K2 decoder", "K2", TRAIN_BATCH, 768, 12),
                   ("K3 decoder", "K3", TRAIN_BATCH, 768, 12),
                   ("K4 'pallas' encoder", "K4", 2 * TRAIN_BATCH, 1024, 16))


def train_backward_cases(torch, device: str = "cuda"):
    """Each autograd Function at the training shapes, on `device`: its
    forward (the kernel on the card) is held against the plain forward at
    phase 3's limits, its backward (plain PyTorch) against float64 autograd
    of the plain forward. On the card the Function must launch its kernel,
    and the backward alone is timed by graph replay; returns the cases and
    the bf16 backward ms of one training step (None on the CPU)."""
    from thermal3d_torch.kernels import flash_attention as fa
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    on_card = device != "cpu"
    pos = make_grid_positions(14, 14, device=device)
    s = 196
    cases = []
    for what, kind, b, c, nh in TRAIN_BWD_CASES:
        d = c // nh
        cos, sin = rope_tables(pos, d)
        scale = 1.0 / math.sqrt(d)

        def bhsd(t):
            return t.reshape(b, s, nh, d).transpose(1, 2)

        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            gen = torch.Generator(device=device).manual_seed(c + b)
            n_in = 1 if kind == "K2" else 3
            width = 3 * c if kind == "K2" else c
            xs = [torch.randn((b, s, width), generator=gen, device=device).to(dt)
                  for _ in range(n_in)]
            g = torch.randn((b, s, c), generator=gen, device=device).to(dt)
            ins = [x.clone().requires_grad_(True) for x in xs]
            ins64 = [x.double().requires_grad_(True) for x in xs]
            if kind == "K2":
                entry = fa.fused_rope_attention
                plain = lambda: fa.fused_rope_attention_plain(xs[0], cos, sin, nh, scale)  # noqa: E731
                before = entry.launches
                out = entry(ins[0], cos, sin, nh, scale)
                x64 = ins64[0]
                ref = _rope_attention_f64(torch, x64[..., :c], x64[..., c:2 * c], x64[..., 2 * c:],
                                          cos, sin, nh, scale)
            elif kind == "K3":
                entry = fa.fused_rope_cross_attention
                plain = lambda: fa.rope_attention_plain(*xs, cos, sin, nh, scale)  # noqa: E731
                before = entry.launches
                out = entry(*ins, cos, sin, nh, scale)
                ref = _rope_attention_f64(torch, *ins64, cos, sin, nh, scale)
            else:  # K4 on heads [B, H, S, D] viewed from [B, S, H, D], as attention_bshd
                entry = fa.flash_attention_pallas
                plain = lambda: fa.attention_plain(*(bhsd(t) for t in xs), scale)  # noqa: E731
                before = entry.launches
                out = entry(*(bhsd(t) for t in ins), scale)
                q64, k64, v64 = (bhsd(t) for t in ins64)
                p = torch.softmax(q64 @ k64.transpose(-1, -2) * scale, dim=-1)
                ref = (p @ v64).transpose(1, 2).reshape(b, s, c)
            if "Backward" not in type(out.grad_fn).__name__ or \
                    (on_card and entry.launches != before + 1):
                raise AssertionError(f"{what} {dname}: the kernel's Function did not run")
            with torch.no_grad():
                fwd_err = (out.float() - plain().float()).abs().max().item()
            # as in phase 3: f32 differs in summation order only; bf16 by the
            # output's rounding (2^-7 at |x| < 2) and one flipped rounding of p
            fwd_limit = 2e-5 if dt == torch.float32 else 2.0 ** -6
            check(f"{what} forward [{b},{s},{width}] H={nh} {dname} vs plain", fwd_err, fwd_limit)
            if kind == "K4":
                out = out.transpose(1, 2).reshape(b, s, c)
            out.backward(g)
            ref.backward(g.double())
            errs = [((t.grad.double() - r.grad).abs().max() / r.grad.abs().max()).item()
                    for t, r in zip(ins, ins64)]
            check(f"{what} backward [{b},{s},{width}] H={nh} {dname} vs float64",
                  max(errs), TRAIN_BWD_LIMIT[dname])
            ms = None
            if on_card:
                if kind == "K4":
                    q4, k4, v4 = (bhsd(t.detach()) for t in xs)
                    bwd = lambda: fa.attention_bwd(q4, k4, v4, bhsd(g), scale)  # noqa: E731
                else:
                    parts = [xs[0][..., i * c:(i + 1) * c] for i in range(3)] if kind == "K2" else xs
                    q4, k4, v4 = (t.reshape(b, s, nh, d) for t in parts)
                    bwd = lambda: fa.rope_attention_bwd(  # noqa: E731
                        q4, k4, v4, g.reshape(b, s, nh, d), cos, sin, scale)
                ms = cuda_ms(bwd, reps=5)
                log(f"    backward alone {ms:.4f} ms")
            cases.append(dict(what=what, kernel=kind, shape=[b, s, width], heads=nh, dtype=dname,
                              fwd_max_abs_err=fwd_err, fwd_limit=fwd_limit,
                              max_rel_err=max(errs), limit=TRAIN_BWD_LIMIT[dname], bwd_ms=ms))
            del ins, ins64, out, ref
    if not on_card:
        return cases, None
    torch.cuda.empty_cache()
    by = {(c["what"], c["dtype"]): c["bwd_ms"] for c in cases}
    per_step = (24 * by[("K2 encoder", "bfloat16")] + 16 * by[("K2 decoder", "bfloat16")]
                + 16 * by[("K3 decoder", "bfloat16")])
    log(f"plain attention backward, bf16, per training step (24 + 16 K2, 16 K3 calls, "
        f"each timed alone): {per_step:.3f} ms")
    return cases, per_step


def gradient_vs_float32_twin(torch, np, model, batch):
    """One bf16 step's gradient (kernels) against a float32 twin's (the same
    weights, attention_impl='torch', TF32 off) on the same enhanced views
    (K1 for the bf16 model, its plain version for the twin, held bit-equal
    here)."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, TrainConfig
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train import step as tstep

    twin = trainable_model(dataclasses.replace(DUSTR_224_LINEAR, attention_impl="torch"),
                           next(model.parameters()).device, model.state_dict())
    cfg = TrainConfig()
    grads = {}
    views_by = {impl: tstep._prepare_views(batch, impl) for impl in ("auto", "plain")}
    k1_err = max((views_by["auto"][k] - views_by["plain"][k]).abs().max().item()
                 for k in ("thermal1_enh", "thermal2_enh"))
    check(f"K1 on the training batch [{TRAIN_BATCH},224,224] x 2 views vs plain", k1_err, 0.0)
    for net, impl in ((model, "auto"), (twin, "plain")):
        views = views_by[impl]
        pred1, pred2 = net(views["thermal1_enh"], views["thermal2_enh"])
        loss, _ = tstep._batch_loss(pred1, pred2, views, tuple(pred1["pts3d"].shape[1:3]), cfg)
        grads[impl] = torch.autograd.grad(loss, list(net.parameters()))
    del twin, views, views_by
    names = [n for n, _ in model.named_parameters()]
    dots = sum(float((a.double() * r.double()).sum()) for a, r in zip(grads["auto"], grads["plain"]))
    na = math.sqrt(sum(float(a.double().pow(2).sum()) for a in grads["auto"]))
    nr = math.sqrt(sum(float(r.double().pow(2).sum()) for r in grads["plain"]))
    cosine = dots / (na * nr)
    rel = {n: float((a.double() - r.double()).norm() / r.double().norm())
           for n, a, r in zip(names, grads["auto"], grads["plain"]) if float(r.norm()) > 0}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    log(f"training gradient bf16 vs float32 twin: cosine {cosine:.6f} (limit >= {GRAD_COS_MIN}), "
        f"per-tensor relative norm median {float(np.median(list(rel.values()))):.4f}, "
        f"worst {worst} (limit {GRAD_TENSOR_REL_MAX})")
    if cosine < GRAD_COS_MIN or max(rel.values()) > GRAD_TENSOR_REL_MAX:
        raise AssertionError("the bf16 training gradient departs from its float32 twin")
    del grads
    torch.cuda.empty_cache()
    return dict(k1_views_max_abs_err=k1_err, cosine=cosine,
                tensor_rel_median=float(np.median(list(rel.values()))),
                tensor_rel_max=max(rel.values()), worst=worst, limits=dict(
                    cosine_min=GRAD_COS_MIN, tensor_rel_max=GRAD_TENSOR_REL_MAX))


def tf32_repair_check(torch, np, root: str):
    """The float32 cli.infer in a fresh process (torch's defaults: cuDNN TF32
    on) against the in-process float32 engine (TF32 off in this process) on
    the same 8 frames; and, for scale, one float32 patch-embed conv with TF32
    on against IEEE."""
    import os
    import shutil
    import torch.nn.functional as F

    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine

    frames_dir, out_dir = os.path.join(root, "tf32_frames"), os.path.join(root, "tf32_out")
    os.makedirs(frames_dir)
    picked = sorted(os.listdir(os.path.join(root, "thermal")))[:8]  # before the corrupt one
    for f in picked:
        shutil.copy(os.path.join(root, "thermal", f), frames_dir)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "thermal3d_torch.cli.infer", "--img_path", frames_dir,
                    "--output_dir", out_dir, "--no_vis", "--compute_dtype", "float32",
                    "--batch_size", "8"], cwd=here, check=True, timeout=600,
                   capture_output=True, text=True)
    sub_s = time.perf_counter() - t0
    eng = InferenceEngine(DUSTR_224_LINEAR, seed=0)
    paths = [os.path.join(frames_dir, f) for f in picked]
    ref = eng.infer_paths(paths, batch_size=8, outputs=("depth",))
    errs = [rel_err(np.load(os.path.join(out_dir, f[:-4] + "_depth.npy")), ref["depth"][i], np)
            for i, f in enumerate(picked)]
    log(f"TF32 repair: float32 cli.infer in a fresh process ({sub_s:.1f} s) vs the in-process "
        f"float32 engine, max|Δ|/max|ref| over {len(picked)} depth maps: {max(errs):.3e} "
        f"(limit {TF32_CLI_REL_LIMIT})")
    if max(errs) > TF32_CLI_REL_LIMIT:
        raise AssertionError("the float32 CLI in a fresh process departs from the engine")
    proj = eng.model.patch_embed.proj
    x = torch.rand((8, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    ieee = F.conv2d(x, proj.weight, proj.bias, stride=16)
    torch.backends.cudnn.allow_tf32 = True
    tf32 = F.conv2d(x, proj.weight, proj.bias, stride=16)
    torch.backends.cudnn.allow_tf32 = False
    conv_tf32 = ((tf32 - ieee).abs().max() / ieee.abs().max()).item()
    log(f"  the patch-embed conv in float32 with TF32 on vs IEEE: {conv_tf32:.3e} relative")
    del eng
    torch.cuda.empty_cache()
    return dict(frames=len(picked), cli_vs_engine_rel=max(errs), limit=TF32_CLI_REL_LIMIT,
                conv_tf32_vs_ieee_rel=conv_tf32, subprocess_s=sub_s)


def phase_training(torch, np, root: str):
    """Phase 7 (see the module docstring)."""
    import contextlib
    import io
    import os

    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import train as cli_train
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, TrainConfig
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train import step as tstep
    from thermal3d_torch.train.checkpoint import load_params_from_checkpoint_dir
    from thermal3d_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    tf32 = tf32_repair_check(torch, np, root)
    log("training: the autograd Functions at the training shapes:")
    bwd_cases, attn_bwd_ms = train_backward_cases(torch)

    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    model = trainable_model(cfg, torch.device("cuda"), seed=0)
    batch = train_batch(torch, np)
    twin = gradient_vs_float32_twin(torch, np, model, batch)

    # TrainConfig's defaults: batch 4, v2 multi-scale loss, AdamW, clip 1.0;
    # lr 5e-4 after a warmup at 0.1 x (these steps are in its first epoch)
    tcfg = TrainConfig()
    state = create_train_state(model, tcfg, steps_per_epoch=100)
    train_step = tstep.make_train_step(model, tcfg)
    train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def ten_steps():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = [train_step(state, batch)[1]["loss"] for _ in range(N_TRAIN_STEPS)]
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        return torch.stack(losses).cpu().tolist(), start.elapsed_time(end), host_s

    n = N_TRAIN_STEPS
    (losses, elapsed_ms, host_s), launches = run_counted(ten_steps, {
        "percentile_enhance": 2 * n, "fused_rope_attention": 40 * n,
        "fused_rope_cross_attention": 16 * n, "rope_attention_tc": 56 * n})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_per_s = n / (elapsed_ms / 1e3)
    log(f"training: {n} steps of {TRAIN_BATCH} pairs in {elapsed_ms:.2f} ms (CUDA events; "
        f"the host issued them in {host_s * 1e3:.2f} ms): {steps_per_s:.3f} steps/s, "
        f"{TRAIN_BATCH * steps_per_s:.3f} samples/s; peak memory {peak_gb:.3f} GB; "
        f"launches {launches}")
    log(f"  losses {losses}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: the loss did not fall on a fixed batch: {losses}")

    # device ms by phase of one step, between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    views = tstep._prepare_views(batch)
    pred1, pred2 = model(views["thermal1_enh"], views["thermal2_enh"])
    loss, _ = tstep._batch_loss(pred1, pred2, views, tuple(pred1["pts3d"].shape[1:3]), tcfg)
    ev[1].record()
    grads = torch.autograd.grad(loss, state.params)
    ev[2].record()
    state.apply_gradients(list(grads))
    ev[3].record()
    ev[3].synchronize()
    phases = dict(forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                  optimizer_ms=ev[2].elapsed_time(ev[3]))
    log(f"training: one step by phase (CUDA events): {json.dumps(phases)}")
    del views, pred1, pred2, loss, grads

    def forward_only():
        v = tstep._prepare_views(batch)
        p1, p2 = model(v["thermal1_enh"], v["thermal2_enh"])
        return tstep._batch_loss(p1, p2, v, tuple(p1["pts3d"].shape[1:3]), tcfg)[0]

    breakdown = profile_batch(torch, lambda: train_step(state, batch),
                              f"one training step of {TRAIN_BATCH} pairs")
    breakdown_fwd = profile_batch(torch, forward_only, "one training forward and loss")
    gemm_fwd = breakdown_fwd.get("by_layer", {}).get("GEMM", 0.0)
    gemm_all = breakdown.get("by_layer", {}).get("GEMM", 0.0)
    log(f"  GEMMs: forward {gemm_fwd:.3f} ms, backward and the rest {gemm_all - gemm_fwd:.3f} ms; "
        f"plain attention backward (timed alone) {attn_bwd_ms:.3f} ms of "
        f"{breakdown.get('busy_ms', float('nan')):.3f} ms busy")
    init = {k: v.detach().to("cpu", torch.bfloat16) for k, v in model.state_dict().items()}
    del state, train_step, model
    torch.cuda.empty_cache()

    # the loop from files: cli.train on phase 6's Freiburg tree and its pseudo-GT
    weights = os.path.join(root, "train_init.pth")
    torch.save({"state_dict": init}, weights)
    del init
    ckpt = os.path.join(root, "train_ckpt")
    ds, pgt = os.path.join(root, "ds"), os.path.join(root, "pseudo_gt")
    args = ["--dataset_dir", ds, "--pseudo_gt_dir", pgt, "--weights", weights,
            "--output_model", ckpt, "--max_batches", "2", "--use_thermal_aware_loss",
            "--multi_scale", "--frame_skip", "1", "--log_interval", "1", "--lr", "5e-5"]
    # 9 pairs: 7 to train (one batch of 4 an epoch), 2 to validate (one
    # padded batch): each epoch runs two forwards of 4 pairs
    per_epoch = {"percentile_enhance": 4, "fused_rope_attention": 80,
                 "fused_rope_cross_attention": 32, "rope_attention_tc": 112}

    def cli(extra, epochs_now):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary, counts = run_counted(lambda: cli_train.main(args + extra),
                                          {k: epochs_now * v for k, v in per_epoch.items()})
        logged = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
        return summary, counts, logged, time.perf_counter() - t0

    first, counts1, _, s1 = cli(["--epochs", "2"], 2)
    resumed, counts2, logged, s2 = cli(["--epochs", "3", "--resume"], 1)
    epochs_logged = sorted({int(x["epoch"]) for x in logged if "epoch" in x})
    if (first["epochs_run"], first["final_step"]) != (2, 2) or \
            (resumed["epochs_run"], resumed["final_step"]) != (3, 3) or epochs_logged != [3]:
        raise AssertionError(f"cli.train: {first}, resumed {resumed}, epochs logged "
                             f"{epochs_logged}")
    log(f"cli.train: 2 epochs {first} in {s1:.1f} s; launches {counts1}; resumed at epoch "
        f"{epochs_logged[0]}: {resumed} in {s2:.1f} s; launches {counts2}")
    inf_dir = os.path.join(root, "train_infer")
    frames_dir = os.path.join(ds, "train", "seq_00_day", "00", "fl_ir_aligned")
    cli_infer.main(["--img_path", frames_dir, "--output_dir", inf_dir, "--no_vis",
                    "--weights", ckpt])
    state_dict, meta = load_params_from_checkpoint_dir(ckpt)
    eng = InferenceEngine(cfg, state_dict=state_dict)
    frames = sorted(os.path.join(frames_dir, f) for f in os.listdir(frames_dir))
    ref = eng.infer_paths(frames, batch_size=36, outputs=("depth",))
    for i, path in enumerate(ref["paths"]):
        got = np.load(os.path.join(inf_dir, os.path.basename(path)[:-4] + "_depth.npy"))
        if not np.array_equal(got, ref["depth"][i]):
            raise AssertionError(f"cli.infer --weights {ckpt}: {path} differs from the engine")
    log(f"cli.infer --weights <checkpoint dir>: {len(ref['paths'])} depth maps bit-equal to an "
        f"engine on the checkpoint's weights (epoch {meta['epoch']})")
    del eng
    torch.cuda.empty_cache()
    return dict(model="DUSTR_224_LINEAR", compute_dtype="bfloat16", params_dtype="float32",
                batch=TRAIN_BATCH, gt_hw=list(TRAIN_GT_HW), steps=n, losses=losses,
                steps_per_s=steps_per_s, samples_per_s=TRAIN_BATCH * steps_per_s,
                device_ms_per_step=elapsed_ms / n, host_ms_per_step=host_s * 1e3 / n,
                peak_memory_gb=peak_gb, launches=launches, phases_ms=phases,
                attention_backward_ms_per_step=attn_bwd_ms, gemm_forward_ms=gemm_fwd,
                gemm_backward_ms=gemm_all - gemm_fwd, breakdown=breakdown,
                breakdown_forward=breakdown_fwd, backward_cases=bwd_cases,
                gradient_vs_f32_twin=twin, tf32_repair=tf32,
                cli_train=dict(first=first, resumed=resumed, epochs_logged_on_resume=epochs_logged,
                               launches_first=counts1, launches_resumed=counts2,
                               seconds=[s1, s2]),
                cli_infer_from_checkpoint=dict(files=len(ref["paths"]), bit_equal=True),
                seconds=time.perf_counter() - t_phase)


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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as root:
        files = phase_files(torch, np, card, engine, pseudo_gt, root)
        training = phase_training(torch, np, root)

    # launches on each path's own run; `launches` is this slice's main path
    # (pseudo-GT) for K2-K6, the serving path for K1
    by_path = {}
    for path, counts in (("serving", engine["launches"]), ("serving_f32", engine["f32_launches"]),
                         ("pseudo_gt_auto", pseudo_gt["launches"]),
                         ("pseudo_gt_pallas", pseudo_gt["pallas"]["launches"]),
                         *((f"pseudo_gt_{impl}_depth2", r["launches"])
                           for impl, r in pseudo_gt["reduced_depth"].items()),
                         ("files_infer_paths", files["infer_paths"]["launches"]),
                         ("files_cli_infer", files["cli_infer"]["launches"]),
                         ("files_cli_evaluate", files["cli_evaluate"]["launches"]),
                         ("files_generate_pseudo_gt", files["generate_pseudo_gt"]["launches"]),
                         ("files_test_set", files["test_set"]["launches"]),
                         ("training", training["launches"])):
        for name, count in counts.items():
            by_path.setdefault(name, {})[path] = count
    for counts in by_path.values():  # every kernel names the training path
        counts.setdefault("training", 0)

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
    print(json.dumps({"files": files}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
