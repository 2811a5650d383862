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
     with Sq=196 against Sk=1024 and Sq=1024 against Sk=196, and K4 in bf16
     on a q whose size-1 axes have odd strides (the tensor-core kernel's
     map strides held against flash_attention.tc_map_strides in every
     case); K2-K6 also in bf16 and float32 at head_dim 24, both S, and K2/K3
     at the shapes a tensor-parallel rank gives them in phase 10 (tp=2: 8
     and 6 heads) and in the multi-device phase (tp=4: 4 and 3 heads); then
     K2-K6 at head_dims 16, 32 and 128 (HEAD_DIM_K2K3, HEAD_DIM_K4,
     HEAD_DIM_K5K6) and the size-1-axes K4 case at head_dims 16 and 32
     (SIZE_ONE_HEAD_DIMS), and the packed route at head dims 20, 48, 80,
     96, 160 and 256 (PADDED_K2, PADDED_K4, PADDED_K5K6), each in bf16 and
     float32, with a poison case at head dims 24 and 20 (every lane of the
     other heads NaN or Inf: head 0's output bit-equal to the clean one's);
     and flash_attention.padded_width against both libraries' own query at
     every head dim. Each K2-K6 case records the kernel that served it: bf16
     the tensor-core kernels (their own count moves; K2/K3 at head_dim 16,
     32, 64 or 128 with its schedule, one_pass/N at head_dim 64 and S=196,
     else key_tile, as the library chooses it; every other head dim
     packed/Dp, the width it is padded to), float32 the 3xTF32 ones (its own
     count moves; 3xtf32/key_tile or 3xtf32/packed/Dp; bound at 495/3
     TFLOP/s, the CUDA cores' 67 beside it). Then the pseudo-GT pose's 3×3
     kernel (kabsch_cases) against its plain sweeps on the card and on the
     CPU and numpy's float64 SVD, on 12000 covariances of every kind
     (random, reflections, planar, repeated singular values, rank 1, zero)
     and at 4 and 8 of them: its µs a launch, and no host wait under
     set_sync_debug_mode('error') (torch.linalg.svd raises there). Then, on
     a host with two cards or more, with cuda:0 current, K1-K6 (both kernel
     families, the packed route too), the 3×3 kernel and one full-width
     InferenceEngine batch on the last
     card, each bit-equal to the same call on cuda:0 (multi_card_check); on
     one card a line says that this check did not run and why;
  4. drive the serving path: a full-width bf16 DUSt3R-224 InferenceEngine
     (seeded random weights) answers batches of synthetic raw thermal frames
     [32, 320, 416]; its depth is held against the same engine run with the
     plain versions (attention_impl='torch', enhance_impl='plain'), and the
     kernels' launch counts over those batches must be K1 = n, K2 = 40·n,
     K3 = 16·n, and the tensor-core kernel's own count K2 + K3; one more
     batch runs under torch.profiler for the device time by layer and the
     device's idle share; then a float32 engine is held against its plain
     twin, with the tensor-core count 0 there and the 3xTF32 count K2 + K3;
     then the small-decoder engine (phase_small_decoder: the decoder 512
     wide with 16 heads, head_dim 32) and the ViT-H engine (phase_vit_h: a
     ViT-Huge-wide encoder, 1280 wide, 32 blocks, 16 heads: head_dim 80 on
     the packed route; K2 = 48·n, K3 = 16·n) the same way in bf16 and
     float32, each one's infer_async() frames/s beside the head_dim-64
     engine's in turns, and its autograd Functions at a training shape
     against float64;
  5. drive the pseudo-GT path: a full-width, full-depth bf16
     MASt3R-512 PseudoGTGenerator (seeded random weights) turns batches of 4
     synthetic RGB pairs [4, 512, 512, 3] into the eight pseudo-GT arrays,
     with launch counts K2 = 48·n, K3 = 24·n (all on the tensor-core
     kernel: its count 72·n) and the pose's 3×3 kernel n (one a step on
     every pseudo-GT path, one a chunk on a mesh, 0 on every other path);
     pairs/s with and without the host copies; run_pairs_async at the
     benchmark cell's 8 pairs under set_sync_debug_mode('error'): no host
     wait, the card busy when the dispatches return (dispatch_without_waits);
     the outputs against a plain twin (attention_impl='torch')
     and a float32 twin; the geometry against float64 numpy; one step under
     torch.profiler; then attention_impl='pallas' (K4 = 72·n) at full depth,
     with one step under torch.profiler,
     and 'pallas_grouped4' (K5) and 'pallas_multihead' (K6) at encoder and
     decoder depth 2 (10·n each), each against its plain twin, all on the
     tensor-core K4-K6 kernel (its count equal to theirs); then float32, the
     default compute_dtype, at full width and depth on the same weights:
     'auto' (the 3xTF32 K2/K3 count 72) and 'pallas' (the 3xTF32 K4-K6
     count 72), each against the float32 plain twin, with run_pairs_async()
     pairs/s; then the VGGT-1B window path (phase_window): K2 in bf16 at a
     frame block's [24, 1374, 3072] and a global block's [1, 32976, 3072]
     (the frame's RoPE tables tiled 24 times, the special tokens at (0, 0))
     and K4 at the DINOv2 trunk's [24, 16, 1374, 64] (bf16) and the camera
     head's [1, 16, 24, 128] (float32, 3xTF32), each against its plain
     version computed a block of query rows at a time; then a full-width,
     full-depth bf16 WindowGenerator on 24-frame windows of 518² under
     set_sync_debug_mode('error'): no host wait, the card busy at return,
     K2 = 48·n and K4 = 40·n (24·n tensor-core, 16·n 3xTF32) and nothing
     else counted, every output finite, device ms a window, memory peak;
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
  8. on phase 6's tree: fire-scene preprocessing, refinement, the entry
     points' figures and the bench script (see phase_fire);
  9. int8 serving and the parity gate: torch._int_mm against the exact
     float64 product at the DUSt3R-224 and MASt3R-512 trunk shapes, flat
     and a K/128 segment at a time (limit 0), int8_dense and quantize_kernel
     on the card against the CPU (limit 0), their times beside the bf16
     F.linear; the full-width, full-depth bf16 DUSt3R-224 engine in five
     int8 configurations (INT8_CONFIGS: launches K1 n, K2 40n, K3 16n and
     the int8 GEMMs int8_gemm_launches derives, each against its plain twin
     within INT8_TWIN_REL_LIMIT, its depth drift against bf16), infer_async
     frames/s against bf16 and a profile of each; the int8 MASt3R-512
     generator (K2 48n, K3 24n, _int_mm 290n, pairs/s against bf16, the
     geometry against float64 numpy); cli.infer --int8 --int8_static_acts;
     cli.pseudo_gt --int8 --test_set; cli.parity in dir mode, in golden mode
     with --int8 on phase 6's test set, and --full-gate on a .pth of the
     port's random-weight DUSt3R-224 (convert and oracle stages pass);
  10. multi-GPU on the one card (every mesh position on cuda:0): the
     full-width, full-depth bf16 DUSt3R-224 engine over the mesh
     [cuda:0, cuda:0] (each batch of 32 in two chunks: K1 2n, K2 80n, K3
     32n) against the one-device engine on the same weights (float32 within
     1e-3, bf16 within the engine's gates), frames/s beside it; the
     MASt3R-512 generator on that mesh (4 pairs, K2 96n, K3 48n) against
     run_pairs, and generate_pseudo_gt on it; cli.infer --ndev 2 (the parser
     error naming the device count) and --ndev 1 (the plain CLI's files);
     cli.train --mesh_shape 1 --zero1 in a subprocess with torchrun's
     variables (an NCCL group of world 1), 2 epochs, resumed to a third,
     then cli.infer from its checkpoint; and a 2-rank gloo job on cuda:0
     (DIST_CASES, full width at DIST_DEPTH): DP, ZeRO-1 (each rank's mu + nu
     bytes half of DP's) and Megatron TP over 2 ranks (8 and 6 heads a
     rank) in float32, each step's loss and gradients against one
     single-process step on the global batch, and TP in bf16 recorded;
  11. the serving artifact (see phase_export): cli.export --platforms native
     of phase 4's seeded bf16 DUSt3R-224 weights at batch sizes 32 and 1, in
     a subprocess; the artifact loaded and served (2 batches of 32 frames and
     one of 5, padded to 32) in a fresh process that cannot import the
     port's models, engine, converters or preprocessing, K1 1, K2 40, K3 16
     a batch through the ops of kernels/ops.py, its outputs against the
     in-process engine; the portable program exported on the CPU and served
     on the card against the plain twin with no kernel launch; a native
     stereo MASt3R-512 artifact at encoder and decoder depth 2 (K2/K3 at
     S=1024); the softmax_attention op of K4-K6 against each entry;
  12. the workflow wrappers (see phase_wrappers), each run with bash on
     phase 6's tree and full-width, full-depth bf16 checkpoints from seed 0:
     scripts/torch_run_generate_pseudo_gt.sh (MASt3R-512, 512², frame_skip
     5), torch_run_train_thermal_dustr.sh (EPOCHS=1 on that pseudo-GT),
     torch_run_evaluate_thermal_dustr.sh (its best checkpoint on the
     tree's thermal frames, --no_vis), torch_run_grid_search_thermal_parameters
     .sh (one cell, one epoch) and torch_run_test_preprocessing.sh (one
     frame); each exits 0, writes its CLI's files and launches K1-K3 (K2/K3
     for pseudo-GT) in its own processes; the pseudo-GT, evaluation and
     preprocessing files equal a direct call of the same CLI with the same
     arguments in this process, byte for byte;
  13. the multi-device phase (see phase_multi_device and the comment above
     MD_N_RGB), on a host with two cards or more; on one card a line says
     that it did not run and why: serving and pseudo-GT over a mesh of 2
     and of all the host's cards, each bit-equal to the same mesh laid on
     cuda:0, with frames/s and pairs/s against the card count; the --ndev
     CLIs and the bench byte-equal to --ndev 1; training over NCCL on 4
     ranks (DP, ZeRO-1, DP×TP, TP) under torchrun and --multihost, each
     layout's float32 step against the single-process step, timed bf16
     steps, a ZeRO-1 checkpoint restored bit-equal and resumed;
  14. print JSON lines of the paths (engine, pseudo_gt, window, files, training,
     the bench, fire, int8, multi_gpu, export, multi_card, multi_device,
     wrappers) and of the kernels and, last, the device line.
Without CUDA it exits non-zero before printing any result.

Phase 2 logs each kernel's registers and spills and every ptxas C7513
and C7519 line of the wgmma sources, and fails on a C7513.

    python3 chip_smoke.py --only-head-dims [OTHER_CSRC_DIR]
    python3 chip_smoke.py --only-small-decoder
    python3 chip_smoke.py --only-vit-h

build the kernels and run, alone, phase 3's head-dim cases (16, 32 and 128,
the size-1-axes cases there, and the packed route's at head dims 20, 24,
48, 80, 96, 160 and 256 with the poison cases and the padded-width check),
or phase 4's small-decoder engine, or its ViT-H engine, and print their
lines. With OTHER_CSRC_DIR (a checkout's kernels/csrc from before the packed
route, which still has the CUDA-core csrc/rope_attention.cu and csrc/attention.cu)
each packed-route case also runs that build's CUDA-core kernel on the same
inputs, held against the plain version and timed in turns with the kernel.

    python3 chip_smoke.py --compare-k2k3 OTHER_CSRC_DIR

holds this checkout's tensor-core K2/K3 kernel against a build of another
checkout's csrc/rope_attention_tc.cu instead (a build whose queries take
the head_dim) (torch.equal and the largest difference on the bf16
K2/K3 shapes of both paths and at head_dims 16, 32 and 128, times in
turns), then its 3xTF32 kernels against the other's csrc/attention_3xtf32.cu
on float32 shapes, and exits non-zero if any fails. Two builds of the same schedule read equal;
the one-pass schedule (S <= 256) against the 64-key online softmax of an
older build differs in p's rounding, by about an output ulp. The bf16
head_dim-64 key-tile cases (S = 1024) are judged by the 2^-6 gate against
the plain version instead of by torch.equal: since the key tiles at head_dim
64 take K4-K6's exp2 step (not the expf step of older builds), they differ
from a build before that by about an output ulp by design.

    python3 chip_smoke.py --compare-k4k6 OTHER_CSRC_DIR

does the same for the tensor-core K4-K6 kernel against a build of another
checkout's csrc/attention_tc.cu, through the same wrapper on phase 3's
seeded operands: every bf16 K4 shape of PLAIN_ATTENTION_SHAPES and
HEAD_DIM_K4 and the size-1-axes case (and those float32 K4 shapes on the
3xTF32 kernels). Two
builds of the same arithmetic read equal; the exp2 softmax against an older
build's expf differs by about an output ulp.

    python3 chip_smoke.py --only-multi-gpu

builds the kernels and runs the tensor-parallel K2/K3 cases and phase 10
alone, on its own synthetic Freiburg tree (its pseudo-GT from the mesh
generator), and prints the multi_gpu line. `--dist-worker RANK WORLD PORT
DIR` is one rank of the job DIR/job.json describes (phase 10's gloo job on
cuda:0, the multi-device phase's NCCL job; run_dist_job launches them).

    python3 chip_smoke.py --only-export

builds the kernels and runs phase 11 alone, and prints the export line.

    python3 chip_smoke.py --only-window

builds the kernels and runs phase 5's VGGT-1B window part alone (its K2 and
K4 cases, K2/K3 at the MASt3R-512 shapes on the same key tiles, then
phase_window), and prints the window line.

    python3 chip_smoke.py --only-multi-card [PART ...]
    python3 chip_smoke.py --only-multi-card check [PART ...]
    python3 chip_smoke.py --only-wrappers

build the kernels and run phase 3's multi-card check and the
multi-device phase alone (they need two cards to do more than say so; on
four cards about 15 minutes), or, with PARTs (of MD_PARTS: engine,
generator, tp_attention, clis, training), those parts of the phase alone,
after the multi-card check where `check` is named too;
or phase 12 alone on its own synthetic Freiburg tree; and print their
lines.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import importlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense peaks of one H100 SXM: bf16 tensor cores; float32 on CUDA cores; and
# float32 as 3xTF32 on tensor cores (495 TFLOP/s TF32, three passes a product)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
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


# the sources whose kernels issue wgmma: ptxas's C7513 ("wgmma.mma_async
# instructions are serialized") in their build log means no wgmma of a
# kernel overlaps another, and fails the build phase; C7519 (warpgroup.arrive
# inserted around a wgmma) is logged
WGMMA_SOURCES = ("rope_attention_tc", "attention_tc", "attention_3xtf32")


def kernel_names(mangled: list) -> list:
    """Short names of mangled kernel entries ("packed_attention_tc_kernel<128>"),
    by c++filt; the mangled names where it is missing."""
    import shutil

    if not mangled or shutil.which("c++filt") is None:
        return list(mangled)
    res = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True, text=True)
    names = res.stdout.splitlines()
    if res.returncode or len(names) != len(mangled):
        return list(mangled)
    return [n.split("::", 1)[-1].split("(", 1)[0] for n in names]


def phase_build() -> dict:
    """Build every kernel library (one nvcc a source, all at once); log each
    kernel's registers and spills by name and every C7513 and C7519 line of
    the wgmma sources' ptxas output, and raise on any C7513."""
    from thermal3d_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    log(f"build: {seconds:.1f} s for {len(paths)} kernel libraries")
    flagged = {}  # source: its C7513 and C7519 lines
    kernels = {}  # source: [(mangled entry, its ptxas lines)]
    for name in paths:
        for line in _build.build_log(name).splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                kernels.setdefault(name, []).append((entry.group(1), []))
            elif ("registers" in line or "spill" in line) and kernels.get(name):
                kernels[name][-1][1].append(line.split(":", 1)[-1].strip())
            if name in WGMMA_SOURCES and ("C7513" in line or "C7519" in line):
                log(f"  {name}: ptxas {line.strip()}")
                flagged.setdefault(name, []).append(line.strip())
    registers = {}
    for name, entries in kernels.items():
        for short, (_, lines) in zip(kernel_names([e for e, _ in entries]), entries):
            log(f"  {name}: {short}: {'; '.join(lines)}")
            registers[f"{name}::{short}"] = "; ".join(lines)
    serialized = {n: [w for w in ws if "C7513" in w] for n, ws in flagged.items()}
    serialized = {n: ws for n, ws in serialized.items() if ws}
    log(f"build: ptxas C7513 lines {sum(map(len, serialized.values()))}, C7519 lines "
        f"{sum('C7519' in w for ws in flagged.values() for w in ws)} in {WGMMA_SOURCES}")
    if serialized:
        raise AssertionError(f"ptxas serialized the wgmma of {sorted(serialized)}: {serialized}")
    return dict(seconds=seconds, libraries=len(paths), ptxas_c7513=0, ptxas_c7519=flagged,
                registers=registers)


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


# the pseudo-GT pose's 3×3 kernel (kernels/umeyama3x3.py::kabsch3x3) against
# its plain sweeps: the rotation within KABSCH_R_LIMIT, the signed singular
# values within KABSCH_SIG_LIMIT of the largest, rank_ok equal (where rank_ok
# is false the pose is the identity, so only a finite rotation is asked)
KABSCH_N = 12000  # covariances of every kind (kabsch_covariances)
KABSCH_BATCHES = (PAIR_BATCH, 8)  # a step of this script's generator, of the benchmark cell
KABSCH_R_LIMIT = 1e-5
KABSCH_SIG_LIMIT = 1e-5
# float64 operations a covariance: 24 plane rotations of ~68 (three column
# dot products, the angle, two 3×2 updates) and ~120 for the sort, U, the
# singular values and R
KABSCH_FLOPS = 24 * 68 + 120
PEAK_FLOPS_F64 = 33.5e12  # H100 SXM, float64 on the CUDA cores


def kabsch_covariances(np, n: int, seed: int = 0):
    """n float32 covariances and each one's kind: random at scales 1e-3 to
    1e3, reflections (det < 0), weighted covariances of planar point sets
    (rank 2), repeated singular values, rank 1 (exact in float32) and zero."""
    rng = np.random.default_rng(seed)

    def rotations(m):
        q = np.linalg.qr(rng.standard_normal((m, 3, 3)))[0]
        return q * np.sign(np.linalg.det(q))[:, None, None]

    def with_values(sv):
        return rotations(len(sv)) @ (sv[:, :, None] * np.eye(3)) @ \
            rotations(len(sv)).transpose(0, 2, 1)

    k = max(1, n // 12)
    parts = {"random": rng.standard_normal((n - 10 * k, 3, 3))
             * 10.0 ** rng.uniform(-3, 3, (n - 10 * k, 1, 1))}
    parts["reflection"] = with_values(
        np.sort(rng.uniform(0.1, 4.0, (2 * k, 3)), axis=1)[:, ::-1] * [1, 1, -1])
    x = rng.standard_normal((2 * k, 3, 64))
    x[:, 2] = rng.standard_normal((2 * k, 1)) * x[:, 0] + rng.standard_normal((2 * k, 1)) * x[:, 1]
    y = 1.3 * rotations(2 * k) @ x + rng.standard_normal((2 * k, 3, 1))
    w = rng.uniform(0.0, 1.0, (2 * k, 1, 64))
    w /= w.sum(-1, keepdims=True)
    xc, yc = x - (x * w).sum(-1, keepdims=True), y - (y * w).sum(-1, keepdims=True)
    parts["planar"] = (yc * w) @ xc.transpose(0, 2, 1)
    sv = np.array([(2, 2, 1), (3, 1, 1), (1, 1, 1), (2, 2, -1), (5, 5, 5)], np.float64)
    parts["repeated"] = with_values(sv[rng.integers(0, 5, 3 * k)]
                                    * 10.0 ** rng.uniform(-2, 2, (3 * k, 1)))
    a, b = rng.integers(-4, 5, (2, 2 * k, 3)).astype(np.float64)
    a[:, 0] = np.where((a == 0).all(1), 1.0, a[:, 0])
    parts["rank1"] = a[:, :, None] * b[:, None, :]
    parts["zero"] = np.zeros((k, 3, 3))
    cov = np.concatenate(list(parts.values())).astype(np.float32)
    kinds = np.concatenate([[name] * len(v) for name, v in parts.items()])
    return cov, kinds


def kabsch_f64(np, cov):
    """numpy's float64 SVD with the Kabsch sign fix: (R, signed singular
    values, rank_ok by float32's eps)."""
    u, d, vt = np.linalg.svd(cov.astype(np.float64))
    s = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    fix = np.stack([np.ones_like(s), np.ones_like(s), s], -1)
    return u @ (fix[:, :, None] * vt), d * fix, (d > np.finfo(np.float32).eps).sum(-1) >= 2


def kabsch_gaps(np, got, want) -> dict:
    """rank_ok disagreements, and the largest |ΔR| and |Δσ| / max|σ| where
    both have rank_ok."""
    (r, sig, ok), (r0, sig0, ok0) = got, want
    both = ok & ok0
    dr = np.abs(r - r0).reshape(len(r), -1).max(-1)
    ds = np.abs(sig - sig0).max(-1) / np.maximum(np.abs(sig0).max(-1), 1e-30)
    return dict(rank_ok_differs=int((ok != ok0).sum()), r_err=float(dr[both].max(initial=0.0)),
                sig_err=float(ds[both].max(initial=0.0)))


def host_us(torch, fn, n: int) -> float:
    """Host µs a call of fn over n eager calls, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def kabsch_cases(torch, np):
    """The pose's 3×3 kernel against kabsch3x3_plain on the card and on the
    CPU and against numpy's float64 SVD: on KABSCH_N covariances of every
    kind in kabsch_covariances, then at KABSCH_BATCHES covariances spread
    over those kinds; each case's device ms (graph replay), the plain sweeps'
    on the card, torch.linalg.svd + two det (eager: it waits for the card)
    and host µs a call. Under torch.cuda.set_sync_debug_mode('error') the
    kernel raises nothing and svd raises; whether the plain sweeps wait for
    the card is recorded."""
    from thermal3d_torch.kernels.umeyama3x3 import kabsch3x3, kabsch3x3_plain

    def host(out):
        return tuple(t.cpu().numpy() for t in out)

    def library(cov):
        u, _, vt = torch.linalg.svd(cov)
        return torch.linalg.det(u) * torch.linalg.det(vt)

    cov_all, kinds_all = kabsch_covariances(np, KABSCH_N)
    cases = []
    for b in (KABSCH_N, *KABSCH_BATCHES):
        pick = np.linspace(0, KABSCH_N - 1, b).astype(int)
        cov, kinds = cov_all[pick], kinds_all[pick]
        x = torch.from_numpy(cov).to("cuda")
        got = host(kabsch3x3(x))
        r, sig, ok = got
        gaps = {name: kabsch_gaps(np, got, want) for name, want in (
            ("plain_card", host(kabsch3x3_plain(x))),
            ("plain_cpu", host(kabsch3x3_plain(torch.from_numpy(cov)))),
            ("numpy_f64", kabsch_f64(np, cov)))}
        rot = np.abs(r.astype(np.float64) @ r.transpose(0, 2, 1) - np.eye(3)).max(initial=0.0)
        rot = max(rot, np.abs(np.linalg.det(r.astype(np.float64)) - 1).max(initial=0.0))
        finite = bool(np.isfinite(r).all() and np.isfinite(sig).all())
        degenerate = (kinds == "rank1") | (kinds == "zero")
        what = f"kabsch3x3 [{b},3,3] ({', '.join(sorted(set(kinds)))})"
        for name, g in gaps.items():
            check(f"{what} R vs {name}", g["r_err"], KABSCH_R_LIMIT)
            check(f"{what} sigma/max|sigma| vs {name}", g["sig_err"], KABSCH_SIG_LIMIT)
            check(f"{what} rank_ok disagreements vs {name}", g["rank_ok_differs"], 0)
        if not finite or rot > KABSCH_R_LIMIT or ok[degenerate].any():
            raise AssertionError(f"{what}: R not a finite rotation everywhere ({rot}) or "
                                 f"rank_ok true on a rank-1 or zero covariance")
        waits = {}
        for name, fn in (("kernel", kabsch3x3), ("plain", kabsch3x3_plain),
                         ("svd", torch.linalg.svd)):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(x)
                waits[name] = False
            except RuntimeError:
                waits[name] = True
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if waits["kernel"] or not waits["svd"]:
            raise AssertionError(f"{what}: under set_sync_debug_mode('error') the kernel "
                                 f"raised, or svd did not: {waits}")
        ms = cuda_ms(lambda: kabsch3x3(x))
        if waits["plain"]:  # a host wait cannot be captured in a graph: eager
            plain_ms = host_us(torch, lambda: kabsch3x3_plain(x), 20) * 1e-3
        else:
            plain_ms = cuda_ms(lambda: kabsch3x3_plain(x), reps=5)
        library(x)
        library_ms = host_us(torch, lambda: library(x), 20) * 1e-3
        bnd, by = bound_ms(b * (9 + 9 + 3) * 4 + b, 0.0, "float32")
        t_ops = b * KABSCH_FLOPS / PEAK_FLOPS_F64 * 1e3
        if t_ops > bnd:
            bnd, by = t_ops, "operations"
        case = dict(shape=[b, 3, 3], dtype="float32", max_abs_err=max(
                        gaps["plain_card"]["r_err"], gaps["plain_card"]["sig_err"]),
                    limit=KABSCH_R_LIMIT, vs=gaps, rotation_err=float(rot),
                    kinds={k: int((kinds == k).sum()) for k in sorted(set(kinds))},
                    rank_ok_false={k: int((~ok[kinds == k]).sum()) for k in sorted(set(kinds))},
                    ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bnd, bound_by=by,
                    host_us=host_us(torch, lambda: kabsch3x3(x), 2000),
                    plain_host_us=host_us(torch, lambda: kabsch3x3_plain(x), 50),
                    library_host_us=library_ms * 1e3, waits_for_the_card=waits)
        cases.append(case)
        log(f"    ms {ms:.4f} plain {plain_ms:.4f} library(svd + 2 det, eager, waits) "
            f"{library_ms:.4f} bound {bnd:.6f} ({by}); host us a call {case['host_us']:.1f}, "
            f"plain {case['plain_host_us']:.1f}; waits for the card under the sync debug "
            f"mode: {waits}")
        del x
    return cases


def tensor_core_schedule(torch, fa, batch: int, heads: int, seq: int, head_dim: int = 64) -> str:
    """The schedule of the tensor-core K2/K3 kernel for a call on cuda:0
    ("one_pass/N": N parts a head, or "key_tile"), as flash_attention.
    tc_schedule names it; raises unless the built library chooses the same."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind, parts = fa.tc_schedule(batch, heads, seq, sms, head_dim)
    built = fa._tc_lib().t3d_rope_attention_tc_schedule(batch, seq, heads, head_dim, sms)
    if built != (parts if kind == fa.ONE_PASS else 0):
        raise AssertionError(f"K2/K3 [{batch},{seq}] H={heads}: the library schedules "
                             f"{built}, tc_schedule {kind}/{parts}")
    return f"{kind}/{parts}" if kind == fa.ONE_PASS else kind


def expected_route(torch, fa, dt, d: int) -> str:
    """The kernel family a K2-K6 call of dtype dt must take, at every head
    dim: bf16 the tensor-core kernels, float32 the 3xTF32 ones."""
    return fa.TENSOR_CORE if dt == torch.bfloat16 else fa.TF32X3


def k2k3_served(torch, fa, route: str, batch: int, heads: int, seq: int, d: int) -> str:
    """The kernel that serves a K2/K3 call: at head_dim 16, 32, 64 or 128
    the tensor-core kernel's schedule (tensor_core_schedule) or
    "3xtf32/key_tile"; at any other head dim the packed route at its padded
    width, "packed/Dp" or "3xtf32/packed/Dp"."""
    tf32 = "3xtf32/" if route == fa.TF32X3 else ""
    if d not in fa.DIRECT_HEAD_DIMS:
        return f"{tf32}packed/{fa.padded_width(d)}"
    return "3xtf32/key_tile" if tf32 else tensor_core_schedule(torch, fa, batch, heads, seq, d)


def in_turns(torch, fns: dict, reps: int) -> dict:
    """Two callables on the same inputs timed by cuda_ms in turns (a, b, b,
    a for the names in order): each name's two times."""
    first, second = list(fns)
    ms = {name: [] for name in fns}
    for name in (first, second, second, first):
        ms[name].append(cuda_ms(fns[name], reps=reps))
    return ms


def launched_families(fn, tc_counter, tf32_counter):
    """Run fn(); return its result and how often it moved the tensor-core
    counter and the 3xTF32 one."""
    before = (tc_counter.launches, tf32_counter.launches)
    out = fn()
    return out, (tc_counter.launches - before[0], tf32_counter.launches - before[1])


def route_bounds(nbytes: float, flops: float, dname: str, route: str, fa) -> dict:
    """The bound of a case beside its route: the 3xTF32 rate for the 3xTF32
    kernels (with the CUDA cores' float32 bound named beside it), the dtype's
    own otherwise."""
    bnd, by = bound_ms(nbytes, flops, "tf32x3" if route == fa.TF32X3 else dname)
    extra = {}
    if route == fa.TF32X3:
        extra["bound_cuda_core_ms"] = bound_ms(nbytes, flops, "float32")[0]
    return dict(bound_ms=bnd, bound_by=by, **extra)


def attention_cases(torch, cross: bool, batch: int = BATCH, grid=(14, 14), widths=None,
                    reps: int = 20, dtypes=("bfloat16", "float32"), cuda_core=None):
    """K2 (K3 with cross=True) on a grid×grid patch grid: the serving
    shapes (S=196) by default, MASt3R-512's (S=1024) with grid (32, 32);
    `widths` are (C, heads), D=64 by default. bf16 runs the tensor-core
    kernels, float32 the 3xTF32 ones (a prologue and the key-tile loop), at
    head_dim 16, 32, 64 or 128 in place and at any other head dim on the
    packed route. Each case records the kernel that served it
    (k2k3_served), and the bound at its route's peak (3xTF32 at 495/3
    TFLOP/s, with the CUDA cores' 67 beside it). With cuda_core (a
    ParentCudaCore), a case also runs that build's CUDA-core kernel on the
    same inputs, held against the plain version too and timed in turns with
    the kernel."""
    import torch.nn.functional as F

    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
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
            route = fa.attention_route(dt, d)
            if route != expected_route(torch, fa, dt, d):
                raise AssertionError(f"K2/K3 {dname} D={d}: routed to {route}")
            out, moved = launched_families(kern, fa.rope_attention_tc, fa.rope_attention_3xtf32)
            if moved != (int(route == fa.TENSOR_CORE), int(route == fa.TF32X3)):
                raise AssertionError(f"K2/K3 {dname} S={s} D={d} ({route}): tensor-core and "
                                     f"3xTF32 launches {moved}")
            served = k2k3_served(torch, fa, route, batch, nh, s, d)
            ref = plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            del out, ref
            limit = ATTENTION_LIMIT[dname]
            name = ("K3 fused_rope_cross_attention" if cross else "K2 fused_rope_attention")
            check(f"{name} [{batch},{s},{c}] H={nh} D={d} {dname}", err, limit)
            ms = cuda_ms(kern, reps=reps)
            plain_ms = cuda_ms(plain, reps=reps)
            library_ms = cuda_ms(library, reps=reps)
            flops = 4 * batch * nh * s * s * d
            bounds = route_bounds(nbytes, flops, dname, route, fa)
            bnd = bounds["bound_ms"]
            tflops = flops / ms / 1e9
            log(f"    {served}: ms {ms:.4f} plain {plain_ms:.4f} library(sdpa) "
                f"{library_ms:.4f} bound {bnd:.4f} ({bounds['bound_by']}); {tflops:.1f} TFLOP/s, "
                f"{ms / bnd:.2f}x bound, {ms / library_ms:.2f}x sdpa, {ms / plain_ms:.2f}x plain")
            extra = {}
            if cuda_core is not None:
                if cross:
                    ptrs, row_stride = (q.data_ptr(), k.data_ptr(), v.data_ptr()), c
                else:
                    base, es = qkv.data_ptr(), qkv.element_size()
                    ptrs, row_stride = (base, base + c * es, base + 2 * c * es), 3 * c
                cc_out = torch.empty((batch, s, c), dtype=dt, device="cuda")
                cc = lambda: cuda_core.rope(*ptrs, row_stride, cos, sin, cc_out, nh,  # noqa: E731
                                            scale)
                extra = cuda_core_in_turns(torch, kern, cc, cc_out, plain, limit, reps,
                                           f"{name} [{batch},{s},{c}] H={nh} D={d} {dname}")
            cases.append(dict(shape=[batch, s, c], heads=nh, head_dim=d, dtype=dname,
                              kernel=served, launches_in_case=dict(zip(("tensor_core", "3xtf32"),
                                                                       moved)),
                              max_abs_err=err, limit=limit, ms=ms,
                              plain_ms=plain_ms, library_ms=library_ms, **bounds,
                              tflops=tflops, ms_over_bound=ms / bnd,
                              ms_over_library=ms / library_ms, **extra))
            del qr, kr, vh, q, k, v
            torch.cuda.empty_cache()
    return cases


# K4/K5/K6 shapes [B, H, Sq, Sk, D]: MASt3R-512's encoder (8 = 4 pairs × 2
# views, 16 heads) and decoder (4 pairs, 12 heads) at S=1024, DUSt3R-224's
# at the serving S=196 (a ragged last tile of 4 keys and 68 query rows),
# and Sq=196 against Sk=1024 and Sq=1024 against Sk=196
PLAIN_ATTENTION_SHAPES = ((8, 16, 1024, 1024, 64), (4, 12, 1024, 1024, 64),
                          (BATCH, 16, 196, 196, 64), (BATCH, 12, 196, 196, 64),
                          (4, 12, 196, 1024, 64), (4, 12, 1024, 196, 64))
# head_dim 24 (no configured model, outside the direct head dims): the
# packed route at width 32, bf16 and float32
PLAIN_ATTENTION_D24 = ((BATCH, 16, 196, 196, 24), (PAIR_BATCH, 16, 1024, 1024, 24))
# a K2-K6 output against its plain version: float32 differs in summation
# order only (and, on the 3xTF32 kernels, by ~2^-21 a product); bf16 by the
# output's rounding to bf16 (1 ulp at |x| < 2 is 2^-7) and a flipped
# rounding of p (the key-tile loop rounds p against a running max; the
# one-pass schedule takes exp on the MUFU unit)
ATTENTION_LIMIT = {"float32": 2e-5, "bfloat16": 2.0 ** -6}


def cuda_core_in_turns(torch, kern, cc, cc_out, plain, limit: float, reps: int,
                       what: str) -> dict:
    """A case, on an older build's CUDA-core kernel too (ParentCudaCore):
    cc() (writing cc_out) held against the plain version at the case's
    limit, then kern and cc timed in turns (kern, cc, cc, kern)."""
    cc()
    ref = plain()
    torch.cuda.synchronize()
    err = (cc_out.float() - ref.float()).abs().max().item()
    del ref
    check(f"{what} on the parent's CUDA cores", err, limit)
    turns = in_turns(torch, {"kernel": kern, "cuda_core": cc}, reps)
    log(f"    in turns: kernel {turns['kernel']} CUDA cores {turns['cuda_core']} ms; "
        f"{min(turns['cuda_core']) / min(turns['kernel']):.1f}x")
    return dict(cuda_core_max_abs_err=err, cuda_core_ms=turns["cuda_core"],
                kernel_ms_in_turns=turns["kernel"])


def tensor_core_map_strides(fa, q, k, v, out) -> list:
    """The byte strides of the tensor-core K4-K6 kernel's tensor maps for a
    call, as flash_attention.tc_map_strides computes them; raises unless the
    built library's own query gives the same."""
    b, h, sq, d = q.shape
    strides = [t.stride(i) if t.shape[i] > 1 else 0 for t in (q, k, v, out) for i in range(3)]
    want = fa.tc_map_strides(strides, b, h, sq, k.shape[2], d)
    got = (ctypes.c_longlong * 12)()
    fa._attention_tc_lib().t3d_softmax_attention_tc_map_strides(
        (ctypes.c_longlong * 12)(*strides), b, h, sq, k.shape[2], d, got)
    if list(got) != want:
        raise AssertionError(f"K4-K6 {tuple(q.shape)} Sk={k.shape[2]}: the library's map "
                             f"strides {list(got)}, tc_map_strides {want}")
    return want


def hold_attention_case(torch, fa, name: str, q, k, v, reps: int, cuda_core=None) -> dict:
    """One K4/K5/K6 case (`name` the entry) on [B,H,S,D] operands: the
    kernel that serves it (bf16 the tensor-core one, float32 the 3xTF32
    one, its count moving once; at a head dim outside 16, 32, 64, 128 their
    packed route), the output against the plain version (ATTENTION_LIMIT),
    the direct tensor-core kernel's map strides against tc_map_strides, and
    the times of kernel, plain version and SDPA beside the bound (SDPA on
    contiguous copies where it refuses the views). With cuda_core (a
    ParentCudaCore), the case also runs that build's CUDA-core kernel on the
    same operands, held and timed in turns (cuda_core_in_turns)."""
    import torch.nn.functional as F

    kern_fn = getattr(fa, name)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dt, dname = q.dtype, str(q.dtype).removeprefix("torch.")
    scale = 1.0 / math.sqrt(d)
    kern = lambda: kern_fn(q, k, v, scale)  # noqa: E731
    plain = lambda: fa.attention_plain(q, k, v, scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    served = fa.attention_route(dt, d)
    if served != expected_route(torch, fa, dt, d):
        raise AssertionError(f"{name} {dname} D={d}: routed to {served}")
    fn_before = kern_fn.launches
    out, moved = launched_families(kern, fa.softmax_attention_tc, fa.softmax_attention_3xtf32)
    if kern_fn.launches != fn_before + 1 or \
            moved != (int(served == fa.TENSOR_CORE), int(served == fa.TF32X3)):
        raise AssertionError(f"{name} {dname} D={d}: launches {kern_fn.launches - fn_before}"
                             f", tensor-core and 3xTF32 {moved}")
    packed = d not in fa.DIRECT_HEAD_DIMS
    map_strides = (tensor_core_map_strides(fa, q, k, v, out)
                   if served == fa.TENSOR_CORE and not packed else None)
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    limit = ATTENTION_LIMIT[dname]
    check(f"{name} [{b},{h},{sq},{d}] Sk={sk} {dname}", err, limit)
    ms = cuda_ms(kern, reps=reps)
    plain_ms = cuda_ms(plain, reps=reps)
    try:
        library_ms, library_on = cuda_ms(library, reps=reps), "views"
    except RuntimeError as e:  # SDPA takes no kernel for these strides: time it on copies
        log(f"    sdpa on the views: {str(e).splitlines()[0][:120]}; on contiguous copies")
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        library_ms, library_on = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, scale=scale), reps=reps), "contiguous copies"
    nbytes = 2 * b * h * (sq + sk) * d * q.element_size()
    flops = 4 * b * h * sq * sk * d
    bounds = route_bounds(nbytes, flops, dname, served, fa)
    bnd = bounds["bound_ms"]
    tflops = flops / ms / 1e9
    log(f"    {served}: ms {ms:.4f} plain {plain_ms:.4f} library(sdpa) "
        f"{library_ms:.4f} bound {bnd:.4f} ({bounds['bound_by']}); {tflops:.1f} TFLOP/s, "
        f"{ms / bnd:.2f}x bound, {ms / library_ms:.2f}x sdpa, {ms / plain_ms:.2f}x plain")
    extra = {}
    if cuda_core is not None:
        cc_out = torch.empty_like(q.transpose(1, 2).contiguous()).transpose(1, 2)
        cc = lambda: cuda_core.softmax(q, k, v, cc_out, scale)  # noqa: E731
        extra = cuda_core_in_turns(torch, kern, cc, cc_out, plain, limit, reps,
                                   f"{name} [{b},{h},{sq},{d}] Sk={sk} {dname}")
    return dict(shape=[b, h, sq, d], sk=sk, dtype=dname, kernel=served,
                width=fa.padded_width(d), packed=packed, map_strides=map_strides,
                max_abs_err=err, limit=limit, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_on=library_on,
                **bounds, tflops=tflops, ms_over_bound=ms / bnd,
                ms_over_library=ms / library_ms, **extra)


def bshd_operands(torch, b: int, h: int, sq: int, sk: int, d: int, dt):
    """Seeded q [B,Sq,H,D] and k, v [B,Sk,H,D] on the card, handed over as
    [B,H,S,D] views, as attention_bshd hands them on the main path."""
    gen = torch.Generator(device="cuda").manual_seed(h + sq)
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
    k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
            for _ in range(2))
    return q, k, v


def plain_attention_cases(torch, name: str, shapes=PLAIN_ATTENTION_SHAPES,
                          dtypes=("bfloat16", "float32"), reps: int = 10, cuda_core=None):
    """One of K4 (flash_attention_pallas), K5 (flash_attention_grouped) or K6
    (flash_attention_multihead) on [B,S,H,D] q/k/v handed over as
    [B,H,S,D] views, as attention_bshd hands them on the main path
    (hold_attention_case)."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")

    cases = []
    for b, h, sq, sk, d in shapes:
        for dname in dtypes:
            q, k, v = bshd_operands(torch, b, h, sq, sk, d, getattr(torch, dname))
            cases.append(hold_attention_case(torch, fa, name, q, k, v, reps, cuda_core))
            del q, k, v
            torch.cuda.empty_cache()
    return cases


def fa_module():
    return importlib.import_module("thermal3d_torch.kernels.flash_attention")


def d24_k2k3_cases(torch, cuda_core=None):
    """K2/K3 in bf16 and float32 at head_dim 24 (C=384, 16 heads), outside
    the direct head dims: the packed route at width 32, at S=196 and
    S=1024 (with cuda_core, the parent's CUDA-core kernel in turns)."""
    log("K2/K3 bf16 and float32 at head_dim 24 (the packed route, width 32):")
    k2, k3 = [], []
    d24 = dict(widths=[(384, 16)], dtypes=("bfloat16", "float32"), cuda_core=cuda_core)
    for kw in (dict(), dict(batch=PAIR_BATCH, grid=(32, 32), reps=10)):
        k2 += attention_cases(torch, cross=False, **d24, **kw)
        k3 += attention_cases(torch, cross=True, **d24, **kw)
    return k2, k3


# phase 3's cases at the direct head dims other than 64, each in bf16 and
# float32. K2/K3 (kernel, batch, grid side, C, heads): head_dim 32, a decoder
# of 512 wide and 16 heads at the serving S (CroCo v2's small decoder);
# head_dim 128 at S=1024; head_dim 16 small. K4 (B, H, Sq, Sk, D): D=32 at
# S=1024, D=128 at S=1024 and at S=196, D=16 small; K5 and K6 at the D=32
# shape.
HEAD_DIM_K2K3 = (("K2", BATCH, 14, 512, 16), ("K3", BATCH, 14, 512, 16),
                 ("K2", 8, 32, 1024, 8), ("K2", 4, 14, 256, 16))
HEAD_DIM_K4 = ((4, 16, 1024, 1024, 32), (8, 8, 1024, 1024, 128), (BATCH, 8, 196, 196, 128),
               (4, 16, 196, 196, 16))
HEAD_DIM_K5K6 = ((4, 16, 1024, 1024, 32),)
# the packed route's cases beside head_dim 24's (d24_k2k3_cases,
# PLAIN_ATTENTION_D24), each in bf16 and float32. K2 (batch, grid side, C,
# heads): head_dim 80, the ViT-H encoder's serving call; 20 with 3 heads
# (C=60: the qkv rows 360 bytes apart in bf16, head h at 40h bytes, so no
# operand is 16-byte aligned); 160 and 256 at S=1024. K4 (B, H, Sq, Sk, D)
# on [B,S,H,D] views: the same head dims, and 48 and 96 small; K5 and K6
# at head_dim 256.
PADDED_K2 = ((BATCH, 14, 1280, 16), (4, 14, 60, 3), (4, 32, 1280, 8), (4, 32, 1024, 4))
PADDED_K4 = ((BATCH, 16, 196, 196, 80), (4, 3, 196, 196, 20), (4, 8, 1024, 1024, 160),
             (4, 4, 1024, 1024, 256), (4, 8, 196, 196, 48), (4, 8, 196, 196, 96))
PADDED_K5K6 = ((4, 4, 1024, 1024, 256),)


def head_dim_cases(torch, cuda_core=None):
    """HEAD_DIM_K2K3, HEAD_DIM_K4 and HEAD_DIM_K5K6 (attention_cases and
    plain_attention_cases), K4's size-1-axes case at SIZE_ONE_HEAD_DIMS
    (size_one_axes_case), then the packed route: PADDED_K2, PADDED_K4 and
    PADDED_K5K6 (with cuda_core, each beside the parent's CUDA-core kernel
    in turns), the poison cases (poison_cases) and the padded-width check
    (padded_width_check): (K2 cases, K3 cases, {K4-K6 entry: cases}, the
    poison cases, the widths)."""
    log("K2-K6 at head_dims 16, 32 and 128, bf16 and float32:")
    k2, k3 = [], []
    for kind, batch, side, c, heads in HEAD_DIM_K2K3:
        (k3 if kind == "K3" else k2).extend(attention_cases(
            torch, cross=kind == "K3", batch=batch, grid=(side, side), widths=[(c, heads)],
            reps=10))
    k456 = {"flash_attention_pallas": plain_attention_cases(
        torch, "flash_attention_pallas", HEAD_DIM_K4)}
    for d, dname in SIZE_ONE_HEAD_DIMS:
        k456["flash_attention_pallas"].append(size_one_axes_case(torch, d, getattr(torch, dname)))
    for name in ("flash_attention_grouped", "flash_attention_multihead"):
        k456[name] = plain_attention_cases(torch, name, HEAD_DIM_K5K6)
    log("K2-K6 on the packed route at head dims 20, 48, 80, 96, 160 and 256, bf16 and "
        "float32" + (", the parent's CUDA-core kernels in turns:" if cuda_core else ":"))
    for batch, side, c, heads in PADDED_K2:
        k2 += attention_cases(torch, cross=False, batch=batch, grid=(side, side),
                              widths=[(c, heads)], reps=10, cuda_core=cuda_core)
    k456["flash_attention_pallas"] += plain_attention_cases(
        torch, "flash_attention_pallas", PADDED_K4, cuda_core=cuda_core)
    for name in ("flash_attention_grouped", "flash_attention_multihead"):
        k456[name] += plain_attention_cases(torch, name, PADDED_K5K6, cuda_core=cuda_core)
    return k2, k3, k456, poison_cases(torch), padded_width_check()


# the poison cases: (kernel, B, S, heads, D), every lane of heads 1.. set to
# NaN or Inf in every operand; head 0's output must not move
POISON_CASES = (("K2", 4, 196, 16, 24), ("K2", 4, 196, 3, 20), ("K4", 4, 196, 16, 24),
                ("K4", 4, 196, 3, 20))


def poison_cases(torch) -> list:
    """Each POISON_CASES call in bf16 and float32, once on seeded operands
    and once with every lane of the other heads poisoned (NaN, +Inf and -Inf
    in turn): head 0's output must be bit-equal to the clean call's (the
    packed route reads no lane of another head). K4 on [B,S,H,D] views."""
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    fa = fa_module()
    results = []
    for kind, b, s, h, d in POISON_CASES:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            gen = torch.Generator(device="cuda").manual_seed(h * d)
            scale = 1.0 / math.sqrt(d)
            if kind == "K2":
                cos, sin = rope_tables(make_grid_positions(14, 14, device="cuda"), d)
                x = torch.randn((b, s, 3 * h * d), generator=gen, device="cuda").to(dt)
                run = lambda t: fa.fused_rope_attention(t, cos, sin, h, scale)  # noqa: E731
                head0 = lambda out: out[..., :d]  # noqa: E731
            else:
                x = torch.randn((3, b, s, h, d), generator=gen, device="cuda").to(dt)
                run = lambda t: fa.flash_attention_pallas(  # noqa: E731
                    *(t[i].transpose(1, 2) for i in range(3)), scale)
                head0 = lambda out: out[:, 0]  # noqa: E731
            clean = head0(run(x)).clone()
            poisoned = x.clone()
            pl = (poisoned.view(b, s, 3, h, d) if kind == "K2" else poisoned)[:, :, :, 1:]
            pl.copy_(torch.tensor([math.nan, math.inf, -math.inf], device="cuda").to(dt)
                     .repeat(pl.numel() // 3 + 1)[:pl.numel()].view(pl.shape))
            got = head0(run(poisoned))
            torch.cuda.synchronize()
            equal = torch.equal(got, clean)
            log(f"poison {kind} [{b},{s}] H={h} D={d} {dname}: head 0 "
                f"{'bit-equal to' if equal else 'DIFFERS from'} the clean call's")
            if not equal:
                raise AssertionError(f"poison {kind} D={d} {dname}: head 0 read another head")
            results.append(dict(kernel=kind, shape=[b, s, h, d], dtype=dname, head0_equal=True))
    return results


def padded_width_check() -> dict:
    """flash_attention.padded_width against both libraries' own query
    (t3d_attention_tc_padded_width, t3d_attention_3xtf32_padded_width) at
    every head dim the wrappers accept and a few they refuse (0 from all)."""
    fa = fa_module()
    dims = list(range(0, 264, 4)) + [2, 6, 258, 260, -4]
    queries = (fa._attention_tc_lib().t3d_attention_tc_padded_width,
               fa._3xtf32_lib().t3d_attention_3xtf32_padded_width)
    for query in queries:
        query.argtypes, query.restype = [ctypes.c_int], ctypes.c_int
    got = {d: tuple(query(d) for query in queries) for d in dims}
    bad = {d: g for d, g in got.items() if g != (fa.padded_width(d),) * 2}
    if bad:
        raise AssertionError(f"padded_width disagrees with the libraries at {bad}")
    log(f"padded_width: the mirror equals both libraries' query at {len(dims)} head dims")
    return {str(d): g[0] for d, g in got.items()}


# q [1,2,1,D] with strides (3, D, 5, 1) in bf16: its batch and row axes
# have size 1 and odd strides the wrapper never checks (it sends 0, the C
# entry a stride a tensor map takes: one row, 2*D bytes bf16, 4*D float32);
# in float32 the [B,S,H,D] view of one query row, strides (2D, D, 2D, 1),
# since SDPA (the yardstick) refuses a float32 q whose row stride is not
# 16-byte aligned, and the C entry gets the same 0 either way. k/v
# [1,2,40,D], one ragged key tile. Phase 3 runs it at D=64 in bf16 and at
# SIZE_ONE_HEAD_DIMS, where the size-1 stride is 32-128 bytes.
SIZE_ONE_Q_STRIDES = (3, 64, 5, 1)
SIZE_ONE_SK = 40
SIZE_ONE_HEAD_DIMS = ((16, "bfloat16"), (16, "float32"), (32, "bfloat16"), (32, "float32"))


def size_one_operands(torch, d: int = 64, dtype=None):
    """Seeded q [1,2,1,d] (bf16: SIZE_ONE_Q_STRIDES, d for 64; float32:
    strides (2d, d, 2d, 1)) and k, v [1,2,SIZE_ONE_SK,d] ([B,S,H,D] views)
    on the card, bf16 unless dtype."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SIZE_ONE_SK)
    buf = torch.randn(2 * d + 7, generator=gen, device="cuda").to(dtype)
    strides = ((SIZE_ONE_Q_STRIDES[0], d, *SIZE_ONE_Q_STRIDES[2:]) if dtype == torch.bfloat16
               else (2 * d, d, 2 * d, 1))
    q = buf.as_strided((1, 2, 1, d), strides)
    k, v = (torch.randn((1, SIZE_ONE_SK, 2, d), generator=gen, device="cuda")
            .to(dtype).transpose(1, 2) for _ in range(2))
    return q, k, v


def size_one_axes_case(torch, d: int = 64, dtype=None, name: str = "flash_attention_pallas"):
    """The K4 case with size-1 axes of odd strides in q
    (hold_attention_case), bf16 unless dtype."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    q, k, v = size_one_operands(torch, d, dtype)
    log(f"  size-1 axes: q {tuple(q.shape)} strides {q.stride()}, k/v {tuple(k.shape)}")
    return hold_attention_case(torch, fa, name, q, k, v, reps=10)


# the multi-card check's inputs (phase 3, two cards or more): made on the
# CPU from this seed, then copied to cuda:0 and to the last card
MULTI_CARD_SEED = 3


def multi_card_check(torch, np):
    """Each kernel launches on its tensors' card: with cuda:0 current, K1-K6
    (tensor-core and 3xTF32 kernels, the packed route at head_dim 24) and the
    pose's 3×3 kernel on the last card and one
    InferenceEngine(device='cuda:<last>') batch of BATCH frames at full
    width, each bit-equal to the same call on cuda:0, and cuda:0 still
    current after them. On a host with one card it does not run, and says
    why."""
    n = torch.cuda.device_count()
    if n < 2:
        reason = (f"{n} card on this host: the check runs the kernels on a card other "
                  "than the current one, so it needs two")
        log(f"multi-card check: not run ({reason})")
        return dict(ran=False, cards=n, reason=reason)
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.kernels.image_ops import percentile_enhance
    from thermal3d_torch.kernels.umeyama3x3 import kabsch3x3
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    torch.cuda.set_device(0)
    last = torch.device("cuda", n - 1)
    gen = torch.Generator().manual_seed(MULTI_CARD_SEED)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    def tables(side):
        return rope_tables(make_grid_positions(side, side), 64)

    def kabsch_joined(cov):  # the kernel's three outputs as one tensor
        return torch.cat([t.to(torch.float32).reshape(len(cov), -1) for t in kabsch3x3(cov)], 1)

    bf16 = torch.bfloat16
    cases = [
        ("K1 [32,224,224]", percentile_enhance, (torch.rand((BATCH, 224, 224), generator=gen),
                                                 2.0, 98.0)),
        ("K2 bf16 [32,196,3072] (tensor cores)", fa.fused_rope_attention,
         (rand(BATCH, 196, 3072, dtype=bf16), *tables(14), 16, 0.125)),
        ("K2 f32 [8,196,3072] (3xTF32)", fa.fused_rope_attention,
         (rand(8, 196, 3072), *tables(14), 16, 0.125)),
        ("K2 f32 [2,1024,2304] (3xTF32)", fa.fused_rope_attention,
         (rand(2, 1024, 2304), *tables(32), 12, 0.125)),
        ("K2 f32 D=24 [8,196,1152] (3xTF32, packed to 32)", fa.fused_rope_attention,
         (rand(8, 196, 1152), *rope_tables(make_grid_positions(14, 14), 24), 16, 0.125)),
        ("K3 bf16 [32,196,768] (tensor cores)", fa.fused_rope_cross_attention,
         (*(rand(BATCH, 196, 768, dtype=bf16) for _ in range(3)), *tables(14), 12, 0.125)),
        ("K3 f32 [8,196,768] (3xTF32)", fa.fused_rope_cross_attention,
         (*(rand(8, 196, 768) for _ in range(3)), *tables(14), 12, 0.125)),
    ]
    for name, fn in (("K4", fa.flash_attention_pallas), ("K5", fa.flash_attention_grouped),
                     ("K6", fa.flash_attention_multihead)):
        cases.append((f"{name} bf16 [8,16,1024,64] (tensor cores)", fn,
                      (*(rand(8, 16, 1024, 64, dtype=bf16) for _ in range(3)), 0.125)))
        cases.append((f"{name} f32 [2,16,196,64] (3xTF32)", fn,
                      (*(rand(2, 16, 196, 64) for _ in range(3)), 0.125)))
        cases.append((f"{name} f32 [2,16,196,24] (3xTF32, packed to 32)", fn,
                      (*(rand(2, 16, 196, 24) for _ in range(3)), 0.125)))
    cases += [  # the tensor cores' other head dims
        ("K2 bf16 D=32 [8,196,1536] (tensor cores, key tiles)", fa.fused_rope_attention,
         (rand(8, 196, 1536, dtype=bf16), *rope_tables(make_grid_positions(14, 14), 32), 16,
          0.125)),
        ("K4 f32 D=128 [2,8,196,128] (3xTF32, one warpgroup a block)",
         fa.flash_attention_pallas, (*(rand(2, 8, 196, 128) for _ in range(3)), 0.125)),
        ("K4 bf16 D=16 [2,16,196,16] (tensor cores)", fa.flash_attention_pallas,
         (*(rand(2, 16, 196, 16, dtype=bf16) for _ in range(3)), 0.125)),
        ("K2 bf16 D=80 [8,196,3840] (tensor cores, packed to 128)", fa.fused_rope_attention,
         (rand(8, 196, 3840, dtype=bf16), *rope_tables(make_grid_positions(14, 14), 80), 16,
          0.125)),
        ("kabsch3x3 [1200,3,3] (the pose's 3x3 solve, every kind of covariance)", kabsch_joined,
         (torch.from_numpy(kabsch_covariances(np, 1200)[0]),)),
    ]
    results = []
    for what, fn, args in cases:
        outs = []
        for dev in (torch.device("cuda", 0), last):
            moved = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
            out = fn(*moved)
            if out.device != dev:
                raise AssertionError(f"multi-card: {what} on {dev} returned on {out.device}")
            outs.append(out)
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(last)
        equal = torch.equal(outs[0].cpu(), outs[1].cpu())
        log(f"multi-card: {what} on {last} with cuda:0 current: "
            f"{'bit-equal to' if equal else 'DIFFERS from'} cuda:0")
        if not equal or torch.cuda.current_device() != 0:
            raise AssertionError(f"multi-card: {what} on {last} differs from cuda:0, or the "
                                 f"current device moved ({torch.cuda.current_device()})")
        results.append(dict(case=what, bit_equal=True))
        del outs
    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    eng0 = InferenceEngine(cfg, params_dtype="bfloat16", seed=0, device="cuda:0")
    eng_last = InferenceEngine(cfg, state_dict=eng0.model.state_dict(),
                               params_dtype="bfloat16", device=str(last))
    frames = raw_frames(np, 0)
    want = eng0.infer(frames)
    got, launches = run_counted(lambda: eng_last.infer(frames), {
        "percentile_enhance": 1, "fused_rope_attention": 40, "fused_rope_cross_attention": 16,
        "rope_attention_tc": 56})
    unequal = [k for k in want if not np.array_equal(got[k], want[k])]
    if unequal or torch.cuda.current_device() != 0:
        raise AssertionError(f"multi-card: the engine on {last} differs from cuda:0 in "
                             f"{unequal}, or the current device moved")
    log(f"multi-card: InferenceEngine(device='{last}') batch of {BATCH} with cuda:0 current: "
        f"every output bit-equal to cuda:0's; launches {launches}")
    del eng0, eng_last
    for i in range(n):
        with torch.cuda.device(i):
            torch.cuda.empty_cache()
    return dict(ran=True, cards=n, card=str(last), kernels=results,
                engine=dict(batch=BATCH, bit_equal=True, launches=launches))


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
# cuDNN's conv kernels carry "fprop"/"dgrad" and are matched before the GEMMs).
# "rope_attention" matches the tensor-core and 3xTF32 K2/K3 kernels at the
# direct head dims; the packed route's pack and key-tile kernels (K2-K6 at
# the other head dims) have a layer of their own.
LAYERS = (("K2-K6 packed route (padded head dims)", ("packed_attention", "attention_pack",
                                                     "attention_3xtf32_pack")),
          ("K2-K6 3xTF32 prologue", ("attention_3xtf32_split",)),
          ("K2/K3 rope_attention", ("rope_attention",)),
          ("K4-K6 softmax_attention", ("softmax_attention",)),
          ("K1 percentile_enhance", ("percentile_enhance",)),
          ("optimizer (foreach)", ("multi_tensor_apply",)),
          ("softmax", ("softmax",)),
          ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "winograd", "implicit")),
          ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
          ("LayerNorm", ("layer_norm",)),
          ("GELU", ("gelu",)),
          ("copies", ("memcpy", "memset")))


def union_ms(spans) -> float:
    """The ms that (start µs, end µs, ...) spans cover together."""
    busy_us, cur_end = 0.0, -math.inf
    for start, end, *_ in sorted(spans):
        busy_us += max(0.0, end - max(start, cur_end))
        cur_end = max(cur_end, end)
    return busy_us / 1e3


def profile_batch(torch, fn, what: str = f"one infer() of {BATCH} frames", layers=LAYERS):
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
    for start, end, name in spans:
        ms = (end - start) / 1e3
        low = name.lower()
        layer = next((lay for lay, keys in layers if any(k in low for k in keys)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
    busy_ms = union_ms(spans)
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
    goes through them), the 3xTF32 K2/K3 and K4-K6 kernels' own (every
    float32 launch), then the int8 product's (torch._int_mm: 0 on every path
    that does not quantize) and the pseudo-GT pose's 3×3 kernel's (one a
    generator step and a mesh chunk, 0 on every other path)."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.kernels.image_ops import percentile_enhance
    from thermal3d_torch.kernels.quant import int_mm
    from thermal3d_torch.kernels.umeyama3x3 import kabsch3x3

    return (percentile_enhance, fa.fused_rope_attention, fa.fused_rope_cross_attention,
            fa.flash_attention_pallas, fa.flash_attention_grouped,
            fa.flash_attention_multihead, fa.rope_attention_tc, fa.softmax_attention_tc,
            fa.rope_attention_3xtf32, fa.softmax_attention_3xtf32, int_mm, kabsch3x3)


def run_counted(fn, want_by_name, key_tiles=None):
    """Set every kernel count to 0, run fn(), read the counts: they must
    equal want_by_name (a kernel not named must not launch at all). With
    key_tiles, the tensor-core K2/K3 calls that took the key-tile schedule
    (rope_attention_tc.key_tile_launches; at head_dim 64 the ping-pong
    kernel) must number key_tiles too."""
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    tc = fa_module().rope_attention_tc
    tc.key_tile_launches = 0
    result = fn()
    launches = {c.__name__: c.launches for c in counters}
    want = {c.__name__: want_by_name.get(c.__name__, 0) for c in counters}
    if launches != want:
        raise AssertionError(f"the path did not run through its kernels: launches "
                             f"{launches}, want {want}")
    if key_tiles is not None and tc.key_tile_launches != key_tiles:
        raise AssertionError(f"the tensor-core K2/K3 took the key-tile schedule "
                             f"{tc.key_tile_launches} times, want {key_tiles}")
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
    (outs, elapsed), launches = run_counted(serve, want, key_tiles=0)  # S=196: one pass
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
    # the float32 engine runs the 3xTF32 K2/K3 kernel, none on the bf16 one
    a, f32_launches = run_counted(lambda: f32.infer(small), {
        "percentile_enhance": 1, "fused_rope_attention": 40, "fused_rope_cross_attention": 16,
        "rope_attention_3xtf32": 56})
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


# phase 4's small-decoder part (alone: --only-small-decoder): DUSt3R-224 at
# full width and depth with the decoder at CroCo v2's small-decoder widths,
# 512 wide with 16 heads, so every decoder attention runs at head_dim 32 (the
# encoder stays at 64)
SMALL_DECODER = dict(dec_embed_dim=512, dec_num_heads=16)
# phase 4's ViT-H part (alone: --only-vit-h): DUSt3R-224 with a ViT-Huge-wide
# encoder (Dosovitskiy et al. 2021, "An Image is Worth 16x16 Words", Table 1:
# 1280 wide, 32 blocks, 16 heads), so every encoder attention runs at
# head_dim 80, on the packed route at width 128 (the decoder stays at 64):
# K2 48 a batch (32 at head_dim 80, 16 at 64), K3 16
VIT_H_ENCODER = dict(enc_embed_dim=1280, enc_depth=32, enc_num_heads=16)


def serve_rates_in_turns(torch, engines: dict, frames) -> dict:
    """infer_async() frames/s of two engines on the same batches, in turns
    (a, b, b, a for the names in order), each after a warm-up batch."""
    first, second = list(engines)
    for eng in engines.values():
        eng.infer_async(frames[0])
    rates = {name: [] for name in engines}
    for name in (first, second, second, first):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            out = engines[name].infer_async(f)
        torch.cuda.synchronize()
        rates[name].append(BATCH * len(frames) / (time.perf_counter() - t0))
        del out
    return rates


def engine_variant(torch, np, label: str, overrides: dict, k2: int, bwd_shapes):
    """DUSTR_224_LINEAR with `overrides` (seeded random weights), built
    here: in bf16, N_BATCHES batches of BATCH raw frames held against its
    bf16 plain twin and a float32 twin at phase 4's gates, launches K1 1,
    K2 k2, K3 16 and the tensor-core K2/K3 count k2 + 16 a batch; in float32
    on 4 frames against its plain twin within F32_ENGINE_REL_LIMIT, the
    3xTF32 count k2 + 16; infer_async() frames/s beside the head_dim-64
    engine's on the same frames, in turns, in both dtypes; then the
    autograd Functions at `bwd_shapes` (train_backward_cases) within phase
    7's limits."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine

    cfg64 = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg64, **overrides)
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    ref_eng = InferenceEngine(dataclasses.replace(cfg, attention_impl="torch"),
                              state_dict=eng.model.state_dict(), params_dtype="bfloat16",
                              enhance_impl="plain")
    log(f"{label} {overrides}: two full-width bf16 engines built in "
        f"{time.perf_counter() - t0:.1f} s")
    frames = [raw_frames(np, seed) for seed in range(N_BATCHES)]
    check_outputs(eng.infer(frames[0]), np)  # warm-up
    want = {"percentile_enhance": N_BATCHES, "fused_rope_attention": k2 * N_BATCHES,
            "fused_rope_cross_attention": 16 * N_BATCHES,
            "rope_attention_tc": (k2 + 16) * N_BATCHES}
    outs, launches = run_counted(lambda: [eng.infer(f) for f in frames], want)
    for out in outs:
        check_outputs(out, np)
    log(f"{label} bf16: launches {launches}")
    gold_eng = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, attention_impl="torch",
                                                   **overrides),
                               state_dict=eng.model.state_dict(), enhance_impl="plain")
    ref = ref_eng.infer(frames[0])
    gold = gold_eng.infer(frames[0])
    errs = {k: rel_err(outs[0][k], ref[k], np) for k in ref}
    noise = {k: rel_err(ref[k], gold[k], np) for k in ref}
    kern_err = {k: rel_err(outs[0][k], gold[k], np) for k in ref}
    log(f"{label} bf16 kernels vs bf16 plain twin, max|Δ|/max|ref|: {errs} "
        f"(limit {BF16_ENGINE_REL_LIMIT}); vs f32: plain {noise}, kernels {kern_err} "
        f"(limit: kernels <= {BF16_NOISE_FACTOR} x plain + 1e-3)")
    if max(errs.values()) > BF16_ENGINE_REL_LIMIT or any(
            kern_err[k] > BF16_NOISE_FACTOR * noise[k] + 1e-3 for k in ref):
        raise AssertionError(f"{label} bf16 engine disagrees with its plain twin: {errs}, "
                             f"vs f32: plain {noise}, kernels {kern_err}")
    del ref_eng, gold_eng, outs
    eng64 = InferenceEngine(cfg64, params_dtype="bfloat16", seed=0)
    fps = serve_rates_in_turns(torch, {"head_dim_64": eng64, label: eng}, frames)
    log(f"{label} bf16: infer_async frames/s in turns {fps}")
    del eng, eng64

    f32 = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, **overrides), seed=1)
    f32_ref = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, attention_impl="torch",
                                                  **overrides),
                              state_dict=f32.model.state_dict(), enhance_impl="plain")
    small = frames[1][:4]
    a, f32_launches = run_counted(lambda: f32.infer(small), {
        "percentile_enhance": 1, "fused_rope_attention": k2, "fused_rope_cross_attention": 16,
        "rope_attention_3xtf32": k2 + 16})
    b = f32_ref.infer(small)
    errs32 = {k: rel_err(a[k], b[k], np) for k in b}
    log(f"{label} f32: launches {f32_launches}; vs plain twin, max|Δ|/max|ref|: "
        f"{errs32} (limit {F32_ENGINE_REL_LIMIT})")
    if max(errs32.values()) > F32_ENGINE_REL_LIMIT:
        raise AssertionError(f"{label} f32 engine disagrees with its plain twin: {errs32}")
    del f32_ref
    f32_64 = InferenceEngine(DUSTR_224_LINEAR, seed=1)
    fps32 = serve_rates_in_turns(torch, {"head_dim_64": f32_64, label: f32}, frames)
    log(f"{label} f32: infer_async frames/s in turns {fps32}")
    del f32, f32_64
    torch.cuda.empty_cache()
    log(f"{label}: the autograd Functions at its training shape:")
    grads, _ = train_backward_cases(torch, shapes=bwd_shapes)
    return dict(config=overrides, batch=BATCH, n_batches=N_BATCHES, launches=launches,
                f32_launches=f32_launches, bf16_rel_err=errs, bf16_plain_vs_f32=noise,
                bf16_kernels_vs_f32=kern_err, f32_rel_err=errs32,
                infer_async_fps=fps, infer_async_fps_f32=fps32, backward=grads)


def phase_small_decoder(torch, np):
    """The small-decoder engine (SMALL_DECODER; engine_variant): K2 40 a
    batch, every decoder call at head_dim 32, and the K2-K4 Functions at that
    decoder's training shape (TRAIN_BWD_D32_CASES)."""
    return engine_variant(torch, np, "small_decoder", SMALL_DECODER, 40, TRAIN_BWD_D32_CASES)


def phase_vit_h(torch, np):
    """The ViT-H engine (VIT_H_ENCODER; engine_variant): K2 48 a batch, 32
    of them at head_dim 80 on the packed route, and the K2 Function at the
    encoder's training shape (TRAIN_BWD_VITH_CASES)."""
    return engine_variant(torch, np, "vit_h", VIT_H_ENCODER, 48, TRAIN_BWD_VITH_CASES)


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


CELL_PAIRS = 8  # pairs a step of the benchmark cell mastr512-pgt-b8
NO_WAIT_STEPS = 3


def dispatch_without_waits(torch, gen) -> dict:
    """gen.run_pairs_async at the benchmark cell's shapes (CELL_PAIRS pairs
    of 512² already on the card) under torch.cuda.set_sync_debug_mode
    ('error'), which raises at any host wait: NO_WAIT_STEPS steps dispatched
    back to back raise nothing, launch the pose's 3×3 kernel once a step and
    return with the card still busy; host ms a dispatch beside device ms a
    step."""
    rgb = torch.rand((2, CELL_PAIRS, 512, 512, 3), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    gen.run_pairs_async(rgb[0], rgb[1])  # first use of this batch size
    torch.cuda.synchronize()
    n = NO_WAIT_STEPS
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        _, launches = run_counted(
            lambda: [gen.run_pairs_async(rgb[0], rgb[1]) for _ in range(n)],
            {"fused_rope_attention": 48 * n, "fused_rope_cross_attention": 24 * n,
             "rope_attention_tc": 72 * n, "kabsch3x3": n})
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        returned = torch.cuda.Event()
        returned.record()
        busy = not returned.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        gen.run_pairs_async(rgb[0], rgb[1])
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / n
    log(f"pseudo-GT: {n} run_pairs_async steps of {CELL_PAIRS} pairs under "
        f"set_sync_debug_mode('error'): no host wait, {host_ms:.2f} ms of host a dispatch "
        f"against {device_ms:.2f} ms of device a step, card busy at return: {busy}; "
        f"launches {launches}")
    if not busy:
        raise AssertionError("pseudo-GT: the card was idle when the dispatches returned")
    return dict(pairs=CELL_PAIRS, steps=n, host_ms_a_dispatch=host_ms,
                device_ms_a_step=device_ms, busy_at_return=busy, launches=launches)


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
         "rope_attention_tc": 72 * n, "kabsch3x3": n},
        key_tiles=72 * n)  # S=1024: every K2/K3 call on the key tiles
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
    no_wait = dispatch_without_waits(torch, gen)
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
            # no attention kernel; the pose's 3×3 kernel once
            outs_.append(run_counted(lambda: g.run_pairs(*pairs[0]), {"kabsch3x3": 1})[0])
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
        lambda: drive(gen_p), {"flash_attention_pallas": 72 * n, "softmax_attention_tc": 72 * n,
                               "kabsch3x3": n})
    pps_pallas = PAIR_BATCH * n / elapsed_p
    log(f"pseudo-GT 'pallas': {pps_pallas:.3f} pairs/s (run_pairs); launches {launches_p}")
    for out in outs_p:
        check_pgt_outputs(out, np)
    breakdown_p = profile_batch(torch, lambda: gen_p.run_pairs(*pairs[0]),
                                f"one 'pallas' run_pairs() of {PAIR_BATCH} pairs")
    held_p = hold(outs_p[0], ref, gold, "bf16 'pallas' (K4)")
    del gen_p, outs_p
    torch.cuda.empty_cache()

    # float32, the default compute_dtype, at full width and depth through the
    # 3xTF32 kernels: 'auto' (K2/K3) and 'pallas' (K4), each on the bf16
    # generator's weights against the float32 plain twin on pairs[0]
    f32 = {}
    for impl, want in (("auto", {"fused_rope_attention": 48, "fused_rope_cross_attention": 24,
                                 "rope_attention_3xtf32": 72, "kabsch3x3": 1}),
                       ("pallas", {"flash_attention_pallas": 72,
                                   "softmax_attention_3xtf32": 72, "kabsch3x3": 1})):
        g = PseudoGTGenerator(dataclasses.replace(cfg, compute_dtype="float32",
                                                  attention_impl=impl), state_dict=weights)
        g.run_pairs(*pairs[0])  # warm-up
        torch.cuda.synchronize()
        out32, launches32 = run_counted(lambda: g.run_pairs(*pairs[0]), want)
        check_pgt_outputs(out32, np)
        errs32 = rel(out32, gold)
        t0 = time.perf_counter()
        for p in pairs:
            dev_out = g.run_pairs_async(*p)
        torch.cuda.synchronize()
        pps32 = PAIR_BATCH * n / (time.perf_counter() - t0)
        del dev_out
        log(f"pseudo-GT float32 {impl!r} (3xTF32): launches {launches32}; run_pairs_async "
            f"{pps32:.3f} pairs/s; vs the float32 plain twin, max|Δ|/max|ref| "
            f"{json.dumps(errs32)} (limit {F32_ENGINE_REL_LIMIT} on {', '.join(PGT_KEYS)})")
        if max(errs32[k] for k in PGT_KEYS) > F32_ENGINE_REL_LIMIT:
            raise AssertionError(f"pseudo-GT float32 {impl!r} disagrees with its plain twin: "
                                 f"{errs32}")
        f32[impl] = dict(launches=launches32, rel_err=errs32, limit=F32_ENGINE_REL_LIMIT,
                         pairs_per_s_device=pps32)
        del g, out32
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
                                           {counter: 10, "softmax_attention_tc": 10,
                                            "kabsch3x3": 1})
        log(f"pseudo-GT {impl!r} at depth 2: launches {launches_s}")
        check_pgt_outputs(out_s, np)
        reduced[impl] = dict(launches=launches_s,
                             **hold(out_s, ref_small, gold_small, f"bf16 {impl!r} at depth 2"))
        del g
    return dict(pairs_per_s=pps, pairs_per_s_device=pps_device, batch_pairs=PAIR_BATCH,
                n_steps=n, launches=launches, no_wait=no_wait, breakdown=breakdown,
                geometry=geometry,
                rel_err=held, pallas=dict(pairs_per_s=pps_pallas, launches=launches_p,
                                          breakdown=breakdown_p, rel_err=held_p),
                float32=f32, reduced_depth=reduced)


# VGGT-1B's window (the benchmark cell vggt1b-window-b24): WINDOW_FRAMES
# frames of 518², each 1374 tokens (the camera token and 4 registers at RoPE
# position (0, 0), the 37x37 patches at (y + 1, x + 1))
WINDOW_FRAMES = 24
WINDOW_GRID = (37, 37)
WINDOW_SPECIALS = 5
WINDOW_STEPS = 2  # windows dispatched back to back under set_sync_debug_mode('error')
# the plain version's query rows at a time: the scores of a global block's
# S = 32,976 (70 GB in float32 over 16 heads) do not fit the card at once
PLAIN_QUERY_ROWS = 2048


def blocked_attention_plain(fa, q, k, v, scale):
    """fa.attention_plain on [B, H, S, D], PLAIN_QUERY_ROWS query rows at a
    time (each row's softmax is over every key, so the blocks change
    nothing)."""
    import torch

    return torch.cat([fa.attention_plain(q[:, :, i:i + PLAIN_QUERY_ROWS], k, v, scale)
                      for i in range(0, q.shape[2], PLAIN_QUERY_ROWS)], dim=2)


def window_k2_cases(torch, frames: int = WINDOW_FRAMES) -> list:
    """K2 in bf16 at a VGGT frame block's [N, 1374, 3072] and a global
    block's [1, N·1374, 3072] (16 heads of 64), on the frame's RoPE tables
    and, for the global call, those tiled N times, as models/vggt.py makes
    them: held against fused_rope_attention_plain's arithmetic (RoPE in
    float32 rounded to bf16, then attention_plain) a block of query rows at
    a time (ATTENTION_LIMIT), then timed beside SDPA on the pre-roped
    operands. The plain version is not timed at these sizes."""
    import torch.nn.functional as F

    fa = fa_module()
    from thermal3d_torch.models.rope import rope_tables
    from thermal3d_torch.models.vggt import frame_positions

    c, nh = 1024, 16
    d = c // nh
    cos, sin = rope_tables(frame_positions(WINDOW_GRID, WINDOW_SPECIALS, "cuda"), d, 100.0)
    s = cos.shape[0]
    scale = 1.0 / math.sqrt(d)
    cases = []
    for b, tiles, reps in ((frames, 1, 10), (1, frames, 2)):
        seq = s * tiles
        cs, sn = cos.repeat(tiles, 1), sin.repeat(tiles, 1)
        gen = torch.Generator(device="cuda").manual_seed(seq)
        qkv = torch.randn((b, seq, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
        kern = lambda: fa.fused_rope_attention(qkv, cs, sn, nh, scale)  # noqa: E731
        out, moved = launched_families(kern, fa.rope_attention_tc, fa.rope_attention_3xtf32)
        if moved != (1, 0):
            raise AssertionError(f"K2 VGGT [{b},{seq}]: tensor-core and 3xTF32 launches {moved}")
        served = k2k3_served(torch, fa, fa.TENSOR_CORE, b, nh, seq, d)

        def heads(t):
            return t.reshape(b, seq, nh, d).transpose(1, 2)

        def roped(t):
            tf = heads(t).float()
            return (tf * cs + fa.rot_lanes(tf) * sn).to(torch.bfloat16)

        qr, kr, vh = roped(qkv[..., :c]), roped(qkv[..., c:2 * c]), heads(qkv[..., 2 * c:])
        ref = blocked_attention_plain(fa, qr, kr, vh, scale).transpose(1, 2).reshape(b, seq, c)
        err = (out.float() - ref.float()).abs().max().item()
        del out, ref
        limit = ATTENTION_LIMIT["bfloat16"]
        check(f"K2 fused_rope_attention VGGT [{b},{seq},{3 * c}] H={nh} D={d} bfloat16", err,
              limit)
        vh = vh.contiguous()
        ms = cuda_ms(kern, reps=reps)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vh), reps=reps)
        flops = 4 * b * seq * seq * c
        bounds = route_bounds(4 * b * seq * c * 2 + 2 * seq * d * 4, flops, "bfloat16",
                              fa.TENSOR_CORE, fa)
        bnd = bounds["bound_ms"]
        tflops = flops / ms / 1e9
        log(f"    {served}: ms {ms:.4f} library(sdpa) {library_ms:.4f} bound {bnd:.4f} "
            f"({bounds['bound_by']}); {tflops:.1f} TFLOP/s, {ms / bnd:.2f}x bound, "
            f"{ms / library_ms:.2f}x sdpa")
        cases.append(dict(shape=[b, seq, c], heads=nh, head_dim=d, dtype="bfloat16",
                          kernel=served, launches_in_case={"tensor_core": 1, "3xtf32": 0},
                          max_abs_err=err, limit=limit, ms=ms, plain_ms=None,
                          library_ms=library_ms, **bounds, tflops=tflops,
                          ms_over_bound=ms / bnd, ms_over_library=ms / library_ms,
                          model="VGGT-1B " + ("global block" if tiles > 1 else "frame block")))
        del qkv, qr, kr, vh
        torch.cuda.empty_cache()
    return cases


def window_k4_cases(torch, frames: int = WINDOW_FRAMES) -> list:
    """K4 at VGGT's two shapes, on [B, H, S, D] views of a packed [B, S, 3,
    H, D] qkv as models/vggt.py::Attention hands them over: the DINOv2
    trunk's [N, 16, 1374, 64] in bf16 and the camera head's [1, 16, N, 128]
    in float32 (3xTF32), each held and timed by hold_attention_case."""
    fa = fa_module()
    s = WINDOW_SPECIALS + WINDOW_GRID[0] * WINDOW_GRID[1]  # the cls token and 4 registers
    cases = []
    for b, h, seq, d, dt in ((frames, 16, s, 64, torch.bfloat16),
                             (1, 16, frames, 128, torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(seq)
        qkv = torch.randn((b, seq, 3, h, d), generator=gen, device="cuda").to(dt)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        case = hold_attention_case(torch, fa, "flash_attention_pallas", q, k, v, reps=10)
        case["model"] = "VGGT-1B " + ("patch trunk" if d == 64 else "camera head")
        cases.append(case)
        del qkv, q, k, v
        torch.cuda.empty_cache()
    return cases


def phase_window(torch, np):
    """The VGGT-1B window path: a full-width, full-depth bf16
    WindowGenerator (seeded random weights) on a window of WINDOW_FRAMES
    frames [N, 518, 518, 3] already on the card. WINDOW_STEPS windows
    dispatched back to back under torch.cuda.set_sync_debug_mode('error')
    raise nothing, leave the card busy when they return, and launch K2 48
    times a window (24 frame, 24 global blocks; all on the tensor-core
    kernel), K4 40 (the DINOv2 trunk's 24 on the tensor-core kernel, the
    float32 camera head's 16 on the 3xTF32 one) and nothing else counted;
    every output finite at its shape; device ms a window by CUDA events; the
    memory peak."""
    from thermal3d_torch.core.config import VGGT_1B
    from thermal3d_torch.pseudo_gt.window import OUTPUTS, WindowGenerator

    cfg = dataclasses.replace(VGGT_1B, compute_dtype="bfloat16")
    n, size = WINDOW_FRAMES, cfg.img_size
    t0 = time.perf_counter()
    gen = WindowGenerator(cfg, frames=n, params_dtype="bfloat16")
    log(f"window: full-width bf16 VGGT-1B built in {time.perf_counter() - t0:.1f} s")
    frames = torch.rand((n, size, size, 3), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    gen.run_window_async(frames)  # first use of the window's shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = WINDOW_STEPS
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        outs, launches = run_counted(
            lambda: [gen.run_window_async(frames) for _ in range(steps)],
            {"fused_rope_attention": 48 * steps, "rope_attention_tc": 48 * steps,
             "flash_attention_pallas": 40 * steps, "softmax_attention_tc": 24 * steps,
             "softmax_attention_3xtf32": 16 * steps},
            key_tiles=48 * steps)  # S=1374 and 32,976: every K2 call on the key tiles
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        returned = torch.cuda.Event()
        returned.record()
        busy = not returned.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    want = dict(depth=(n, size, size), depth_conf=(n, size, size),
                world_points=(n, size, size, 3), world_points_conf=(n, size, size),
                pose_enc=(n, 9))
    for name in OUTPUTS:
        t = outs[-1][name]
        if tuple(t.shape) != want[name] or t.dtype != torch.float32 or \
                not bool(torch.isfinite(t).all()):
            raise AssertionError(f"window: {name} {tuple(t.shape)} {t.dtype}, want "
                                 f"{want[name]} float32 and finite")
    del outs
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        gen.run_window_async(frames)
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / steps
    log(f"window: {steps} run_window_async windows of {n} frames under "
        f"set_sync_debug_mode('error'): no host wait, {host_ms:.1f} ms of host a dispatch "
        f"against {device_ms:.1f} ms of device a window, card busy at return: {busy}; "
        f"launches {launches}; memory peak {peak} bytes")
    if not busy:
        raise AssertionError("window: the card was idle when the dispatches returned")
    del gen
    torch.cuda.empty_cache()
    return dict(frames=n, steps=steps, host_ms_a_dispatch=host_ms, device_ms_a_window=device_ms,
                busy_at_return=busy, launches={k: v // steps for k, v in launches.items()},
                memory_peak_bytes=peak)


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


def write_tree(np, root: str, n_rgb: int = N_RGB):
    """The phase's files: `thermal/` (N_FRAMES uint16 frames, raw counts
    21000-26000 with structure, and one corrupt file) and a Freiburg tree
    `ds/train/seq_00_day/00/{fl_rgb,fl_ir_aligned}` of n_rgb RGB8 frames and
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
    good = [p for i, p in enumerate(thermal) if i != CORRUPT_AT]  # the RGB twins decode
    for i in range(n_rgb):
        stamp = f"{1590000 + i}_{i:03d}"
        rgb = np.roll(0.7 * base, 8 * i, axis=1) + 0.3 * rng.uniform(size=base.shape)
        with open(os.path.join(seq, "fl_rgb", f"fl_rgb_{stamp}.png"), "wb") as f:
            f.write(png_bytes(np, (255 * rgb).astype(np.uint8)))
        with open(os.path.join(seq, "fl_ir_aligned", f"fl_ir_aligned_{stamp}.png"), "wb") as f:
            f.write(open(good[i], "rb").read())
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
                "rope_attention_tc": 72 * n_steps, "kabsch3x3": n_steps}
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


def train_batch(torch, np, seed: int = 0, device: str = "cuda", b: int = TRAIN_BATCH):
    """A training batch of b pairs on `device`: raw-count thermal pairs
    [b,224,224,3] (a ramp, a wave and noise; view 2 shifted 6 pixels) and
    512² pointmaps of a tilted wavy surface with confidences."""
    rng = np.random.default_rng(seed)
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
# ... and at the training shape of a decoder 512 wide with 16 heads
# (head_dim 32, the small-decoder engine's: phase_small_decoder)
TRAIN_BWD_D32_CASES = (("K2 small decoder", "K2", TRAIN_BATCH, 512, 16),
                       ("K3 small decoder", "K3", TRAIN_BATCH, 512, 16),
                       ("K4 'pallas' small decoder", "K4", TRAIN_BATCH, 512, 16))
# ... and at the training shape of a ViT-H encoder (1280 wide, 16 heads:
# head_dim 80, the packed route; phase_vit_h), both views at once
TRAIN_BWD_VITH_CASES = (("K2 ViT-H encoder", "K2", 2 * TRAIN_BATCH, 1280, 16),)


def train_backward_cases(torch, device: str = "cuda", shapes=TRAIN_BWD_CASES):
    """Each autograd Function at the training shapes (`shapes`), on
    `device`: its forward (the kernel on the card) is held against the plain
    forward at phase 3's limits, its backward (plain PyTorch) against
    float64 autograd of the plain forward. On the card the Function must
    launch its kernel, of the family attention_route names (its own count
    moving once), and the backward alone is timed by graph replay; returns
    the cases and, for TRAIN_BWD_CASES, the bf16 backward ms of one training
    step (None on the CPU or for other shapes)."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    on_card = device != "cpu"
    pos = make_grid_positions(14, 14, device=device)
    s = 196
    cases = []
    for what, kind, b, c, nh in shapes:
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
            families = ((fa.softmax_attention_tc, fa.softmax_attention_3xtf32) if kind == "K4"
                        else (fa.rope_attention_tc, fa.rope_attention_3xtf32))
            family_before = tuple(f.launches for f in families)
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
            route = fa.attention_route(dt, d)
            moved = tuple(f.launches - n for f, n in zip(families, family_before))
            if "Backward" not in type(out.grad_fn).__name__ or (on_card and (
                    entry.launches != before + 1
                    or moved != (int(route == fa.TENSOR_CORE), int(route == fa.TF32X3)))):
                raise AssertionError(f"{what} {dname}: the kernel's Function did not run "
                                     f"(tensor-core and 3xTF32 launches {moved}, route {route})")
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
    if not on_card or shapes is not TRAIN_BWD_CASES:
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


# phase 8: fire-scene preprocessing, depth refinement and the entry points'
# figures, on phase 6's tree. Each filter runs on the card and on the CPU at
# both shapes, held to the limits of tests/test_torch_filters.py (there: the
# CPU against the JAX package):
FILTER_SHAPES = ((224, 224), FRAME_HW)
SMOOTH_REL = 1e-6  # max|Δ|/max|ref|: CLAHE, Sobel, bilateral, outlier median
EDGE_FRAC = 1e-3  # Canny: the share of pixels that may differ (a flipped sector)
FIRE_ATOL, FIRE_FRAC = 1e-5, 1e-3  # fire variants: the share of values beyond FIRE_ATOL
# the guided filter's integral images cancel (the port sums them in float64,
# so both devices round one sum): the card may differ from the CPU by twice
# the CPU's own float32 error against float64 (refine_depth: that of its
# guided stage, plus SMOOTH_REL)
GUIDED_FACTOR = 2.0
N_FIRE = 16  # frames of each fire-scene and refinement mode
N_AIS = 8  # frames of cli.ais_investigate (4 stages)


def filter_cases(torch, np, gray_full):
    """Every filter of kernels/filters.py, refine_depth and both fire-scene
    variants on the card against the CPU, at FILTER_SHAPES; the card's host
    time of each at 224² (one call, synchronised)."""
    from thermal3d_torch.kernels import filters as flt
    from thermal3d_torch.preprocess.fire_scene import (advanced_fire_scene_processing,
                                                       preprocess_fire_scene_thermal)
    from thermal3d_torch.preprocess.refine import refine_depth
    from thermal3d_torch.preprocess.resize import resize_bilinear_hw

    cases = []
    for hw in FILTER_SHAPES:
        g = resize_bilinear_hw(torch.from_numpy(gray_full), hw) if hw != FRAME_HW \
            else torch.from_numpy(gray_full)
        norm = (g - g.min()) / (g.max() - g.min())
        rgb = torch.stack([norm, norm.flip(0), norm.flip(1)], dim=-1)
        depth = 2.0 + 12.0 * norm.flip(1)
        depth[5, 7], depth[hw[0] // 2, hw[1] // 3] = 80.0, -40.0  # outliers
        cleaned = flt.remove_depth_outliers(depth)
        g64 = flt.guided_filter(norm.double(), cleaned.double())
        guided_err = float((flt.guided_filter(norm, cleaned) - g64).abs().max())
        g64 = flt.guided_filter(norm.double(), depth.double())
        guided_err_raw = float((flt.guided_filter(norm, depth) - g64).abs().max())
        fns = {
            "clahe": (lambda x, d, c: flt.clahe(x), "smooth"),
            "clahe_2.5": (lambda x, d, c: flt.clahe(1.0 - x, clip_limit=2.5), "smooth"),
            "sobel_xy": (lambda x, d, c: torch.stack(flt.sobel_xy(x)), "smooth"),
            "sobel_magnitude_normalized": (lambda x, d, c: flt.sobel_magnitude_normalized(x),
                                           "smooth"),
            "canny_edges": (lambda x, d, c: flt.canny_edges(x), "edges"),
            "canny_edges_30": (lambda x, d, c: flt.canny_edges(x, low=30.0), "edges"),
            "bilateral_rgb": (lambda x, d, c: flt.bilateral_filter(c, 9, 75.0 / 255.0, 75.0),
                              "smooth"),
            "bilateral_depth": (lambda x, d, c: flt.bilateral_filter(d, 5, 50.0, 50.0), "smooth"),
            "remove_depth_outliers": (lambda x, d, c: flt.remove_depth_outliers(d), "smooth"),
            "guided_filter": (lambda x, d, c: flt.guided_filter(x, d), "guided"),
            "refine_depth": (lambda x, d, c: refine_depth(d, x), "refine"),
            "preprocess_fire_scene_thermal": (lambda x, d, c: preprocess_fire_scene_thermal(x),
                                              "fire"),
            "advanced_fire_scene_processing": (lambda x, d, c: advanced_fire_scene_processing(x),
                                               "fire"),
        }
        on_card = norm.cuda(), depth.cuda(), rgb.cuda()
        for name, (fn, kind) in fns.items():
            ref = fn(norm, depth, rgb).float()
            fn(*on_card)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*on_card)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            diff = (got.cpu().float() - ref).abs()
            scale = float(ref.abs().max())
            entry = dict(name=name, shape=list(hw), max_abs_err=float(diff.max()),
                         card_ms=host_ms)
            if kind == "smooth":
                entry.update(rel_err=float(diff.max()) / scale, limit=SMOOTH_REL)
                ok = entry["rel_err"] <= SMOOTH_REL
            elif kind == "edges":
                entry.update(frac_differ=float((diff > 0).float().mean()), limit=EDGE_FRAC)
                ok = entry["frac_differ"] <= EDGE_FRAC
            elif kind == "fire":
                entry.update(frac_beyond=float((diff > FIRE_ATOL).float().mean()),
                             limit=FIRE_FRAC)
                ok = entry["frac_beyond"] <= FIRE_FRAC
            else:
                err = guided_err_raw if kind == "guided" else guided_err
                limit = GUIDED_FACTOR * err + (SMOOTH_REL * scale if kind == "refine" else 0.0)
                entry.update(cpu_f32_vs_f64=err, limit=limit)
                ok = entry["max_abs_err"] <= limit
            shown = {k: v for k, v in entry.items() if k not in ("name", "shape")}
            log(f"  {name} {list(hw)}: {json.dumps(shown)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {hw}: the card disagrees with the CPU: {entry}")
            cases.append(entry)
    return cases


def check_panel_depth_tile(np, png_path: str, depth, x0: int):
    """The tile at column x0 of a figure written by viz/panels.py equals the
    plasma map of `depth` (decoded by the port's PNG decoder)."""
    from thermal3d_torch import native
    from thermal3d_torch.viz.colormaps import colormap_rgb

    decoded = native.decode_png(png_path)
    if decoded is None:
        raise AssertionError(f"{png_path}: the figure does not decode")
    img = decoded[0].astype(np.uint8)
    h, w = depth.shape
    if not np.array_equal(img[:h, x0:x0 + w], colormap_rgb(depth, "plasma")):
        raise AssertionError(f"{png_path}: the depth tile is not the plasma map of the depth")
    return img


def phase_fire(torch, np, card: str, root: str):
    """Phase 8: the filters on the card against the CPU; cli.infer with its
    default flags (a panel a frame) and in the fire-scene and refinement
    modes, cli.ais_investigate, cli.evaluate with its comparison panels,
    each timed and with its launch counts; the port's bench script in a
    subprocess."""
    import glob
    import os
    import shutil

    from thermal3d_torch.cli import ais_investigate as cli_ais
    from thermal3d_torch.cli import evaluate as cli_evaluate
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli.common import apply_preset
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.preprocess.fire_scene import (advanced_fire_scene_processing,
                                                       preprocess_fire_scene_thermal)
    from thermal3d_torch.preprocess.io import load_thermal_image, preprocess_thermal_for_model
    from thermal3d_torch.preprocess.refine import refine_depth
    from thermal3d_torch.preprocess.resize import resize_bilinear_hw
    from thermal3d_torch.viz import panels

    t_phase = time.perf_counter()
    thermal_dir = os.path.join(root, "thermal")
    paths = sorted(glob.glob(os.path.join(thermal_dir, "*.png")))
    survivors = [p for i, p in enumerate(paths) if i != CORRUPT_AT]
    log("fire-scene: filters on the card against the CPU:")
    filters = filter_cases(torch, np, load_thermal_image(survivors[0]))

    # the CLI's engine (seed 0, float32 weights, bf16 compute), built here to
    # time what each CLI run below pays before its first frame
    t0 = time.perf_counter()
    eng = InferenceEngine(apply_preset(DUSTR_224_LINEAR, "full", (224, 224), "bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"fire-scene: the CLI's engine builds in {build_s:.3f} s")

    def cli(argv, want, frames):
        t0 = time.perf_counter()
        _, launches = run_counted(lambda: cli_infer.main(argv), want)
        seconds = time.perf_counter() - t0
        return dict(frames=frames, seconds=seconds, frames_per_s=frames / seconds,
                    frames_per_s_less_build=frames / max(seconds - build_s, 1e-9),
                    launches=launches)

    serving = {"percentile_enhance": 4, "fused_rope_attention": 160,
               "fused_rope_cross_attention": 64, "rope_attention_tc": 224}
    modes = {}
    # the default flags: a panel a frame, its input through K1 (one launch a frame)
    vis_dir, plain_dir = os.path.join(root, "vis"), os.path.join(root, "no_vis")
    common = ["--img_path", thermal_dir, "--batch_size", str(BATCH)]
    modes["no_vis"] = cli(common + ["--output_dir", plain_dir, "--no_vis"], serving, N_FRAMES)
    modes["default_figures"] = cli(common + ["--output_dir", vis_dir],
                                   dict(serving, percentile_enhance=4 + N_FRAMES), N_FRAMES)
    figure_ms = 1e3 * (modes["default_figures"]["seconds"] - modes["no_vis"]["seconds"]) / N_FRAMES
    vis = sorted(glob.glob(os.path.join(vis_dir, "*_depth_vis.png")))
    if len(vis) != N_FRAMES:
        raise AssertionError(f"cli.infer: {len(vis)} panels for {N_FRAMES} decodable frames")
    for p in vis:
        base = p[:-len("_depth_vis.png")]
        depth = np.load(base + "_depth.npy")
        if not np.array_equal(depth, np.load(os.path.join(plain_dir, os.path.basename(base)
                                                          + "_depth.npy"))):
            raise AssertionError(f"{base}: the depth differs between --no_vis and figures")
        img = check_panel_depth_tile(np, p, depth, depth.shape[1] + panels.GAP)
    first = survivors[0]
    tile = panels.rgb_tile(preprocess_thermal_for_model(first, (224, 224)))
    img = check_panel_depth_tile(np, os.path.join(vis_dir, os.path.basename(first)[:-4]
                                                  + "_depth_vis.png"),
                                 np.load(os.path.join(vis_dir, os.path.basename(first)[:-4]
                                                      + "_depth.npy")), 224 + panels.GAP)
    if not np.array_equal(img[:224, :224], tile):
        raise AssertionError("cli.infer: the panel's input tile is not the frame as the model "
                             "sees it")
    log(f"cli.infer (figures): {len(vis)} panels, each depth tile the plasma map of its "
        f"depth; {modes['default_figures']['frames_per_s']:.2f} frames/s against "
        f"{modes['no_vis']['frames_per_s']:.2f} with --no_vis: {figure_ms:.2f} ms a figure; "
        f"launches {modes['default_figures']['launches']}")

    # the fire-scene and refinement modes on N_FIRE frames, batch 1 a frame
    fire_dir = os.path.join(root, "fire_frames")
    os.makedirs(fire_dir)
    for p in survivors[:N_FIRE]:
        shutil.copy(p, fire_dir)
    n = N_FIRE
    a_frame = {"fused_rope_attention": 40 * n, "fused_rope_cross_attention": 16 * n,
               "rope_attention_tc": 56 * n}
    one_batch = {"percentile_enhance": 1, "fused_rope_attention": 40,
                 "fused_rope_cross_attention": 16, "rope_attention_tc": 56}
    fire_common = ["--img_path", fire_dir, "--no_vis", "--batch_size", str(N_FIRE)]
    for name, flags, want in (("fire_scene", ["--fire_scene"], a_frame),
                              ("advanced_fire_refine", ["--advanced_fire", "--refine_depth"],
                               a_frame),
                              ("refine_depth", ["--refine_depth"], one_batch)):
        out_dir = os.path.join(root, name)
        modes[name] = cli(fire_common + ["--output_dir", out_dir] + flags, want, n)
        depths = sorted(glob.glob(os.path.join(out_dir, "*_depth.npy")))
        if len(depths) != n or any(np.load(d).shape != (224, 224)
                                   or not np.isfinite(np.load(d)).all() for d in depths):
            raise AssertionError(f"cli.infer {flags}: {len(depths)} depth files, or a bad one")
        log(f"cli.infer {' '.join(flags)}: {n} frames, {modes[name]['frames_per_s']:.2f} "
            f"frames/s ({modes[name]['frames_per_s_less_build']:.2f} less the engine's "
            f"build); launches {modes[name]['launches']}")
    # the CLI's files against the public functions on the same frame, in process
    for name, fn, refine in (("fire_scene", preprocess_fire_scene_thermal, False),
                             ("advanced_fire_refine", advanced_fire_scene_processing, True)):
        gray = torch.from_numpy(load_thermal_image(first)).cuda()
        with torch.inference_mode():
            resized = resize_bilinear_hw(gray, (224, 224))
            want = eng.infer(fn(resized)[None], preprocessed=True)["depth"][0]
            if refine:
                want = refine_depth(torch.from_numpy(want).cuda(), resized).cpu().numpy()
        got = np.load(os.path.join(root, name, os.path.basename(first)[:-4] + "_depth.npy"))
        if not np.array_equal(got, want):
            raise AssertionError(f"cli.infer {name}: the depth differs from the functions'")
    log("cli.infer --fire_scene and --advanced_fire --refine_depth: bit-equal to the "
        "functions on the same frame")
    del eng
    torch.cuda.empty_cache()

    # cli.ais_investigate: N_AIS frames, the four stages (figures on)
    ais_frames, ais_dir = os.path.join(root, "ais_frames"), os.path.join(root, "ais")
    os.makedirs(ais_frames)
    for p in survivors[:N_AIS]:
        shutil.copy(p, ais_frames)
    t0 = time.perf_counter()
    rows, ais_launches = run_counted(
        lambda: cli_ais.main(["--img_path", ais_frames, "--output_dir", ais_dir, "--stages",
                              *cli_ais.STAGES]),
        {"percentile_enhance": 1 + 4 * N_AIS, "fused_rope_attention": 40 * (1 + 3 * N_AIS),
         "fused_rope_cross_attention": 16 * (1 + 3 * N_AIS),
         "rope_attention_tc": 56 * (1 + 3 * N_AIS)})
    ais_s = time.perf_counter() - t0
    report = open(os.path.join(ais_dir, "investigation.md")).read()
    strips = glob.glob(os.path.join(ais_dir, "*_stages.png"))
    if rows != 4 * N_AIS or len(strips) != N_AIS:
        raise AssertionError(f"cli.ais_investigate: {rows} rows, {len(strips)} strips")
    for p in survivors[:N_AIS]:
        base = os.path.basename(p)[:-4]
        for stage in cli_ais.STAGES:
            s = cli_ais._stage_stats(np.load(os.path.join(ais_dir, stage, f"{base}_depth.npy")))
            line = (f"| {base} | {stage} | {s['min']:.3f} | {s['max']:.3f} | {s['range']:.3f} | "
                    f"{s['blockiness']:.2f} |")
            if line not in report:
                raise AssertionError(f"investigation.md lacks {line}")
    log(f"cli.ais_investigate: {N_AIS} frames x 4 stages in {ais_s:.1f} s, investigation.md "
        f"rows equal to the stats of the saved depths; launches {ais_launches}")

    # cli.evaluate with its comparison panels, on the N_FIRE frames and phase
    # 6's pseudo-GT depths (one batch, padded to BATCH as the --no_vis run's)
    ev_dir = os.path.join(root, "evaluation_vis")
    t0 = time.perf_counter()
    summary, ev_launches = run_counted(lambda: cli_evaluate.main([
        "--thermal_dir", fire_dir, "--pseudo_gt_dir", os.path.join(root, "gt"),
        "--output_dir", ev_dir, "--batch_size", str(BATCH)]), one_batch)
    ev_s = time.perf_counter() - t0
    comps = sorted(glob.glob(os.path.join(ev_dir, "*_comparison.png")))
    if summary["n_images"] != N_FIRE or len(comps) != N_FIRE:
        raise AssertionError(f"cli.evaluate: {summary['n_images']} images, {len(comps)} panels")
    depth0 = np.load(os.path.join(plain_dir, os.path.basename(first)[:-4] + "_depth.npy"))
    comp0 = os.path.join(ev_dir, os.path.basename(first)[:-4] + "_comparison.png")
    img = check_panel_depth_tile(np, comp0, depth0, FRAME_HW[1] + panels.GAP)
    if not np.array_equal(img[:FRAME_HW[0], :FRAME_HW[1]], panels.thermal_file_tile(first)):
        raise AssertionError("cli.evaluate: the thermal tile is not the frame's raw >> 8")
    log(f"cli.evaluate (panels): {len(comps)} comparison panels in {ev_s:.1f} s; launches "
        f"{ev_launches}")

    # the port's bench script, as a user runs it
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "thermal3d_torch.bench", "--iters", "12"],
                         capture_output=True, text=True, timeout=600, check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    bench_line = res.stdout.strip().splitlines()[-1]
    bench = json.loads(bench_line)
    if bench["device"]["type"] != "cuda" or not bench["value"] > 0:
        raise AssertionError(f"bench: {bench_line}")
    log(f"bench ({time.perf_counter() - t0:.1f} s): {bench_line}")
    return dict(card=card, filters=filters, engine_build_s=build_s, cli_infer=modes,
                figure_ms_per_frame=figure_ms,
                ais_investigate=dict(frames=N_AIS, stages=len(cli_ais.STAGES), seconds=ais_s,
                                     launches=ais_launches),
                cli_evaluate=dict(panels=len(comps), seconds=ev_s, launches=ev_launches),
                bench=bench, bench_line=bench_line, seconds=time.perf_counter() - t_phase)


# phase 9: int8 serving (kernels/quant.py) and the parity gate (cli.parity).
# The int8 product's shapes, [M, K, N]: DUSt3R-224's trunk at the serving
# batch (M = 32·196: qkv, proj, fc1, fc2) and MASt3R-512's (the encoder on
# both views, M = 8·1024; decoder_embed and the decoder, M = 4·1024); each
# flat and grouped (K/128 segments) against the plain float64 route
INT8_TRUNK_SHAPES = ((BATCH * 196, 1024, 3072), (BATCH * 196, 1024, 1024),
                     (BATCH * 196, 1024, 4096), (BATCH * 196, 4096, 1024))
INT8_MASTR_SHAPES = ((8 * 1024, 1024, 3072), (8 * 1024, 1024, 1024), (8 * 1024, 1024, 4096),
                     (8 * 1024, 4096, 1024), (4 * 1024, 1024, 768), (4 * 1024, 768, 2304),
                     (4 * 1024, 768, 768), (4 * 1024, 768, 3072), (4 * 1024, 3072, 768))
INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
INT8_CPU_ROWS = 256  # rows of int8_dense held against the CPU (each row is independent)
# the int8 serving configurations of the DUSt3R-224 engine: name → its
# int8 options (static: scales calibrated on INT8_CALIB_FRAMES other frames)
INT8_CONFIGS = (("all", {}), ("fc1_static", dict(int8_only=("fc1",), static=True)),
                ("all_static", dict(static=True)), ("all_group128", dict(int8_group_size=128)),
                ("all_equalize", dict(int8_equalize=True)))
INT8_CALIB_FRAMES = 4
N_INT8_BATCHES = 2
# an int8 configuration's outputs against its plain twin (attention
# 'torch', enhance 'plain', the float64 int8 product), max|Δ|/max|ref|: a
# bf16 rounding the kernels flip upstream can move an int8 rounding; set on
# the CPU by scripts/torch_int8_limits.py before the first chip run
# (PERF.md, PR 8): the same kind of difference moves the int8
# configurations at most 2.04x as far as the bf16 engine (CPU, full width
# and depth), so the bf16 limit times 2.1
INT8_TWIN_REL_LIMIT = 2.1 * BF16_ENGINE_REL_LIMIT
N_PARITY_FRAMES = 16


def int8_gemm_launches(cfg, only=(), group_size=None) -> int:
    """torch._int_mm launches of one forward of `cfg` with the trunk's Dense
    modules named in `only` (all when empty) in int8: one a call, K/group
    a call with grouped scales. The encoder runs once (both views in one
    batch), decoder_embed once a view, each decoder branch dec_depth blocks."""
    e, d, r = cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.mlp_ratio
    enc = (("qkv", e), ("proj", e), ("fc1", e), ("fc2", int(e * r)))
    dec = (("qkv", d), ("proj", d), ("projq", d), ("projk", d), ("projv", d), ("proj", d),
           ("fc1", d), ("fc2", int(d * r)))

    def n(name, k):
        if only and name not in only:
            return 0
        return k // group_size if group_size and k % group_size == 0 else 1

    return (cfg.enc_depth * sum(n(*g) for g in enc) + 2 * n("decoder_embed", e)
            + 2 * cfg.dec_depth * sum(n(*g) for g in dec))


def int8_product_cases(torch):
    """The int8 product on the card: torch._int_mm against the plain float64
    route at every shape, flat and a segment at a time (limit 0); then, at
    the trunk shapes, quantize_kernel and int8_dense (dynamic and static in
    bf16 and float32 out, grouped in bf16) on the card against the same
    function on the CPU for INT8_CPU_ROWS rows (limit 0); times of _int_mm,
    the bf16 F.linear it replaces, the quantize and dequant passes and the
    whole int8 Dense, by graph replay."""
    import torch.nn.functional as F

    from thermal3d_torch.kernels import quant

    products = []
    for m, k, n in INT8_TRUNK_SHAPES + INT8_MASTR_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(m + k + n)
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        equal = torch.equal(quant.int_mm(xq, wq), quant.int_mm_plain(xq, wq))
        g = k // 128
        xg = xq.reshape(m, g, 128).transpose(0, 1).contiguous()
        wg = wq.reshape(n, g, 128).transpose(0, 1).contiguous()
        equal_g = all(torch.equal(quant.int_mm(xg[i], wg[i]), quant.int_mm_plain(xg[i], wg[i]))
                      for i in range(g))
        products.append(dict(shape=[m, k, n], flat_equal=equal, grouped_segments=g,
                             grouped_equal=equal_g))
        log(f"  int8 product [{m},{k}]x[{k},{n}]: _int_mm == float64 route: flat {equal}, "
            f"{g} segments {equal_g}")
        if not (equal and equal_g):
            raise AssertionError(f"int8 product [{m},{k},{n}]: torch._int_mm departs from the "
                                 "exact float64 product")
        del xq, wq, xg, wg
    torch.cuda.empty_cache()

    timings = []
    for m, k, n in INT8_TRUNK_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(k * n)
        scale = torch.rand((1, k), generator=gen, device="cuda") * 3 + 0.1
        x = (torch.randn((m, k), generator=gen, device="cuda") * scale).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
        b = (0.1 * torch.randn((n,), generator=gen, device="cuda")).to(torch.bfloat16)
        cpu = dict(x=x[:INT8_CPU_ROWS].cpu(), w=w.cpu())
        errs = {}
        for group in (None, 128):
            wq, ws = quant.quantize_kernel(w, group)
            cwq, cws = quant.quantize_kernel(cpu["w"], group)
            errs[f"quantize_kernel_g{group}"] = int(not (torch.equal(wq.cpu(), cwq)
                                                         and torch.equal(ws.cpu(), cws)))
            variants = [("dynamic", None, torch.bfloat16), ("dynamic", None, torch.float32),
                        ("static", 2.5, torch.bfloat16), ("static", 2.5, torch.float32)]
            for name, act, dt in variants if group is None else [("grouped", None,
                                                                   torch.bfloat16)]:
                a = None if act is None else torch.tensor(act, device="cuda")
                got = quant.int8_dense(x, wq, ws, dt, act_scale=a)[:INT8_CPU_ROWS].cpu()
                want = quant.int8_dense(cpu["x"], cwq, cws, dt, act_scale=None if a is None
                                        else a.cpu(), impl="plain")
                errs[f"{name}_{str(dt)[6:]}"] = float((got.float() - want.float()).abs().max())
        bad = {kk: v for kk, v in errs.items() if v != 0}
        log(f"  int8 [{m},{k}]x[{k},{n}] card vs CPU: max|Δ| {json.dumps(errs)} (limit 0)")
        if bad:
            raise AssertionError(f"int8 [{m},{k},{n}]: the card departs from the CPU: {bad}")

        wq, ws = quant.quantize_kernel(w)
        xs = quant.dynamic_scale(x.float().abs().amax(dim=-1, keepdim=True))
        xq = quant.quantize_values(x.float(), xs)
        acc = quant.int_mm(xq, wq)

        def quantize_pass():
            xf = x.float()
            return quant.quantize_values(xf, quant.dynamic_scale(xf.abs().amax(-1, keepdim=True)))

        ms = dict(
            int_mm=cuda_ms(lambda: torch._int_mm(xq, wq.t())),
            bf16_linear=cuda_ms(lambda: F.linear(x, w, b)),
            quantize=cuda_ms(quantize_pass),
            dequant=cuda_ms(lambda: (acc.float() * (xs * ws)).to(torch.bfloat16) + b),
            int8_dense=cuda_ms(lambda: quant.int8_dense(x, wq, ws, torch.bfloat16) + b))
        ops = 2.0 * m * k * n
        bound, by = max((ops / INT8_PEAK_OPS * 1e3, "operations"),
                        ((m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3, "bytes"))
        q_bound = (2 * m * k + m * k + 4 * m) / HBM_BYTES_PER_S * 1e3
        d_bound = (4 * m * n + 2 * m * n + 4 * m + 4 * n + 2 * n) / HBM_BYTES_PER_S * 1e3
        timings.append(dict(shape=[m, k, n], ms=ms, int_mm_bound_ms=bound, int_mm_bound_by=by,
                            int_mm_tops=ops / ms["int_mm"] / 1e9,
                            bf16_linear_tflops=ops / ms["bf16_linear"] / 1e9,
                            quantize_bound_ms=q_bound, dequant_bound_ms=d_bound,
                            card_vs_cpu=errs))
        rounded = {kk: round(v, 4) for kk, v in ms.items()}
        log(f"  int8 [{m},{k}]x[{k},{n}] ms: {json.dumps(rounded)}; _int_mm bound "
            f"{bound:.4f} ({by}), {ops / ms['int_mm'] / 1e9:.1f} TOP/s; bf16 F.linear "
            f"{ops / ms['bf16_linear'] / 1e9:.1f} TFLOP/s; quantize bound {q_bound:.4f}, "
            f"dequant bound {d_bound:.4f}")
        del x, w, b, wq, ws, xq, acc
        torch.cuda.empty_cache()
    return dict(products=products, timings=timings)


# int8 profile layers: the IMMA GEMM before the bf16 ones, and the
# elementwise passes (quantize, dequant, the casts and the residual adds)
INT8_LAYERS = ((("int8 GEMM (cuBLASLt)", ("s8", "imma", "i8i8", "int8")),) + LAYERS[:-1]
               + (("elementwise (quantize/dequant, casts, adds)",
                   ("elementwise", "abs", "round", "clamp", "reduce_kernel", "copy_kernel")),)
               + LAYERS[-1:])


def int8_drift(np, depth, ref, device="cuda"):
    """Median-scaled AbsRel of depth against ref (the whole batch as one map,
    as the bench scores it) and the depth's rel RMS."""
    from thermal3d_torch.evaluation.metrics import compute_depth_metrics

    w = ref.shape[-1]
    abs_rel = compute_depth_metrics(depth.reshape(-1, w), ref.reshape(-1, w),
                                    median_scaling=True, device=device)["abs_rel"]
    return dict(abs_rel=abs_rel, rel_rms=float(np.linalg.norm(depth.astype(np.float64) - ref)
                                               / np.linalg.norm(ref.astype(np.float64))))


def phase_int8_engine(torch, np):
    """The full-width, full-depth bf16 DUSt3R-224 engine in each of
    INT8_CONFIGS: launches (K1 n, K2 40n, K3 16n, _int_mm as derived), the
    outputs against the configuration's own plain twin, the depth's drift
    against the bf16 engine; for 'all', infer_async frames/s against bf16 in
    turns and one batch of each under torch.profiler."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine

    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    plain_cfg = dataclasses.replace(cfg, attention_impl="torch")
    bf16 = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    weights = bf16.model.state_dict()
    frames = [raw_frames(np, 20 + i) for i in range(N_INT8_BATCHES)]
    calib = raw_frames(np, 30)[:INT8_CALIB_FRAMES]
    ref = bf16.infer(frames[0])
    n = N_INT8_BATCHES
    results = {}
    for name, opts in INT8_CONFIGS:
        opts = dict(opts)
        kw = dict(quantize_int8=True, int8_calibration=calib if opts.pop("static", False)
                  else None, **opts)
        t0 = time.perf_counter()
        eng = InferenceEngine(cfg, state_dict=weights, params_dtype="bfloat16", **kw)
        build_s = time.perf_counter() - t0
        eng.infer(frames[0])  # warm-up
        torch.cuda.synchronize()
        gemms = int8_gemm_launches(cfg, opts.get("int8_only", ()), opts.get("int8_group_size"))
        outs, launches = run_counted(lambda: [eng.infer(f) for f in frames], {
            "percentile_enhance": n, "fused_rope_attention": 40 * n,
            "fused_rope_cross_attention": 16 * n, "rope_attention_tc": 56 * n,
            "int_mm": gemms * n})
        for out in outs:
            check_outputs(out, np)
        twin = InferenceEngine(plain_cfg, state_dict=weights, params_dtype="bfloat16",
                               enhance_impl="plain", int8_impl="plain", **kw)
        twin_out, _ = run_counted(lambda: twin.infer(frames[0]), {})  # no kernel, no _int_mm
        errs = {k: rel_err(outs[0][k], twin_out[k], np) for k in twin_out}
        drift = int8_drift(np, outs[0]["depth"], ref["depth"])
        log(f"int8 engine {name!r} (built in {build_s:.2f} s): launches {launches}; vs its "
            f"plain twin max|Δ|/max|ref| {json.dumps(errs)} (limit {INT8_TWIN_REL_LIMIT}); "
            f"depth drift vs bf16 {json.dumps(drift)}")
        if max(errs.values()) > INT8_TWIN_REL_LIMIT:
            raise AssertionError(f"int8 engine {name!r} disagrees with its plain twin: {errs}")
        results[name] = dict(launches=launches, int8_gemms_per_forward=gemms, build_s=build_s,
                             vs_plain_twin=errs, drift_vs_bf16=drift)
        del twin
        if name == "all":
            fps = {"bf16": [], "int8_all": []}
            for which, e in (("bf16", bf16), ("int8_all", eng), ("int8_all", eng),
                             ("bf16", bf16)):
                t0 = time.perf_counter()
                for f in frames:
                    dev_out = e.infer_async(f)
                torch.cuda.synchronize()
                fps[which].append(BATCH * n / (time.perf_counter() - t0))
            del dev_out
            log(f"int8 engine 'all': infer_async frames/s in turns {json.dumps(fps)}")
            results["infer_async_fps"] = fps
            results["profile_bf16"] = profile_batch(torch, lambda: bf16.infer(frames[0]),
                                                    "one bf16 infer() (int8 layers)",
                                                    INT8_LAYERS)
            results["profile_int8_all"] = profile_batch(torch, lambda: eng.infer(frames[0]),
                                                        "one int8 'all' infer()", INT8_LAYERS)
        del eng
        torch.cuda.empty_cache()
    del bf16
    torch.cuda.empty_cache()
    return results


def phase_int8_generator(torch, np):
    """The full-width, full-depth bf16 MASt3R-512 generator with every trunk
    GEMM in int8 (dynamic scales) on N_PAIR_BATCHES steps of PAIR_BATCH
    pairs: K2 48n, K3 24n, _int_mm 290n; pairs/s of run_pairs_async against
    the bf16 generator in turns; the geometry against float64 numpy; the
    depth drift against bf16."""
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    cfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    bf16 = PseudoGTGenerator(cfg, params_dtype="bfloat16", seed=0)
    gen = PseudoGTGenerator(cfg, state_dict=bf16.model.state_dict(), params_dtype="bfloat16",
                            quantize_int8=True)
    pairs = [rgb_pairs(np, 40 + i) for i in range(N_PAIR_BATCHES)]
    n = N_PAIR_BATCHES
    ref = bf16.run_pairs(*pairs[0])
    gen.run_pairs(*pairs[0])  # warm-up
    torch.cuda.synchronize()
    gemms = int8_gemm_launches(cfg)
    outs, launches = run_counted(lambda: [gen.run_pairs(*p) for p in pairs], {
        "fused_rope_attention": 48 * n, "fused_rope_cross_attention": 24 * n,
        "rope_attention_tc": 72 * n, "int_mm": gemms * n, "kabsch3x3": n})
    for out in outs:
        check_pgt_outputs(out, np)
    geometry = check_geometry(outs[0], np)
    pps = {"bf16": [], "int8_all": []}
    for which, g in (("bf16", bf16), ("int8_all", gen), ("int8_all", gen), ("bf16", bf16)):
        t0 = time.perf_counter()
        for p in pairs:
            dev_out = g.run_pairs_async(*p)
        torch.cuda.synchronize()
        pps[which].append(PAIR_BATCH * n / (time.perf_counter() - t0))
    del dev_out
    drift = int8_drift(np, outs[0]["depth1"], ref["depth1"])
    log(f"int8 generator 'all': launches {launches} ({gemms} int8 GEMMs a step); "
        f"run_pairs_async pairs/s in turns {json.dumps(pps)}; depth1 drift vs bf16 "
        f"{json.dumps(drift)}")
    del gen, bf16
    torch.cuda.empty_cache()
    return dict(launches=launches, int8_gemms_per_step=gemms, pairs_per_s=pps,
                geometry=geometry, drift_vs_bf16=drift)


def _cli_out(fn, argv):
    """(exit code, report or None, stdout lines) of a CLI main, its output
    also logged."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            report, code = fn(argv), 0
        except SystemExit as e:
            report, code = None, e.code
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"    | {line[:200]}")
    return code, report, lines


def phase_int8_files(torch, np, root: str):
    """Phase 9's file work on phase 6's tree: cli.infer --int8
    --int8_static_acts and cli.pseudo_gt --int8 --test_set with their launch
    counts; cli.parity in dir mode (a copy passes, a perturbed copy exits
    1), in golden mode with --int8 on phase 6's test set (exit code and
    verdict line agree with the report's int8 drift against --gate), and
    --full-gate on a .pth of the port's random-weight DUSt3R-224 (its
    convert and oracle stages pass, the worst layer within --oracle_tol)."""
    import glob
    import os
    import shutil

    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import parity as cli_parity
    from thermal3d_torch.cli import pseudo_gt as cli_pseudo_gt
    from thermal3d_torch.core.config import DUSTR_224_LINEAR, MASTR_512_CATMLPDPT
    from thermal3d_torch.models.dustr import frozen_model

    out = {}
    fire_dir = os.path.join(root, "fire_frames")  # phase 8's N_FIRE frames
    inf_dir = os.path.join(root, "int8_infer")
    t0 = time.perf_counter()
    gemms = int8_gemm_launches(DUSTR_224_LINEAR)
    _, launches = run_counted(lambda: cli_infer.main([
        "--img_path", fire_dir, "--output_dir", inf_dir, "--no_vis", "--batch_size",
        str(N_FIRE), "--int8", "--int8_static_acts"]), {
            "percentile_enhance": 2, "fused_rope_attention": 80,
            "fused_rope_cross_attention": 32, "rope_attention_tc": 112, "int_mm": gemms})
    depths = sorted(glob.glob(os.path.join(inf_dir, "*_depth.npy")))
    if len(depths) != N_FIRE or any(not np.isfinite(np.load(d)).all() for d in depths):
        raise AssertionError(f"cli.infer --int8 --int8_static_acts: {len(depths)} depth files")
    out["cli_infer_int8_static"] = dict(frames=N_FIRE, seconds=time.perf_counter() - t0,
                                        launches=launches)
    log(f"cli.infer --int8 --int8_static_acts: {N_FIRE} frames (calibration forward + one "
        f"batch) in {out['cli_infer_int8_static']['seconds']:.2f} s; launches {launches}")

    ts_dir = os.path.join(root, "int8_test_set")
    steps = -(-N_RGB // PAIR_BATCH)
    t0 = time.perf_counter()
    n_ts, launches = run_counted(lambda: cli_pseudo_gt.main([
        "--dataset_dir", os.path.join(root, "ds"), "--output_dir", ts_dir, "--test_set",
        "--batch_size", str(PAIR_BATCH), "--int8"]), {
            "fused_rope_attention": 48 * steps, "fused_rope_cross_attention": 24 * steps,
            "rope_attention_tc": 72 * steps, "kabsch3x3": steps,
            "int_mm": int8_gemm_launches(MASTR_512_CATMLPDPT) * steps})
    if n_ts != N_RGB:
        raise AssertionError(f"cli.pseudo_gt --int8 --test_set: {n_ts} frames")
    out["cli_pseudo_gt_int8_test_set"] = dict(frames=n_ts, seconds=time.perf_counter() - t0,
                                              launches=launches)
    log(f"cli.pseudo_gt --int8 --test_set: {n_ts} frames in "
        f"{out['cli_pseudo_gt_int8_test_set']['seconds']:.2f} s; launches {launches}")

    # cli.parity, dir mode: phase 6's cli.infer depths against a copy, then
    # against a copy with every other row of each map scaled by 1.5
    theirs = os.path.join(root, "parity_theirs")
    ours_ok, ours_bad = os.path.join(root, "parity_ours"), os.path.join(root, "parity_bad")
    for d in (theirs, ours_ok, ours_bad):
        os.makedirs(d)
    for f in sorted(glob.glob(os.path.join(root, "infer", "*_depth.npy")))[:N_PARITY_FRAMES]:
        for d in (theirs, ours_ok):
            shutil.copy(f, d)
        bad = np.load(f)
        bad[::2] *= 1.5
        np.save(os.path.join(ours_bad, os.path.basename(f)), bad)
    t0 = time.perf_counter()
    code_ok, rep_ok, _ = _cli_out(cli_parity.main, ["--ours_dir", ours_ok, "--theirs_dir", theirs])
    code_bad, _, lines_bad = _cli_out(cli_parity.main, ["--ours_dir", ours_bad, "--theirs_dir",
                                                        theirs])
    if (code_ok, code_bad) != (0, 1) or not rep_ok["dirs"]["summary"]["all_bit_equal"] or \
            lines_bad[-1] != "PARITY GATE FAILED: dir-mode AbsRel gate":
        raise AssertionError(f"cli.parity dir mode: exit {code_ok} on a copy, {code_bad} on a "
                             "perturbed copy (want 0 and 1)")
    out["parity_dir"] = dict(frames=N_PARITY_FRAMES, exit_copy=code_ok, exit_perturbed=code_bad,
                             seconds=time.perf_counter() - t0)

    # golden mode with --int8 on phase 6's cli.pseudo_gt --test_set output,
    # each depth and path file named after its thermal frame (the evaluator
    # finds a golden depth by the thermal frame's time stamp, which the
    # synthetic tree's RGB names do not carry)
    golden = os.path.join(root, "parity_golden")
    os.makedirs(golden)
    for txt in sorted(glob.glob(os.path.join(root, "test_set", "depth", "*_thermal_path.txt"))):
        thermal = open(txt).read().strip()
        base = os.path.splitext(os.path.basename(thermal))[0]
        shutil.copy(txt[:-len("_thermal_path.txt")] + "_depth.npy",
                    os.path.join(golden, f"{base}_depth.npy"))
        with open(os.path.join(golden, f"{base}_thermal_path.txt"), "w") as f:
            f.write(thermal)
    gate = 0.01
    t0 = time.perf_counter()
    rpt = os.path.join(root, "parity_golden.json")
    code, _, lines = _cli_out(cli_parity.main, [
        "--golden_dir", golden, "--int8", "--gate", str(gate), "--batch_size", str(N_RGB),
        "--report", rpt])
    rep = json.load(open(rpt))
    drift = rep["int8_abs_rel_drift"]
    want_code, want_line = ((0, "PARITY GATE PASSED") if drift <= gate
                            else (1, "PARITY GATE FAILED: int8 drift gate"))
    if code != want_code or lines[-1] != want_line:
        raise AssertionError(f"cli.parity golden --int8: exit {code}, {lines[-1]!r} with drift "
                             f"{drift} against gate {gate}")
    out["parity_golden_int8"] = dict(frames=N_RGB, exit=code, int8_abs_rel_drift=drift,
                                     abs_rel_bf16=rep["golden_bf16"]["abs_rel"],
                                     abs_rel_int8=rep["golden_int8"]["abs_rel"],
                                     seconds=time.perf_counter() - t0)

    # --full-gate on a .pth of the port's random-weight DUSt3R-224
    pth = os.path.join(root, "parity_dustr224.pth")
    model = frozen_model(DUSTR_224_LINEAR, torch.device("cuda"), seed=3)
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, pth)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rpt = os.path.join(root, "parity_full_gate.json")
    code, _, lines = _cli_out(cli_parity.main, [
        "--full-gate", "--model", pth, "--golden_dir", golden, "--batch_size", str(N_RGB),
        "--report", rpt])
    rep = json.load(open(rpt))
    stages = json.loads([ln for ln in lines if ln.startswith("{")][-1])["stages"]
    oracle = rep["full_gate_oracle"]
    log(f"cli.parity --full-gate: exit {code}, stages {stages}; oracle {json.dumps(oracle)}")
    if stages["convert"] != "pass" or stages["oracle"] != "pass" or \
            oracle["worst_rel"] > oracle["tol"]:
        raise AssertionError(f"cli.parity --full-gate: stages {stages}, oracle {oracle}")
    out["parity_full_gate"] = dict(exit=code, stages=stages, oracle=oracle,
                                   golden_abs_rel_bf16=rep["golden_bf16"].get("abs_rel"),
                                   int8_abs_rel_drift=rep.get("int8_abs_rel_drift"),
                                   seconds=time.perf_counter() - t0)
    os.remove(pth)
    return out


def phase_int8(torch, np, root: str):
    """Phase 9: the int8 product, the int8 engine, the int8 generator, the
    CLIs and the parity gate; returns their results and the phase's time."""
    t_phase = time.perf_counter()
    log("int8: the int8 product (torch._int_mm) on the card:")
    product = int8_product_cases(torch)
    engine = phase_int8_engine(torch, np)
    generator = phase_int8_generator(torch, np)
    files = phase_int8_files(torch, np, root)
    seconds = time.perf_counter() - t_phase
    log(f"int8 and parity phase: {seconds:.1f} s")
    return dict(product=product, engine=engine, generator=generator, files=files,
                seconds=seconds)


# --compare-k2k3: (K2 or K3, batch, grid side, width C, heads), the bf16
# K2/K3 calls of the serving path (DUSt3R-224) and the pseudo-GT path
# (MASt3R-512), and phase 3's at head_dims 32, 128 and 16 (HEAD_DIM_K2K3)
COMPARE_CASES = (("K2", BATCH, 14, 1024, 16), ("K2", BATCH, 14, 768, 12),
                 ("K3", BATCH, 14, 768, 12), ("K2", 2 * PAIR_BATCH, 32, 1024, 16),
                 ("K2", PAIR_BATCH, 32, 768, 12), ("K3", PAIR_BATCH, 32, 768, 12)) + HEAD_DIM_K2K3
# the float32 cases of --compare-k2k3 (this checkout's 3xTF32 kernels against
# the other checkout's build of them): COMPARE_CASES' serving and pseudo-GT
# shapes, and a tensor-parallel rank's (tp=2); those of --compare-k4k6 are
# every K4 shape of PLAIN_ATTENTION_SHAPES
COMPARE_F32_K2K3 = COMPARE_CASES + (("K2", 2 * TRAIN_BATCH, 14, 512, 8),
                                    ("K2", TRAIN_BATCH, 14, 384, 6), ("K3", TRAIN_BATCH, 14, 384, 6))


# phase 10: multi-GPU on one card. The card's machine has one H100, so every
# mesh position lies on cuda:0: single-controller serving and pseudo-GT over
# the mesh [cuda:0, cuda:0] (a batch in two chunks, one replica), cli.infer
# --ndev, cli.train over an NCCL group of world 1 with --zero1, and a 2-rank
# gloo job on cuda:0 (NCCL refuses two ranks on one card; gloo runs its
# collectives on host copies of the CUDA tensors, core/collectives.py) whose
# DP, ZeRO-1 and Megatron TP steps are held against one single-process step.
# None of it measures N-GPU scaling: that needs a machine with more cards.
MESH2 = 2
# the 2-rank training cases: DUSt3R-224 at full width, its depth cut to
# DIST_DEPTH (a third of the encoder, half the decoder: the ranks stage
# every gradient through the host), TrainConfig's batch of TRAIN_BATCH pairs
DIST_DEPTH = dict(enc_depth=8, dec_depth=4)
# (name, mesh shape, compute dtype, zero1): float32 with TF32 off holds the
# split exactly up to summation order; bf16 tensor parallelism is recorded
DIST_CASES = (("dp", (2,), "float32", False), ("zero1", (2,), "float32", True),
              ("tp", (1, 2), "float32", False), ("tp_bf16", (1, 2), "bfloat16", False))
# float32 steps against the single-process step on the global batch: the
# loss, and each gradient tensor's max|Δ|/max|ref| (scripts/
# torch_multi_gpu_limits.py reads, on the CPU: see PERF.md; the limits
# leave 10× room over those reads for cuBLAS's other summation orders)
DIST_F32_LOSS_REL = 1e-5
DIST_F32_GRAD_REL = 1e-4
DIST_TIMEOUT = 900  # seconds for the 2-rank job


def dist_model_config(dtype: str, depth: dict):
    from thermal3d_torch.core.config import DUSTR_224_LINEAR

    return dataclasses.replace(DUSTR_224_LINEAR, compute_dtype=dtype, **depth)


def dist_inputs(torch, np, out: str, depth: dict = DIST_DEPTH, batch: int = TRAIN_BATCH,
                device: str = "cpu") -> None:
    """out/depth.json, out/init.pth (seeded float32 weights of
    dist_model_config at that depth, made on `device`: a state dict that
    cli.train's --weights also reads) and out/batch.pt (chip_smoke's
    training batch of `batch` pairs), on the host."""
    import os

    from thermal3d_torch.models.dustr import trainable_model

    with open(os.path.join(out, "depth.json"), "w") as f:
        json.dump(depth, f)
    model = trainable_model(dist_model_config("float32", depth), torch.device(device), seed=0)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(out, "init.pth"))
    del model
    torch.save(train_batch(torch, np, device="cpu", b=batch), os.path.join(out, "batch.pt"))


def dist_model(torch, out: str, dev, dtype: str, mesh=None):
    """dist_model_config(dtype, out/depth.json) from out/init.pth on `dev`,
    cut to this rank's tensor-parallel share on a process mesh."""
    import os

    from thermal3d_torch.core.mesh import shard_model_
    from thermal3d_torch.models.dustr import trainable_model

    with open(os.path.join(out, "depth.json")) as f:
        depth = json.load(f)
    model = trainable_model(dist_model_config(dtype, depth), dev,
                            torch.load(os.path.join(out, "init.pth"), weights_only=True))
    if mesh is not None:
        shard_model_(model, mesh)
    return model


def dist_batch(torch, out: str, dev, mesh=None):
    """out/batch.pt on `dev` (this rank's rows on a process mesh) and its
    global number of pairs."""
    import os

    from thermal3d_torch.core.mesh import shard_batch

    batch = torch.load(os.path.join(out, "batch.pt"), weights_only=True)
    rows = int(batch["thermal1"].shape[0])
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    return {k: v.to(dev) for k, v in batch.items()}, rows


def dist_step(torch, out: str, device: str, dtype: str, mesh=None, zero1: bool = False):
    """One train step of dist_model from out/init.pth on out/batch.pt (on a
    process mesh: this rank's rows, this rank's share of the model). Returns
    the loss and grad_norm metrics, the averaged gradient the optimizer
    received (gathered to full tensors, float32, on the host), the kernels'
    launches, the attention modules' head counts, the optimizer's mu + nu
    bytes and the peak device memory."""
    from thermal3d_torch.core.config import TrainConfig
    from thermal3d_torch.core.mesh import gather_full, param_partition_spec
    from thermal3d_torch.train.state import create_train_state
    from thermal3d_torch.train.step import make_train_step

    dev = torch.device(device)
    model = dist_model(torch, out, dev, dtype, mesh)
    batch, rows = dist_batch(torch, out, dev, mesh)
    cfg = TrainConfig(batch_size=rows, zero1=zero1)
    state = create_train_state(model, cfg, steps_per_epoch=100, mesh=mesh)
    train_step = make_train_step(model, cfg, mesh=mesh)
    received = []
    inner = state.tx.step
    state.tx.step = lambda grads: (received.append([g.detach().clone() for g in grads]),
                                   inner(grads))[1]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    _, metrics = train_step(state, batch)
    launches = {c.__name__: c.launches for c in counters if c.launches}
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = {}
    for name, g in zip(names, received[0]):
        spec = param_partition_spec(name, g.dim(), mesh) if mesh is not None else ()
        grads[name] = (gather_full(name, g, spec, mesh) if "model" in spec else g).float().cpu()
    heads = sorted({m.num_heads for m in model.modules() if hasattr(m, "num_heads")})
    slot_bytes = sum(t.numel() * t.element_size() for t in state.tx.mu + state.tx.nu)
    del state.tx.step  # the wrapper's closure holds the optimizer: a cycle
    del state, train_step, model, received, batch
    gc.collect()  # nothing of this step may count in the next one's peak
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(loss=loss, grad_norm=grad_norm, grads=grads, launches=launches, heads=heads,
                slot_bytes=slot_bytes, peak_bytes=peak)


def step_errors(got: dict, ref: dict) -> dict:
    """A distributed step's loss, grad_norm and gradient errors against the
    single-process step `ref` on the same global batch."""
    return dict(loss_ref=ref["loss"], loss_rel=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_norm_rel=abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"]),
                grad_rel=grad_rel_err(got["grads"], ref["grads"]),
                slot_bytes_single=ref["slot_bytes"], peak_bytes_single=ref["peak_bytes"])


def timed_steps(torch, out: str, device: str, mesh, zero1: bool, n: int) -> dict:
    """bf16 training on this rank's rows of out/batch.pt over a process mesh
    on the card: a warm-up step, then n steps timed by CUDA events between
    barriers (steps/s; launches a step; peak memory; mu + nu bytes), then one
    step under torch.profiler: the device ms of its NCCL kernels (their
    spans, which include waiting for the other ranks), the device's busy ms
    (union of spans) and the step's wall ms."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thermal3d_torch.core.config import TrainConfig
    from thermal3d_torch.train.state import create_train_state
    from thermal3d_torch.train.step import make_train_step

    dev = torch.device(device)
    model = dist_model(torch, out, dev, "bfloat16", mesh)
    batch, rows = dist_batch(torch, out, dev, mesh)
    cfg = TrainConfig(batch_size=rows, zero1=zero1)
    state = create_train_state(model, cfg, steps_per_epoch=100, mesh=mesh)
    train_step = make_train_step(model, cfg, mesh=mesh)
    train_step(state, batch)  # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    dist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [train_step(state, batch)[1]["loss"] for _ in range(n)]
    end.record()
    end.synchronize()
    elapsed_ms = start.elapsed_time(end)
    launches = {c.__name__: c.launches // n for c in counters if c.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu().tolist()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    nccl = [s1 - s0 for s0, s1, name in spans if "nccl" in name.lower()]
    busy_ms = union_ms(spans)
    slot_bytes = sum(t.numel() * t.element_size() for t in state.tx.mu + state.tx.nu)
    del state, train_step, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=n, global_batch=rows, steps_per_s=n / (elapsed_ms / 1e3),
                step_ms=elapsed_ms / n, losses=losses, launches_per_step=launches,
                peak_bytes=peak, slot_bytes=slot_bytes,
                profiled_step=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                   idle_share=1 - busy_ms / wall_ms, nccl_ms=sum(nccl) / 1e3,
                                   nccl_kernels=len(nccl), device_events=len(spans)))


def restore_check(torch, ckpt_dir: str, device: str, mesh) -> dict:
    """Restore the newest checkpoint of a cli.train --zero1 run (the full
    bf16 DUSt3R-224) into a fresh ZeRO-1 train state on this process mesh,
    gather the state back to full tensors, and (on rank 0) hold every model
    tensor, AdamW slot and counter against the checkpoint's files with
    torch.equal."""
    import os

    import torch.distributed as dist

    from thermal3d_torch.core.config import TrainConfig
    from thermal3d_torch.core.mesh import full_state_dict
    from thermal3d_torch.models.dustr import trainable_model
    from thermal3d_torch.train.checkpoint import MODEL_FILE, OPTIMIZER_FILE, CheckpointManager
    from thermal3d_torch.train.state import create_train_state

    dev = torch.device(device)
    model = trainable_model(dist_model_config("bfloat16", {}), dev, seed=1)
    state = create_train_state(model, TrainConfig(batch_size=MD_TRAIN_BATCH, zero1=True),
                               steps_per_epoch=1, mesh=mesh)
    mgr = CheckpointManager(ckpt_dir, mesh=mesh)
    step = mgr.latest_step()
    state, meta = mgr.restore(state)
    model_sd = full_state_dict(model, mesh)
    opt = state.tx.full_state_dict()
    opt = dict(opt, mu=[t.cpu() for t in opt["mu"]], nu=[t.cpu() for t in opt["nu"]])
    mine = sum(t.numel() * t.element_size() for t in state.tx.mu + state.tx.nu)
    out = dict(step=step, epoch=meta["epoch"], train_step=state.step, slot_bytes=mine)
    if dist.get_rank() == 0:
        path = os.path.join(ckpt_dir, "last", str(step))
        want_sd = torch.load(os.path.join(path, MODEL_FILE), weights_only=True)
        want_opt = torch.load(os.path.join(path, OPTIMIZER_FILE), weights_only=True)
        unequal = [k for k in want_sd if not torch.equal(model_sd[k], want_sd[k])]
        unequal += [f"{slot}[{i}]" for slot in ("mu", "nu")
                    for i, (a, b) in enumerate(zip(opt[slot], want_opt[slot]))
                    if not torch.equal(a, b)]
        if sorted(model_sd) != sorted(want_sd) or len(opt["mu"]) != len(want_opt["mu"]) or \
                (opt["count"], state.step) != (want_opt["count"], want_opt["train_step"]):
            unequal.append("keys or counters")
        out.update(tensors=len(want_sd) + 2 * len(want_opt["mu"]), unequal=unequal)
    del state, model, model_sd, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_worker_main(argv) -> int:
    """`--dist-worker RANK WORLD PORT OUT`: one rank of the job OUT/job.json
    describes (run_dist_job). Its device is job["device"] ('cuda:0' for every
    rank on one card, 'cuda' for cuda:RANK, or 'cpu'), its backend
    job["backend"] (None: NCCL on a card, gloo on the CPU). Runs the float32
    or bf16 step of each of job["cases"] ([name, mesh shape, dtype, zero1])
    and writes OUT/<name>_<rank>.pt: rank 0 first takes the single-process
    step of each dtype on its own device (the other ranks wait in the first
    collective), then holds each case's gathered gradients against it and
    keeps only the errors. Then, on a card, timed_steps for each of job["timed"]
    (OUT/timed_<name>_<rank>.pt) and, with job["restore"] (a cli.train
    --zero1 checkpoint directory), restore_check (OUT/restore_<rank>.pt)."""
    import os

    import torch
    import torch.distributed as dist

    from thermal3d_torch.core.collectives import STAGED
    from thermal3d_torch.core.distributed import initialize_multihost
    from thermal3d_torch.core.mesh import make_mesh

    rank, world, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    with open(os.path.join(out, "job.json")) as f:
        job = json.load(f)
    device = f"cuda:{rank}" if job["device"] == "cuda" else job["device"]
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device,
                         backend=job.get("backend"))
    refs = {dtype: dist_step(torch, out, device, dtype)
            for dtype in sorted({case[2] for case in job["cases"]})} if rank == 0 else None
    for name, shape, dtype, zero1 in job["cases"]:
        before = dict(STAGED)
        mesh = make_mesh(shape, ("data", "model")[:len(shape)])
        res = dist_step(torch, out, device, dtype, mesh, zero1)
        res["staged"] = {k: STAGED[k] - before[k] for k in STAGED}
        if rank == 0:
            res.update(step_errors(res, refs[dtype]))
        res.pop("grads")
        torch.save(res, os.path.join(out, f"{name}_{rank}.pt"))
        del res
    del refs
    for name, shape, zero1 in job.get("timed", ()):
        mesh = make_mesh(shape, ("data", "model")[:len(shape)])
        res = timed_steps(torch, out, device, mesh, zero1, job["timed_steps"])
        torch.save(res, os.path.join(out, f"timed_{name}_{rank}.pt"))
    if job.get("restore"):
        res = restore_check(torch, job["restore"], device, make_mesh((world,), ("data",)))
        torch.save(res, os.path.join(out, f"restore_{rank}.pt"))
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_processes(commands, timeout: int, what: str):
    """Start each (argv, env) in a session of its own, wait for all within
    `timeout` seconds, and on a failure or the timeout kill every process
    of every session (a launcher's children too). Returns each command's
    stdout, and raises naming `what` if any exited non-zero."""
    import os
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(argv, env=env, cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, start_new_session=True)
             for argv, env in commands]
    outs, t_end = [], time.monotonic() + timeout
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: process {i} did not end within {timeout} s")
            if p.returncode != 0:
                raise AssertionError(f"{what}: process {i} exited {p.returncode}:\n"
                                     f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
    return outs


def clean_env(**extra):
    """This process's environment without torchrun's rendezvous variables,
    plus `extra`."""
    import os

    drop = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
            "LOCAL_WORLD_SIZE", "GROUP_RANK", "THERMAL3D_COORDINATOR",
            "THERMAL3D_NUM_PROCESSES", "THERMAL3D_PROCESS_ID")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_dist_job(torch, out: str, world: int, job: dict, timeout: int = DIST_TIMEOUT):
    """Write out/job.json and launch its `world` ranks (dist_worker_main, in
    subprocesses of this script); returns {case: [each rank's result]}, with
    "timed" {case: [...]} and "restore" [...] when the job asks for them."""
    import os

    with open(os.path.join(out, "job.json"), "w") as f:
        json.dump(job, f)
    port = free_port()
    code = "import sys, chip_smoke; sys.exit(chip_smoke.dist_worker_main(sys.argv[1:]))"
    run_processes([([sys.executable, "-c", code, str(r), str(world), str(port), out],
                    clean_env()) for r in range(world)], timeout, f"{world}-rank job")

    def load(name):
        return [torch.load(os.path.join(out, f"{name}_{r}.pt"), weights_only=False)
                for r in range(world)]

    res = {name: load(name) for name, *_ in job["cases"]}
    if job.get("timed"):
        res["timed"] = {name: load(f"timed_{name}") for name, *_ in job["timed"]}
    if job.get("restore"):
        res["restore"] = load("restore")
    return res


def grad_rel_err(got: dict, want: dict) -> float:
    """The largest max|Δ|/max|ref| over the gradient tensors."""
    if sorted(got) != sorted(want):
        raise AssertionError("gradient tensors differ in name")
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
               for k in want)


def dist_errors(ranks: dict, cases) -> dict:
    """Each case's loss and gradient errors against the single-process step
    of its dtype (rank 0's, step_errors), with every rank's launches, heads,
    optimizer bytes, peak memory and host-staged collectives."""
    out = {}
    for name, shape, dtype, _ in cases:
        rs = ranks[name]
        r0 = rs[0]
        out[name] = dict(
            dtype=dtype, mesh=list(shape), loss=r0["loss"],
            **{k: r0[k] for k in ("loss_ref", "loss_rel", "grad_norm_rel", "grad_rel",
                                  "slot_bytes_single", "peak_bytes_single")},
            ranks_agree=all(r["loss"] == r0["loss"] and r["grad_norm"] == r0["grad_norm"]
                            for r in rs),
            launches=[r["launches"] for r in rs], heads=r0["heads"],
            slot_bytes=[r["slot_bytes"] for r in rs], peak_bytes=[r["peak_bytes"] for r in rs],
            staged=[r["staged"] for r in rs])
    return out


def hold_dist_errors(errs: dict, cases, depth: dict, world: int, what: str) -> None:
    """The gates of a job's float32 and bf16 steps: ranks agree, launches a
    rank are one forward's K1-K3 (and the tensor-core count in bf16, the
    3xTF32 one in float32), heads
    a rank are the mesh's share, the float32 loss and gradients within
    DIST_F32_LOSS_REL / DIST_F32_GRAD_REL of the single-process step, and
    everything finite."""
    enc, dec = depth.get("enc_depth", 24), depth.get("dec_depth", 8)
    fwd = {"percentile_enhance": 2, "fused_rope_attention": enc + 2 * dec,
           "fused_rope_cross_attention": 2 * dec}
    for name, shape, dtype, zero1 in cases:
        e = errs[name]
        log(f"{what} {name} (mesh {shape}, {dtype}{', zero1' if zero1 else ''}): loss "
            f"{e['loss']:.6f} (single {e['loss_ref']:.6f}, rel {e['loss_rel']:.3e}); gradients "
            f"max|Δ|/max|ref| {e['grad_rel']:.3e}; grad_norm rel {e['grad_norm_rel']:.3e}; "
            f"heads {e['heads']}; mu+nu bytes a rank {e['slot_bytes']} (single "
            f"{e['slot_bytes_single']}); peak bytes a rank {e['peak_bytes']} (single "
            f"{e['peak_bytes_single']}); launches {e['launches'][0]}; host-staged "
            f"{e['staged'][0]}")
        want = dict(fwd)
        want["rope_attention_tc" if dtype == "bfloat16" else "rope_attention_3xtf32"] = \
            fwd["fused_rope_attention"] + fwd["fused_rope_cross_attention"]
        if not e["ranks_agree"] or e["launches"] != [want] * world:
            raise AssertionError(f"{what} {name}: ranks disagree or launches {e['launches']} "
                                 f"(want {want} on each rank)")
        if dtype == "float32" and (e["loss_rel"] > DIST_F32_LOSS_REL
                                   or e["grad_rel"] > DIST_F32_GRAD_REL):
            raise AssertionError(f"{what} {name}: the step disagrees with the single-process "
                                 f"step (loss {e['loss_rel']:.3e} > {DIST_F32_LOSS_REL:.0e} or "
                                 f"gradients {e['grad_rel']:.3e} > {DIST_F32_GRAD_REL:.0e})")
        if not math.isfinite(e["loss"]) or not math.isfinite(e["grad_rel"]):
            raise AssertionError(f"{what} {name}: non-finite loss or gradients")
        tp = shape[1] if len(shape) > 1 else 1
        if e["heads"] != [12 // tp, 16 // tp]:
            raise AssertionError(f"{what} {name}: attention heads a rank {e['heads']}")


def dist_check(torch, np, root: str):
    """The 2-rank gloo job on cuda:0 against single-process steps."""
    import os

    out = os.path.join(root, "dist")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    dist_inputs(torch, np, out)
    ranks = run_dist_job(torch, out, MESH2, dict(cases=DIST_CASES, device="cuda:0",
                                                 backend="gloo"))
    errs = dist_errors(ranks, DIST_CASES)
    hold_dist_errors(errs, DIST_CASES, DIST_DEPTH, MESH2, "2-rank gloo")
    if errs["zero1"]["slot_bytes"] != [errs["dp"]["slot_bytes"][0] // 2] * 2:
        raise AssertionError(f"ZeRO-1: mu+nu bytes a rank {errs['zero1']['slot_bytes']}, "
                             f"want half of DP's {errs['dp']['slot_bytes']}")
    errs["seconds"] = time.perf_counter() - t0
    return errs


def mesh_engine_check(torch, np):
    """DUSt3R-224 serving over the mesh [cuda:0, cuda:0] against the
    one-device engine on the same weights (phase 10)."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.core.mesh import make_mesh
    from thermal3d_torch.infer.engine import InferenceEngine

    mesh = make_mesh((MESH2,), ("data",), devices=[torch.device("cuda", 0)] * MESH2)
    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    single = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    weights = single.model.state_dict()
    meshed = InferenceEngine(cfg, state_dict=weights, params_dtype="bfloat16", mesh=mesh)
    frames = [raw_frames(np, seed) for seed in range(N_BATCHES)]
    for eng in (single, meshed):
        check_outputs(eng.infer(frames[0]), np)  # warm-up
    torch.cuda.synchronize()

    def serve(eng):
        def run():
            t0 = time.perf_counter()
            outs = [eng.infer(f) for f in frames]
            return outs, time.perf_counter() - t0
        return run

    def serve_async(eng):
        t0 = time.perf_counter()
        for f in frames:
            eng.infer_async(f)
        torch.cuda.synchronize()
        return BATCH * N_BATCHES / (time.perf_counter() - t0)

    n = N_BATCHES
    per = {"fused_rope_attention": 40, "fused_rope_cross_attention": 16, "rope_attention_tc": 56}
    fps, fps_dev, launches, outs = {}, {}, {}, {}
    for name, eng, chunks in (("single", single, 1), ("mesh", meshed, MESH2),
                              ("mesh_again", meshed, MESH2), ("single_again", single, 1)):
        want = {k: v * chunks * n for k, v in per.items()}
        want["percentile_enhance"] = chunks * n
        (out, el), launches[name] = run_counted(serve(eng), want)
        fps[name] = BATCH * n / el
        fps_dev[name] = serve_async(eng)
        outs.setdefault(name.split("_")[0], out)
    for out in outs["mesh"]:
        check_outputs(out, np)
    gold = InferenceEngine(DUSTR_224_LINEAR, state_dict=weights)  # float32, the same weights
    gold_mesh = InferenceEngine(DUSTR_224_LINEAR, state_dict=weights, mesh=mesh)
    want32 = {"percentile_enhance": MESH2, "fused_rope_attention": 40 * MESH2,
              "fused_rope_cross_attention": 16 * MESH2, "rope_attention_3xtf32": 56 * MESH2}
    f32_mesh, f32_launches = run_counted(lambda: gold_mesh.infer(frames[0]), want32)
    f32 = gold.infer(frames[0])
    f32_err = {k: rel_err(f32_mesh[k], f32[k], np) for k in f32}
    bf16_err = {k: rel_err(outs["mesh"][0][k], outs["single"][0][k], np) for k in f32}
    noise = {k: rel_err(outs["single"][0][k], f32[k], np) for k in f32}
    mesh_vs_f32 = {k: rel_err(outs["mesh"][0][k], f32[k], np) for k in f32}
    log(f"mesh engine (2 positions on cuda:0): infer() {fps['mesh']:.2f} / "
        f"{fps['mesh_again']:.2f} frames/s, infer_async {fps_dev['mesh']:.2f} / "
        f"{fps_dev['mesh_again']:.2f}; one-device engine {fps['single']:.2f} / "
        f"{fps['single_again']:.2f}, infer_async {fps_dev['single']:.2f} / "
        f"{fps_dev['single_again']:.2f} (in turns); launches {launches['mesh']}")
    log(f"  float32 mesh vs one device, max|Δ|/max|ref|: {f32_err} (limit "
        f"{F32_ENGINE_REL_LIMIT}); launches {f32_launches}")
    log(f"  bf16 mesh vs one device: {bf16_err} (limit {BF16_ENGINE_REL_LIMIT}); vs float32: "
        f"mesh {mesh_vs_f32}, one device {noise} (limit: mesh <= {BF16_NOISE_FACTOR} x one "
        f"device + 1e-3)")
    if max(f32_err.values()) > F32_ENGINE_REL_LIMIT or max(bf16_err.values()) > \
            BF16_ENGINE_REL_LIMIT or any(mesh_vs_f32[k] > BF16_NOISE_FACTOR * noise[k] + 1e-3
                                         for k in f32):
        raise AssertionError("the mesh engine disagrees with the one-device engine")
    del single, meshed, gold, gold_mesh
    torch.cuda.empty_cache()
    return dict(fps=fps, fps_device=fps_dev, launches=launches, f32_launches=f32_launches,
                f32_rel_err=f32_err, bf16_rel_err=bf16_err, bf16_mesh_vs_f32=mesh_vs_f32,
                bf16_single_vs_f32=noise, batch=BATCH, n_batches=N_BATCHES, positions=MESH2)


def mesh_generator_check(torch, np, root: str):
    """MASt3R-512 pseudo-GT over the mesh [cuda:0, cuda:0] against run_pairs
    on one device, and generate_pseudo_gt on the mesh (phase 10)."""
    import os
    import shutil

    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.core.mesh import make_mesh
    from thermal3d_torch.data.freiburg import build_rgb_pair_index
    from thermal3d_torch.pseudo_gt.generator import (OUTPUT_DIRS, PseudoGTGenerator,
                                                     decode_rgb_pairs, generate_pseudo_gt,
                                                     pad_batch)

    mesh = make_mesh((MESH2,), ("data",), devices=[torch.device("cuda", 0)] * MESH2)
    pcfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    single = PseudoGTGenerator(pcfg, params_dtype="bfloat16", seed=0)
    weights = single.model.state_dict()
    meshed = PseudoGTGenerator(pcfg, state_dict=weights, params_dtype="bfloat16", mesh=mesh)
    rgb1, rgb2 = rgb_pairs(np, 0)
    for gen in (single, meshed):
        check_pgt_outputs(gen.run_pairs(rgb1, rgb2), np)  # warm-up
    torch.cuda.synchronize()
    n = N_PAIR_BATCHES
    pps, launches, outs = {}, {}, {}
    for name, gen, chunks in (("single", single, 1), ("mesh", meshed, MESH2)):
        def run(gen=gen):
            t0 = time.perf_counter()
            out = [gen.run_pairs(rgb1, rgb2) for _ in range(n)]
            return out, time.perf_counter() - t0
        (out, el), launches[name] = run_counted(run, {
            "fused_rope_attention": 48 * chunks * n, "fused_rope_cross_attention": 24 * chunks * n,
            "rope_attention_tc": 72 * chunks * n, "kabsch3x3": chunks * n})
        pps[name] = PAIR_BATCH * n / el
        outs[name] = out[0]
    check_pgt_outputs(outs["mesh"], np)
    f32_cfg = MASTR_512_CATMLPDPT
    gold = PseudoGTGenerator(f32_cfg, state_dict=weights).run_pairs(rgb1, rgb2)
    gold_mesh = PseudoGTGenerator(f32_cfg, state_dict=weights, mesh=mesh).run_pairs(rgb1, rgb2)
    f32_err = {k: rel_err(gold_mesh[k], gold[k], np) for k in PGT_KEYS}
    noise = {k: rel_err(outs["single"][k], gold[k], np) for k in PGT_KEYS}
    mesh_vs_f32 = {k: rel_err(outs["mesh"][k], gold[k], np) for k in PGT_KEYS}
    log(f"mesh generator (2 positions on cuda:0): {pps['mesh']:.3f} pairs/s, one device "
        f"{pps['single']:.3f}; launches {launches['mesh']}")
    log(f"  float32 mesh vs one device: {f32_err} (limit {F32_ENGINE_REL_LIMIT}); bf16 vs "
        f"float32: mesh {mesh_vs_f32}, one device {noise} (limit: mesh <= "
        f"{BF16_NOISE_FACTOR} x one device + 1e-3)")
    if max(f32_err.values()) > F32_ENGINE_REL_LIMIT or any(
            mesh_vs_f32[k] > BF16_NOISE_FACTOR * noise[k] + 1e-3 for k in PGT_KEYS):
        raise AssertionError("the mesh generator disagrees with the one-device generator")

    # generate_pseudo_gt on the mesh: every file equal to the mesh's run_pairs
    pairs = build_rgb_pair_index(os.path.join(root, "ds"), frame_skip=1)
    n_steps = -(-len(pairs) // PAIR_BATCH)
    pgt_dir = os.path.join(root, "pseudo_gt_mesh")
    written, files_launches = run_counted(lambda: generate_pseudo_gt(pairs, pgt_dir, meshed), {
        "fused_rope_attention": 48 * MESH2 * n_steps,
        "fused_rope_cross_attention": 24 * MESH2 * n_steps,
        "rope_attention_tc": 72 * MESH2 * n_steps, "kabsch3x3": MESH2 * n_steps})
    for i in range(0, len(pairs), PAIR_BATCH):
        r1, r2, kept = decode_rgb_pairs(pairs[i:i + PAIR_BATCH], pcfg.img_size)
        ref = meshed.run_pairs(pad_batch(r1, PAIR_BATCH), pad_batch(r2, PAIR_BATCH))
        for j, pr in enumerate(kept):
            b1, b2 = (os.path.basename(pr[k])[:-4] for k in ("rgb_path1", "rgb_path2"))
            for d in OUTPUT_DIRS:
                name = {"depth1": b1, "depth2": b2}.get(d, f"{b1}_{b2}")
                if not np.array_equal(np.load(os.path.join(pgt_dir, d, f"{name}.npy")),
                                      ref[d][j], equal_nan=True):
                    raise AssertionError(f"mesh generate_pseudo_gt {d}/{name} differs")
    if not os.path.isdir(os.path.join(root, "pseudo_gt")):  # --only-multi-gpu: no phase 6
        shutil.copytree(pgt_dir, os.path.join(root, "pseudo_gt"))
    log(f"  mesh generate_pseudo_gt: {written} pairs, every file equal to the mesh's "
        f"run_pairs; launches {files_launches}")
    del single, meshed
    torch.cuda.empty_cache()
    return dict(pairs_per_s=pps, launches=launches, f32_rel_err=f32_err,
                bf16_mesh_vs_f32=mesh_vs_f32, bf16_single_vs_f32=noise,
                generate_pseudo_gt=dict(pairs=written, launches=files_launches))


def ndev_cli_check(torch, np, root: str):
    """cli.infer --ndev 2 on a one-card host is the parser error naming the
    device count; --ndev 1 writes the plain CLI's files, bit for bit."""
    import contextlib
    import glob
    import io
    import os
    import shutil

    from thermal3d_torch.cli import infer as cli_infer

    frames = os.path.join(root, "mg_frames")
    os.makedirs(frames, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(root, "thermal", "*.png")))
    for p in [p for i, p in enumerate(paths) if i != CORRUPT_AT][:N_FIRE]:
        shutil.copy(p, frames)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        code2, _, _ = _cli_out(cli_infer.main, ["--img_path", frames, "--no_vis", "--ndev", "2",
                                                "--output_dir", os.path.join(root, "mg_n2")])
    message = err.getvalue().strip().splitlines()[-1]
    log(f"cli.infer --ndev 2: exit {code2}, {message}")
    if code2 != 2 or not message.endswith("--ndev=2 but only 1 devices available"):
        raise AssertionError("cli.infer --ndev 2 on one card is not the parser error")
    outs = {}
    for tag, extra in (("plain", []), ("ndev1", ["--ndev", "1"])):
        outs[tag] = os.path.join(root, f"mg_{tag}")
        code, _, _ = _cli_out(cli_infer.main, ["--img_path", frames, "--no_vis", "--output_dir",
                                               outs[tag], *extra])
        if code != 0:
            raise AssertionError(f"cli.infer {extra}: exit {code}")
    files = sorted(os.listdir(outs["plain"]))
    if len(files) != N_FIRE or files != sorted(os.listdir(outs["ndev1"])) or not all(
            np.array_equal(np.load(os.path.join(outs["plain"], f)),
                           np.load(os.path.join(outs["ndev1"], f))) for f in files):
        raise AssertionError("cli.infer --ndev 1 differs from the plain CLI")
    log(f"cli.infer --ndev 1: {len(files)} depth files bit-equal to the plain CLI's")
    return dict(ndev2_exit=code2, ndev2_error=message, ndev1_files_equal=len(files))


def nccl_train_check(torch, np, root: str):
    """cli.train --mesh_shape 1 --zero1 in a subprocess launched as torchrun
    launches it (an NCCL group of world 1): 2 epochs on phase 6's tree and
    its pseudo-GT, resumed to a third, then cli.infer --weights from its
    checkpoint directory, bit-equal to an engine on the checkpoint's
    weights."""
    import os

    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.models.dustr import trainable_model

    weights = os.path.join(root, "mg_init.pth")
    model = trainable_model(dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16"),
                            torch.device("cpu"), seed=1)
    torch.save({"state_dict": {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}},
               weights)
    del model
    ckpt = os.path.join(root, "mg_ckpt")
    args = ["--dataset_dir", os.path.join(root, "ds"), "--pseudo_gt_dir",
            os.path.join(root, "pseudo_gt"), "--weights", weights, "--output_model", ckpt,
            "--max_batches", "2", "--use_thermal_aware_loss", "--multi_scale", "--frame_skip",
            "1", "--log_interval", "1", "--lr", "5e-5", "--mesh_shape", "1", "--zero1"]
    here = os.path.dirname(os.path.abspath(__file__))

    def run(extra):
        env = clean_env(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=free_port())
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "thermal3d_torch.cli.train", *args, *extra],
                             cwd=here, env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"cli.train {extra}: exit {res.returncode}\n{res.stderr[-3000:]}")
        lines = res.stdout.splitlines()
        group = [x for x in lines if "process group" in x]
        done = [x for x in lines if x.startswith("Training done: ")]
        epochs = sorted({int(json.loads(x)["epoch"]) for x in lines
                         if x.startswith("{") and "epoch" in json.loads(x)})
        summary = eval(done[0].split(": ", 1)[1], {"inf": math.inf}) if done else None
        return group, summary, epochs, time.perf_counter() - t0

    group, first, _, s1 = run(["--epochs", "2"])
    group2, resumed, epochs, s2 = run(["--epochs", "3", "--resume"])
    log(f"cli.train --mesh_shape 1 --zero1 (torchrun variables, one process): {group}; "
        f"2 epochs {first} in {s1:.1f} s; resumed {resumed} in {s2:.1f} s, epochs logged {epochs}")
    if not group or "nccl, world 1" not in group[0] or first is None or resumed is None or \
            (first["epochs_run"], first["final_step"]) != (2, 2) or \
            (resumed["epochs_run"], resumed["final_step"]) != (3, 3) or epochs != [3]:
        raise AssertionError(f"cli.train over NCCL: {group}, {first}, {resumed}, {epochs}")
    n_files = checkpoint_serves(torch, np, ckpt, os.path.join(root, "mg_frames"),
                                os.path.join(root, "mg_train_infer"))
    return dict(process_group=group[0], first=first, resumed=resumed, epochs_logged=epochs,
                seconds=[s1, s2], cli_infer_files=n_files)


def checkpoint_serves(torch, np, ckpt: str, frames: str, out_dir: str) -> int:
    """cli.infer --weights CKPT on the PNGs of `frames`: every depth file
    bit-equal to an engine on the checkpoint's weights. Returns the count."""
    import os

    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.train.checkpoint import load_params_from_checkpoint_dir

    cli_infer.main(["--img_path", frames, "--output_dir", out_dir, "--no_vis", "--weights", ckpt])
    state_dict, meta = load_params_from_checkpoint_dir(ckpt)
    eng = InferenceEngine(dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16"),
                          state_dict=state_dict)
    paths = sorted(os.path.join(frames, f) for f in os.listdir(frames))
    ref = eng.infer_paths(paths, batch_size=36, outputs=("depth",))
    for i, path in enumerate(ref["paths"]):
        got = np.load(os.path.join(out_dir, os.path.basename(path)[:-4] + "_depth.npy"))
        if not np.array_equal(got, ref["depth"][i]):
            raise AssertionError(f"cli.infer --weights {ckpt}: {path} differs from the engine")
    log(f"cli.infer --weights <its checkpoint>: {len(ref['paths'])} depth maps bit-equal to an "
        f"engine on the checkpoint's weights (epoch {meta['epoch']})")
    del eng
    torch.cuda.empty_cache()
    return len(ref["paths"])


def phase_multi_gpu(torch, np, root: str):
    """Phase 10 (see the module docstring and the comment above MESH2)."""
    from thermal3d_torch.core.collectives import STAGED

    t_phase = time.perf_counter()
    res = dict(engine=mesh_engine_check(torch, np),
               generator=mesh_generator_check(torch, np, root),
               cli_infer_ndev=ndev_cli_check(torch, np, root),
               cli_train_nccl=nccl_train_check(torch, np, root),
               gloo_2rank=dist_check(torch, np, root))
    res["staged_in_this_process"] = dict(STAGED)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"multi-GPU phase: {res['seconds']:.1f} s")
    return res


def tp_attention_cases(torch, tp: int = 2):
    """K2/K3 at the shapes a tensor-parallel rank of `tp` gives them on a
    rank's TRAIN_BATCH pairs (B): the encoder's 16/tp heads of width
    1024/tp, the decoder's 12/tp of 768/tp. tp=2 (phase 10): K2 packed
    [2B,196,1536] H8 (the encoder runs both views at once) and [B,196,1152]
    H6, K3 [B,196,384] H6; tp=4 (the multi-device phase): K2 [2B,196,768]
    H4 and [B,196,576] H3, K3 [B,196,192] H3."""
    enc, dec = (1024 // tp, 16 // tp), (768 // tp, 12 // tp)
    k2 = attention_cases(torch, cross=False, batch=2 * TRAIN_BATCH, widths=[enc])
    k2 += attention_cases(torch, cross=False, batch=TRAIN_BATCH, widths=[dec])
    k3 = attention_cases(torch, cross=True, batch=TRAIN_BATCH, widths=[dec])
    return k2, k3


def build_other(other_csrc: str, name: str):
    """Build OTHER_CSRC/<name>.cu with this checkout's nvcc flags into the
    build directory and load it."""
    from pathlib import Path

    from thermal3d_torch.kernels import _build

    lib_path = _build.BUILD_DIR / f"libother_{name}.so"
    source = Path(other_csrc) / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(source)],
                   check=True, capture_output=True, text=True)
    return _build.load(lib_path)


class ParentCudaCore:
    """The CUDA-core K2/K3 and K4-K6 kernels of a checkout from before the
    packed route (OTHER_CSRC's rope_attention.cu and attention.cu, built by
    build_other in parallel), bound here with their C signatures, since this
    checkout no longer has them. rope() launches the one-shot K2/K3 kernel where a
    head's K and V fit in shared memory (the build's own query), else its
    key-tile kernel; softmax() K4-K6 on q, k, v and out by their strides."""

    DTYPE_CODE = {"torch.float32": 0, "torch.bfloat16": 1}
    SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

    def __init__(self, other_csrc: str):
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            rope, attn = pool.map(lambda n: build_other(other_csrc, n),
                                  ("rope_attention", "attention"))
        for fn in (rope.t3d_rope_attention, rope.t3d_rope_attention_tiled):
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        rope.t3d_rope_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        rope.t3d_rope_attention_smem_bytes.restype = ctypes.c_ulonglong
        attn.t3d_attention.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p]
        attn.t3d_attention.restype = ctypes.c_int
        self.rope_lib, self.attn_lib = rope, attn

    def rope(self, q_ptr, k_ptr, v_ptr, row_stride, cos, sin, out, num_heads, scale):
        import torch

        from thermal3d_torch.kernels import _build

        b, s, c = out.shape
        d = c // num_heads
        lib = self.rope_lib
        one_shot = lib.t3d_rope_attention_smem_bytes(s, d, out.element_size()) <= self.SMEM_LIMIT
        fn = lib.t3d_rope_attention if one_shot else lib.t3d_rope_attention_tiled
        rc = fn(self.DTYPE_CODE[str(out.dtype)], q_ptr, k_ptr, v_ptr, row_stride, cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), b, s, num_heads, d, float(scale),
                torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "the parent's CUDA-core K2/K3")

    def softmax(self, q, k, v, out, scale):
        import torch

        from thermal3d_torch.kernels import _build

        b, h, sq, d = q.shape
        strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, out)
                                             for i in range(3)))
        rc = self.attn_lib.t3d_attention(
            self.DTYPE_CODE[str(q.dtype)], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, b, h, sq, k.shape[2], d, float(scale),
            torch.cuda.current_stream().cuda_stream)
        _build.check(self.attn_lib, rc, "the parent's CUDA-core K4-K6")


def compare_in_turns(torch, run, outs: dict, reps: int = 20) -> dict:
    """Two builds on the same inputs: run(which) writes outs[which] for
    "this" and "other". torch.equal, the largest difference, and both timed
    by cuda_ms in turns (other, this, this, other)."""
    run("this")
    run("other")
    torch.cuda.synchronize()
    equal = torch.equal(outs["this"], outs["other"])
    max_abs_diff = (outs["this"].float() - outs["other"].float()).abs().max().item()
    ms = in_turns(torch, {"other": lambda: run("other"), "this": lambda: run("this")}, reps)
    return dict(equal=equal, max_abs_diff=max_abs_diff, this_ms=ms["this"],
                other_ms=ms["other"])


@contextlib.contextmanager
def other_3xtf32_build(fa, lib):
    """float32 attention on another build of csrc/attention_3xtf32.cu (the
    other checkout's, by build_other): the 3xTF32 wrappers load `lib` in
    place of this checkout's library."""
    from thermal3d_torch.kernels import _build

    saved = _build._libs.get("attention_3xtf32")
    _build._libs["attention_3xtf32"] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._libs.pop("attention_3xtf32", None)
        else:
            _build._libs["attention_3xtf32"] = saved


def compare_float32(torch, fa, other_csrc: str, cases, path_runs) -> dict:
    """The float32 half of --compare-k2k3 / --compare-k4k6: each case (label,
    run) writes its output with this checkout's 3xTF32 kernels ("this") and
    with the other checkout's build of csrc/attention_3xtf32.cu
    (other_3xtf32_build), torch.equal and max|diff|, both timed in turns
    (compare_in_turns); then each path (label, fn, items, unit) timed the
    same way end to end: fn() on the card to the last kernel, items per
    second, in turns other, this, this, other."""
    fa._3xtf32_lib()  # this checkout's, built and bound
    other = build_other(other_csrc, "attention_3xtf32")
    results = []
    for label, run_case in cases:
        outs = {}

        def run(which):
            if which == "this":
                outs[which] = run_case()
            else:
                with other_3xtf32_build(fa, other):
                    outs[which] = run_case()

        r = compare_in_turns(torch, run, outs, reps=10)
        results.append(dict(case=label, dtype="float32", **r))
        log(f"float32 {label}: torch.equal {r['equal']} (max|diff| {r['max_abs_diff']:.3e}); "
            f"ms this {r['this_ms']} other {r['other_ms']}")
        del outs
    paths = []
    for label, fn, items, unit in path_runs:
        rates = {"this": [], "other": []}
        fn()  # warm-up, both builds
        with other_3xtf32_build(fa, other):
            fn()
        for which in ("other", "this", "this", "other"):
            ctx = other_3xtf32_build(fa, other) if which == "other" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rates[which].append(items / (time.perf_counter() - t0))
        paths.append(dict(path=label, unit=unit, this=rates["this"], other=rates["other"]))
        log(f"float32 {label}: {unit} this {rates['this']} other {rates['other']}")
    return dict(cases=results, paths=paths, all_equal=all(r["equal"] for r in results))


def compare_k2k3(torch, other_csrc: str) -> bool:
    """Build OTHER_CSRC/rope_attention_tc.cu with this checkout's nvcc flags
    and launch it and this checkout's build through the same wrapper on the
    same seeded inputs: torch.equal and the largest difference on each of
    COMPARE_CASES (head dims 16, 32, 64 and 128), this build's schedule, and
    both timed as in phase 3, in turns (compare_in_turns). A head_dim-64
    case on the key tiles passes where this build is within the 2^-6 of
    ATTENTION_LIMIT of the plain version (the exp2 step differs from older
    builds' expf by design), every other case where both builds are equal.
    Then float32 (compare_float32): this checkout's 3xTF32 K2/K3 against the
    other checkout's build of csrc/attention_3xtf32.cu on COMPARE_F32_K2K3,
    and the float32 engine's infer_async() frames/s and the float32
    generator's run_pairs_async() pairs/s with each. Prints one JSON line;
    returns whether every case, bf16 and float32, passed."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    libs = {"this": None, "other": fa.bind_tc_lib(build_other(other_csrc, "rope_attention_tc"))}
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

        r = compare_in_turns(torch, run, outs)
        d = c // heads
        schedule = tensor_core_schedule(torch, fa, batch, heads, s, d)
        if d == 64 and schedule == fa.KEY_TILE:  # the exp2 step: the plain version's gate
            if kind == "K2":
                plain = fa.fused_rope_attention_plain(qkv, cos, sin, heads, 1.0 / math.sqrt(d))
            else:
                plain = fa.rope_attention_plain(*qkv, cos, sin, heads, 1.0 / math.sqrt(d))
            err = (outs["this"].float() - plain.float()).abs().max().item()
            gate = dict(gate="plain", max_abs_err=err, limit=ATTENTION_LIMIT["bfloat16"],
                        passed=err <= ATTENTION_LIMIT["bfloat16"])
            del plain
        else:
            gate = dict(gate="equal", passed=r["equal"])
        results.append(dict(kernel=kind, shape=[batch, s, c], heads=heads, schedule=schedule,
                            **r, **gate))
        log(f"{kind} [{batch},{s},{c}] H={heads}: torch.equal {r['equal']} (max|diff| "
            f"{r['max_abs_diff']:.3e}); {gate}; ms this {r['this_ms']} other {r['other_ms']}")
        del qkv, outs
    all_passed = all(r["passed"] for r in results)
    f32 = compare_float32(torch, fa, other_csrc, f32_k2k3_cases(torch, fa),
                          f32_k2k3_paths(torch))
    print(json.dumps({"compare_k2k3": results, "all_passed": all_passed, "float32": f32}),
          flush=True)
    return all_passed and f32["all_equal"]


def f32_k2k3_cases(torch, fa):
    """(label, run) of COMPARE_F32_K2K3 on seeded float32 inputs."""
    from thermal3d_torch.models.rope import make_grid_positions, rope_tables

    cases = []
    for kind, batch, side, c, heads in COMPARE_F32_K2K3:
        s = side * side
        cos, sin = rope_tables(make_grid_positions(side, side, device="cuda"), c // heads)
        gen = torch.Generator(device="cuda").manual_seed(c + s)
        scale = 1.0 / math.sqrt(c // heads)
        if kind == "K2":
            qkv = torch.randn((batch, s, 3 * c), generator=gen, device="cuda")
            run = functools.partial(fa.fused_rope_attention, qkv, cos, sin, heads, scale)
        else:
            q, k, v = (torch.randn((batch, s, c), generator=gen, device="cuda") for _ in range(3))
            run = functools.partial(fa.fused_rope_cross_attention, q, k, v, cos, sin, heads, scale)
        cases.append((f"{kind} [{batch},{s},{c}] H={heads}", run))
    return cases


def f32_k2k3_paths(torch):
    """The float32 paths of --compare-k2k3: the engine's infer_async() on
    N_BATCHES batches of BATCH frames, the MASt3R-512 generator's
    run_pairs_async() on N_PAIR_BATCHES steps of PAIR_BATCH pairs, both at
    their default float32 config, full width and depth."""
    import numpy as np

    from thermal3d_torch.core.config import DUSTR_224_LINEAR, MASTR_512_CATMLPDPT
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    eng = InferenceEngine(DUSTR_224_LINEAR, seed=0)
    frames = [raw_frames(np, seed) for seed in range(N_BATCHES)]
    gen = PseudoGTGenerator(MASTR_512_CATMLPDPT, seed=0)
    pairs = [rgb_pairs(np, seed) for seed in range(N_PAIR_BATCHES)]
    return [("infer_async", lambda: [eng.infer_async(f) for f in frames], BATCH * N_BATCHES,
             "frames/s"),
            ("run_pairs_async", lambda: [gen.run_pairs_async(*p) for p in pairs],
             PAIR_BATCH * N_PAIR_BATCHES, "pairs/s")]


def compare_k4k6(torch, other_csrc: str) -> bool:
    """Build OTHER_CSRC/attention_tc.cu with this checkout's nvcc flags and
    launch it and this checkout's build through the same wrapper
    (softmax_attention_tc) on the same seeded [B,S,H,D]-view operands as
    phase 3: every bf16 K4 shape of PLAIN_ATTENTION_SHAPES and HEAD_DIM_K4
    (bshd_operands) and the size-1-axes case (size_one_operands). torch.equal and the
    largest difference on each, and both timed as in phase 3, in turns
    (compare_in_turns). Prints one JSON line; returns whether every output
    was equal. Then float32 (compare_float32): this checkout's 3xTF32 K4
    against the other checkout's build of csrc/attention_3xtf32.cu on those
    K4 shapes, and the float32 'pallas' generator's
    run_pairs_async() pairs/s with each; it returns False also where a
    float32 output differs."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")

    libs = {"this": None,
            "other": fa.bind_attention_tc_lib(build_other(other_csrc, "attention_tc"))}
    cases = [(f"[{b},{h},{sq},{d}] Sk={sk}",
              lambda b=b, h=h, sq=sq, sk=sk, d=d: bshd_operands(torch, b, h, sq, sk, d,
                                                                torch.bfloat16))
             for b, h, sq, sk, d in PLAIN_ATTENTION_SHAPES + HEAD_DIM_K4]
    cases.append((f"size-1 axes [1,2,1,64] Sk={SIZE_ONE_SK}", lambda: size_one_operands(torch)))
    results = []
    for label, operands in cases:
        q, k, v = operands()
        # out laid out as _attend lays it out for such a q: [B,S,H,D]
        outs = {w: torch.empty_like(q.transpose(1, 2).contiguous()).transpose(1, 2)
                for w in libs}
        scale = 1.0 / math.sqrt(q.shape[-1])

        def run(which):
            fa.softmax_attention_tc(q, k, v, outs[which], scale,
                                    torch.cuda.current_stream().cuda_stream, lib=libs[which])

        r = compare_in_turns(torch, run, outs, reps=10)
        results.append(dict(case=label, shape=list(q.shape), sk=k.shape[2], **r))
        log(f"K4 {label}: torch.equal {r['equal']} (max|diff| {r['max_abs_diff']:.3e}); "
            f"ms this {r['this_ms']} other {r['other_ms']}")
        del q, k, v, outs
    all_equal = all(r["equal"] for r in results)
    f32_cases = []
    for b, h, sq, sk, d in PLAIN_ATTENTION_SHAPES + HEAD_DIM_K4:
        q, k, v = bshd_operands(torch, b, h, sq, sk, d, torch.float32)
        f32_cases.append((f"K4 [{b},{h},{sq},{d}] Sk={sk}",
                          functools.partial(fa.flash_attention_pallas, q, k, v,
                                            1.0 / math.sqrt(d))))
    f32 = compare_float32(torch, fa, other_csrc, f32_cases, f32_k4k6_paths(torch))
    print(json.dumps({"compare_k4k6": results, "all_equal": all_equal, "float32": f32}),
          flush=True)
    return all_equal and f32["all_equal"]


def f32_k4k6_paths(torch):
    """The float32 path of --compare-k4k6: the MASt3R-512 generator with
    attention_impl='pallas' (RoPE on the heads, then K4), float32, full
    width and depth, run_pairs_async() on N_PAIR_BATCHES steps."""
    import numpy as np

    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    gen = PseudoGTGenerator(dataclasses.replace(MASTR_512_CATMLPDPT, attention_impl="pallas"),
                            seed=0)
    pairs = [rgb_pairs(np, seed) for seed in range(N_PAIR_BATCHES)]
    return [("run_pairs_async 'pallas'", lambda: [gen.run_pairs_async(*p) for p in pairs],
             PAIR_BATCH * N_PAIR_BATCHES, "pairs/s")]


# the multi-device phase: the port's multi-device paths on distinct cards
# (needs two cards or more; `--only-multi-card` runs it after the multi-card
# check). Serving and pseudo-GT over a 'data' mesh of N distinct cards (N = 2
# and the host's card count), each bit-equal to the same mesh laid on one
# card (same chunk sizes), with frames/s and pairs/s for 1, 2 and N cards in
# turns and each card's busy ms; the --ndev CLIs and the bench; then training
# over NCCL, one process a card, on 4 ranks (2 on a two-card host): cli.train
# under torchrun in four layouts (DP, ZeRO-1, DP×TP, TP), --multihost, a
# resume and cli.infer from the checkpoint, and a job of dist_worker_main
# that holds each layout's float32 step against the single-process step,
# times bf16 steps and restores the ZeRO-1 checkpoint.
MD_N_RGB = 41  # RGB frames of the phase's tree: 40 pairs, 32 train 2 batches of 16
MD_TRAIN_BATCH = 16  # global pairs a training step (4 a rank on DP over 4)
MD_TRAIN_STEPS = 2  # cli.train steps of its one epoch (a checkpoint is 5.5 GB a save)
MD_TIMED_STEPS = 5  # bf16 steps timed a layout
MD_CLI_BATCH = 2 * BATCH  # cli.infer / cli.evaluate --batch_size (every N divides it)
MD_BENCH_ITERS = 10
MD_TRAIN_TIMEOUT = 420  # seconds a cli.train job may take
MD_JOB_TIMEOUT = 900  # seconds the dist_worker_main job may take
MD_FULL_DEPTH = {}  # dist_model_config at DUSTR_224_LINEAR's 24 and 8 blocks
MD_PARTS = ("engine", "generator", "tp_attention", "clis", "training")


def md_layouts(world: int):
    """(name, mesh shape, zero1) of the training layouts over `world` ranks:
    DP, ZeRO-1, DP×TP (from 4 ranks) and TP over all ranks."""
    out = [("dp", (world,), False), ("zero1", (world,), True)]
    if world >= 4:
        out.append(("dp_tp", (world // 2, 2), False))
    return out + [("tp", (1, world), False)]


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def on_device(modules, device) -> bool:
    """Every parameter and buffer of `modules` lies on `device`."""
    return all(t.device == device for m in modules
               for t in (*m.parameters(), *m.buffers()))


def profile_devices(torch, fn, what: str) -> dict:
    """One warmed-up call of fn under torch.profiler: each card's busy ms
    (the union of its kernel and copy spans), its idle share of the call's
    wall time, and its device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all(torch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_dev = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_dev.setdefault(int(e.device_index), []).append((e.time_range.start,
                                                               e.time_range.end))
    cards = {}
    for dev, spans in sorted(by_dev.items()):
        busy = union_ms(spans)
        cards[f"cuda:{dev}"] = dict(busy_ms=busy, idle_share=1 - busy / wall_ms,
                                    device_events=len(spans))
    log(f"  profile ({what}): wall {wall_ms:.3f} ms; by card "
        f"{ {d: round(c['busy_ms'], 3) for d, c in cards.items()} } busy ms")
    return dict(wall_ms=wall_ms, cards=cards)


def md_in_turns(counts) -> list:
    """The device counts in turns: 1, the counts up, the counts down, 1."""
    return [1, *counts, *reversed(counts), 1]


def md_engine_check(torch, np, counts, paths) -> dict:
    """The bf16 DUSt3R-224 engine over a 'data' mesh of n distinct cards
    (n of `counts`), BATCH frames a card: infer_async and infer bit-equal to
    the mesh [cuda:0] * n, launches K1 n, K2 40n, K3 16n (tensor cores 56n)
    a batch, each replica wholly on its card; infer_paths over the mesh on
    the PNGs `paths` bit-equal to infer() on the same decoded batches; then
    infer() and infer_async() frames/s for 1 and each n in turns, and one
    profiled infer() for each."""
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.core.mesh import make_mesh
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.preprocess.io import load_thermal_images_batch

    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    single = InferenceEngine(cfg, params_dtype="bfloat16", seed=0, device="cuda:0")
    weights = single.model.state_dict()
    cuda0 = torch.device("cuda", 0)

    def engine(devices):
        return InferenceEngine(cfg, state_dict=weights, params_dtype="bfloat16",
                               mesh=make_mesh((len(devices),), ("data",), devices=devices))

    def per_batch(n, batches=1):
        return {"percentile_enhance": n * batches, "fused_rope_attention": 40 * n * batches,
                "fused_rope_cross_attention": 16 * n * batches,
                "rope_attention_tc": 56 * n * batches}

    engines, res = {1: single}, {}
    for n in counts:
        eng, one = engine([torch.device("cuda", i) for i in range(n)]), engine([cuda0] * n)
        placed = all(on_device(mods, d) for d, mods in eng._replicas.items())
        frames = np.concatenate([raw_frames(np, s) for s in range(n)])
        eng.infer(frames)  # warm-up
        sync_all(torch)
        got, launches = run_counted(
            lambda: {k: v.cpu().numpy() for k, v in eng.infer_async(frames).items()},
            per_batch(n))
        want = one.infer(frames)
        got_infer = eng.infer(frames)
        unequal = [k for k in want if not np.array_equal(got[k], want[k])]
        unequal += [f"infer {k}" for k in want if not np.array_equal(got_infer[k], want[k])]
        finite = all(np.isfinite(v).all() for v in got.values())
        log(f"mesh engine over {n} cards ({BATCH * n} frames): infer_async and infer "
            f"{'bit-equal to' if not unequal else 'DIFFER from'} the mesh [cuda:0] * {n} "
            f"({unequal}); replicas on their cards: {placed}; launches {launches}")
        if unequal or not placed or not finite:
            raise AssertionError(f"mesh engine over {n} cards: differs in {unequal}, replicas "
                                 f"placed {placed}, finite {finite}")
        # infer_paths over the mesh: the pinned stage on cuda:0, chunks copied
        # to the other cards inside run_on_mesh's threads
        ip_batch = BATCH * n
        n_batches = -(-len(paths) // ip_batch)
        full, ip_launches = run_counted(lambda: eng.infer_paths(paths, batch_size=ip_batch),
                                        per_batch(n, n_batches))
        serial = {k: [] for k in want}
        for i in range(0, len(paths), ip_batch):
            grays, _ = load_thermal_images_batch(paths[i:i + ip_batch], out_hw=(224, 224))
            real = len(grays)
            out = eng.infer(np.stack(grays + [grays[-1]] * (ip_batch - real)))
            for k in serial:
                serial[k].append(out[k][:real])
        ip_unequal = [k for k in serial if not np.array_equal(full[k], np.concatenate(serial[k]))]
        log(f"  infer_paths over {n} cards: {len(full['paths'])} of {len(paths)} frames in "
            f"batches of {ip_batch}, {'bit-equal to' if not ip_unequal else 'DIFFERS from'} "
            f"infer() on the same decoded batches ({ip_unequal}); launches {ip_launches}")
        if ip_unequal:
            raise AssertionError(f"infer_paths over {n} cards differs in {ip_unequal}")
        res[n] = dict(frames=BATCH * n, bit_equal=True, replicas_on_their_cards=placed,
                      launches=launches, infer_paths=dict(frames=len(full["paths"]),
                                                          batch=ip_batch, bit_equal=True,
                                                          launches=ip_launches))
        engines[n] = eng
        del one, full, serial
        torch.cuda.empty_cache()

    batches = {n: [np.concatenate([raw_frames(np, 10 * b + s) for s in range(n)])
                   for b in range(N_BATCHES)] for n in engines}
    fps, fps_async = {n: [] for n in engines}, {n: [] for n in engines}
    for n in md_in_turns(counts):
        eng = engines[n]
        t0 = time.perf_counter()
        for f in batches[n]:
            eng.infer(f)
        fps[n].append(BATCH * n * N_BATCHES / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for f in batches[n]:
            out = eng.infer_async(f)
        sync_all(torch)
        fps_async[n].append(BATCH * n * N_BATCHES / (time.perf_counter() - t0))
        del out
    log(f"mesh engine frames/s by cards (in turns {md_in_turns(counts)}): infer() {fps}; "
        f"infer_async() {fps_async}")
    profiles = {n: profile_devices(torch, lambda e=engines[n], f=batches[n][0]: e.infer(f),
                                   f"one infer() of {BATCH * n} frames on {n} card(s)")
                for n in engines}
    del engines, single
    sync_all(torch)
    torch.cuda.empty_cache()
    return dict(meshes=res, fps=fps, fps_async=fps_async, profiles=profiles,
                frames_a_card=BATCH, batches=N_BATCHES)


def md_generator_check(torch, np, counts) -> dict:
    """The full-depth bf16 MASt3R-512 generator over a 'data' mesh of n
    distinct cards, PAIR_BATCH pairs a card: all eight outputs of
    run_pairs_async and run_pairs bit-equal to the mesh [cuda:0] * n (the
    same chunk sizes: the bf16 generator is not bit-equal across batch
    sizes), launches K2 48n, K3 24n (tensor cores 72n) a step; then
    run_pairs() and run_pairs_async() pairs/s for 1 and each n in turns, and
    one profiled run_pairs() for each."""
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.core.mesh import make_mesh
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    pcfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    single = PseudoGTGenerator(pcfg, params_dtype="bfloat16", seed=0, device="cuda:0")
    weights = single.model.state_dict()
    cuda0 = torch.device("cuda", 0)

    def generator(devices):
        return PseudoGTGenerator(pcfg, state_dict=weights, params_dtype="bfloat16",
                                 batch_size=PAIR_BATCH * len(devices),
                                 mesh=make_mesh((len(devices),), ("data",), devices=devices))

    def pairs(n, first=0):
        parts = [rgb_pairs(np, first + s) for s in range(n)]
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(2))

    gens, res = {1: single}, {}
    for n in counts:
        gen, one = generator([torch.device("cuda", i) for i in range(n)]), generator([cuda0] * n)
        placed = all(on_device(mods, d) for d, mods in gen._replicas.items())
        rgb1, rgb2 = pairs(n)
        gen.run_pairs(rgb1, rgb2)  # warm-up
        sync_all(torch)
        got, launches = run_counted(
            lambda: {k: v.cpu().numpy() for k, v in gen.run_pairs_async(rgb1, rgb2).items()},
            {"fused_rope_attention": 48 * n, "fused_rope_cross_attention": 24 * n,
             "rope_attention_tc": 72 * n, "kabsch3x3": n})
        want = one.run_pairs(rgb1, rgb2)
        got_sync = gen.run_pairs(rgb1, rgb2)
        unequal = [k for k in want if not np.array_equal(got[k], want[k], equal_nan=True)]
        unequal += [f"run_pairs {k}" for k in want
                    if not np.array_equal(got_sync[k], want[k], equal_nan=True)]
        log(f"mesh generator over {n} cards ({PAIR_BATCH * n} pairs): run_pairs_async and "
            f"run_pairs {'bit-equal to' if not unequal else 'DIFFER from'} the mesh [cuda:0] * "
            f"{n} ({len(want)} outputs; {unequal}); replicas on their cards: {placed}; "
            f"launches {launches}")
        if unequal or not placed or len(want) != 8:
            raise AssertionError(f"mesh generator over {n} cards: differs in {unequal}, "
                                 f"replicas placed {placed}, {len(want)} outputs")
        res[n] = dict(pairs=PAIR_BATCH * n, bit_equal=True, outputs=len(want),
                      replicas_on_their_cards=placed, launches=launches)
        gens[n] = gen
        del one
        torch.cuda.empty_cache()

    inputs = {n: pairs(n, 20) for n in gens}
    pps, pps_async = {n: [] for n in gens}, {n: [] for n in gens}
    for n in md_in_turns(counts):
        gen, (rgb1, rgb2) = gens[n], inputs[n]
        t0 = time.perf_counter()
        for _ in range(N_PAIR_BATCHES):
            gen.run_pairs(rgb1, rgb2)
        pps[n].append(PAIR_BATCH * n * N_PAIR_BATCHES / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for _ in range(N_PAIR_BATCHES):
            out = gen.run_pairs_async(rgb1, rgb2)
        sync_all(torch)
        pps_async[n].append(PAIR_BATCH * n * N_PAIR_BATCHES / (time.perf_counter() - t0))
        del out
    log(f"mesh generator pairs/s by cards (in turns {md_in_turns(counts)}): run_pairs() {pps}; "
        f"run_pairs_async() {pps_async}")
    profiles = {n: profile_devices(torch, lambda g=gens[n], x=inputs[n]: g.run_pairs(*x),
                                   f"one run_pairs() of {PAIR_BATCH * n} pairs on {n} card(s)")
                for n in gens}
    del gens, single
    sync_all(torch)
    torch.cuda.empty_cache()
    return dict(meshes=res, pairs_per_s=pps, pairs_per_s_async=pps_async, profiles=profiles,
                pairs_a_card=PAIR_BATCH, steps=N_PAIR_BATCHES)


def tree_bytes(d: str) -> dict:
    """{relative path: bytes} of every file under d."""
    import os

    out = {}
    for base, _, names in os.walk(d):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return out


def md_cli_check(torch, np, counts, root: str) -> dict:
    """cli.infer, cli.evaluate and cli.pseudo_gt with --ndev n on the phase's
    tree for n = 1 and each of `counts`, and the bench with --ndev n: each
    exits 0 and launches K1-K3 n times a batch's; the cli.infer and
    cli.evaluate files of every n byte-equal to --ndev 1 at the same
    --batch_size, the cli.pseudo_gt files of --ndev n --batch_size 4n
    byte-equal to --ndev 1 --batch_size 4 (the same chunk size); frames/s of
    each CLI call (wall, model build included) and the bench's headline."""
    import os

    from thermal3d_torch import bench
    from thermal3d_torch.cli import evaluate as cli_evaluate
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import pseudo_gt as cli_pseudo_gt
    from thermal3d_torch.data.freiburg import build_rgb_pair_index

    thermal, ds = os.path.join(root, "thermal"), os.path.join(root, "ds")
    n_pairs = len(build_rgb_pair_index(ds, frame_skip=1))
    gt_dir = os.path.join(root, "gt")

    def serving(n, batches):
        return {"percentile_enhance": n * batches, "fused_rope_attention": 40 * n * batches,
                "fused_rope_cross_attention": 16 * n * batches,
                "rope_attention_tc": 56 * n * batches}

    def call(fn, argv, want):
        t0 = time.perf_counter()
        (code, report, lines), launches = run_counted(lambda: _cli_out(fn, argv), want)
        if code != 0:
            raise AssertionError(f"{argv}: exit {code}")
        return report, lines, launches, time.perf_counter() - t0

    cli_batches = -(-(N_FRAMES + 1) // MD_CLI_BATCH)
    res, files = {}, {}
    for n in (1, *counts):
        r = res[n] = {}
        inf_dir = os.path.join(root, f"md_infer_{n}")
        _, _, launches, sec = call(cli_infer.main, [
            "--img_path", thermal, "--output_dir", inf_dir, "--no_vis", "--batch_size",
            str(MD_CLI_BATCH), "--ndev", str(n)], serving(n, cli_batches))
        r["cli_infer"] = dict(launches=launches, seconds=sec, frames_per_s=N_FRAMES / sec)
        if n == 1:  # ground truth for cli.evaluate at the frames' size
            os.makedirs(gt_dir)
            rng = np.random.default_rng(13)
            for name in sorted(os.listdir(inf_dir)):
                gt = rng.uniform(0.5, 5.0, FRAME_HW).astype(np.float32)
                gt[:40] = 0.0
                np.save(os.path.join(gt_dir, name), gt)
        ev_dir = os.path.join(root, f"md_eval_{n}")
        summary, _, launches, sec = call(cli_evaluate.main, [
            "--thermal_dir", thermal, "--pseudo_gt_dir", gt_dir, "--output_dir", ev_dir,
            "--no_vis", "--batch_size", str(MD_CLI_BATCH), "--ndev", str(n)],
            serving(n, cli_batches))
        r["cli_evaluate"] = dict(launches=launches, seconds=sec, frames_per_s=N_FRAMES / sec,
                                 n_images=summary["n_images"])
        pgt_dir = os.path.join(root, f"md_pseudo_gt_{n}")
        steps = -(-n_pairs // (PAIR_BATCH * n))
        _, _, launches, sec = call(cli_pseudo_gt.main, [
            "--dataset_dir", ds, "--output_dir", pgt_dir, "--frame_skip", "1",
            "--batch_size", str(PAIR_BATCH * n), "--ndev", str(n)],
            {"fused_rope_attention": 48 * n * steps, "fused_rope_cross_attention": 24 * n * steps,
             "rope_attention_tc": 72 * n * steps, "kabsch3x3": n * steps})
        r["cli_pseudo_gt"] = dict(batch_size=PAIR_BATCH * n, launches=launches, seconds=sec,
                                  pairs_per_s=n_pairs / sec)
        bench_steps = 1 + 2 * MD_BENCH_ITERS
        _, lines, launches, sec = call(bench.main, [
            "--ndev", str(n), "--no_secondary", "--iters", str(MD_BENCH_ITERS)],
            serving(n, bench_steps))
        line = json.loads(next(x for x in lines if x.startswith("{")))
        r["bench"] = dict(metric=line["metric"], frames_per_s=line["value"],
                          per_card=line.get("per_chip", line["value"]), batch=line["batch"],
                          step_ms=line["step_ms"], launches=launches)
        got = {k: tree_bytes(d) for k, d in (("cli_infer", inf_dir), ("cli_evaluate", ev_dir),
                                             ("cli_pseudo_gt", pgt_dir))}
        if n == 1:
            files = got
            if len(got["cli_infer"]) != N_FRAMES or summary["n_images"] != N_FRAMES or \
                    len(got["cli_pseudo_gt"]) != 8 * n_pairs:
                raise AssertionError(f"--ndev 1: {len(got['cli_infer'])} depth files, "
                                     f"{summary['n_images']} evaluated, "
                                     f"{len(got['cli_pseudo_gt'])} pseudo-GT files")
        unequal = {k: sorted(set(files[k]) ^ set(v)) + [f for f in v if files[k].get(f) != v[f]]
                   for k, v in got.items()}
        r["files"] = {k: len(v) for k, v in got.items()}
        r["byte_equal_to_ndev1"] = not any(unequal.values())
        log(f"--ndev {n}: cli.infer {r['cli_infer']}, cli.evaluate {r['cli_evaluate']}, "
            f"cli.pseudo_gt {r['cli_pseudo_gt']}, bench {r['bench']}; files {r['files']} "
            f"byte-equal to --ndev 1: {r['byte_equal_to_ndev1']}")
        if any(unequal.values()):
            raise AssertionError(f"--ndev {n}: files differ from --ndev 1: "
                                 f"{ {k: v[:5] for k, v in unequal.items()} }")
    return dict(by_ndev=res, cli_batch=MD_CLI_BATCH, frames=N_FRAMES, pairs=n_pairs)


def train_log(stdout: str) -> dict:
    """The coordinator's cli.train output: its process-group line, each
    step's batch_loss, the epochs logged and the final summary."""
    lines = stdout.splitlines()
    metrics = [json.loads(x) for x in lines if x.startswith("{")]
    done = [x for x in lines if x.startswith("Training done: ")]
    return dict(group=[x for x in lines if "process group" in x],
                losses=[m["batch_loss"] for m in metrics if "batch_loss" in m],
                epochs=sorted({int(m["epoch"]) for m in metrics if "epoch" in m}),
                summary=eval(done[0].split(": ", 1)[1], {"inf": math.inf}) if done else None)


def timed_summary(rs, shape, name: str) -> dict:
    """timed_steps' results of every rank of a job, held: launches a step
    K1 2, K2 40, K3 16 (tensor cores 56) on every rank, finite losses."""
    t = dict(mesh=list(shape), steps_per_s=rs[0]["steps_per_s"], step_ms=rs[0]["step_ms"],
             global_batch=rs[0]["global_batch"], losses=rs[0]["losses"],
             launches_per_step=[r["launches_per_step"] for r in rs],
             peak_bytes=[r["peak_bytes"] for r in rs], slot_bytes=[r["slot_bytes"] for r in rs],
             nccl_ms=[r["profiled_step"]["nccl_ms"] for r in rs],
             profiled_step=[r["profiled_step"] for r in rs])
    want = {"percentile_enhance": 2, "fused_rope_attention": 40,
            "fused_rope_cross_attention": 16, "rope_attention_tc": 56}
    log(f"{len(rs)}-rank NCCL bf16 {name} (mesh {tuple(shape)}): {t['steps_per_s']:.3f} "
        f"steps/s ({t['step_ms']:.2f} ms a step of {t['global_batch']} pairs); peak GB a rank "
        f"{[round(b / 1e9, 3) for b in t['peak_bytes']]}; mu+nu GB a rank "
        f"{[round(b / 1e9, 3) for b in t['slot_bytes']]}; NCCL ms a step "
        f"{[round(x, 3) for x in t['nccl_ms']]}; launches a step {t['launches_per_step'][0]}")
    if t["launches_per_step"] != [want] * len(rs) or not all(
            math.isfinite(x) for x in t["losses"]):
        raise AssertionError(f"timed bf16 {name} over {len(rs)} ranks: {t}")
    return t


def md_train_check(torch, np, world: int, root: str) -> dict:
    """Training over NCCL, one process a card, `world` ranks: cli.train under
    torchrun in each md_layouts layout (bf16, one epoch of MD_TRAIN_STEPS
    steps of MD_TRAIN_BATCH pairs: the loss falls; one 5.5 GB checkpoint a
    run keeps the phase's disk writes near 37 GB); the
    ZeRO-1 layout again with --multihost (its losses equal to torchrun's); a
    dist_worker_main job (each layout's float32 step at full width and depth
    on a global batch of MD_TRAIN_BATCH against the single-process step,
    bf16 steps timed and profiled, the ZeRO-1 checkpoint restored
    bit-equal), then the bf16 DP steps timed again on 1 and 2 cards; the
    ZeRO-1 run resumed to a second epoch; cli.infer from its checkpoint."""
    import os

    from thermal3d_torch.cli import pseudo_gt as cli_pseudo_gt

    out = os.path.join(root, "md_train")
    os.makedirs(out)
    t0 = time.perf_counter()
    pgt = os.path.join(root, "md_pseudo_gt_1")
    if not os.path.isdir(pgt):  # the clis part did not run: the same files
        code, _, _ = _cli_out(cli_pseudo_gt.main, [
            "--dataset_dir", os.path.join(root, "ds"), "--output_dir", pgt, "--frame_skip", "1",
            "--batch_size", str(PAIR_BATCH)])
        if code != 0:
            raise AssertionError(f"cli.pseudo_gt for the training tree: exit {code}")
    dist_inputs(torch, np, out, MD_FULL_DEPTH, MD_TRAIN_BATCH, device="cuda")
    weights = os.path.join(out, "init.pth")
    base = ["--dataset_dir", os.path.join(root, "ds"), "--pseudo_gt_dir", pgt,
            "--weights", weights, "--batch_size",
            str(MD_TRAIN_BATCH), "--use_thermal_aware_loss", "--multi_scale", "--frame_skip", "1",
            "--log_interval", "1", "--lr", "5e-5"]

    def layout_args(shape, zero1):
        return ["--mesh_shape", *map(str, shape), *(["--zero1"] if zero1 else [])]

    def torchrun(args, what):
        argv = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
                "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
                "-m", "thermal3d_torch.cli.train", *args]
        t1 = time.perf_counter()
        (stdout,) = run_processes([(argv, clean_env())], MD_TRAIN_TIMEOUT, what)
        return dict(train_log(stdout), seconds=time.perf_counter() - t1)

    runs = {}
    ckpt = {name: os.path.join(root, f"md_ckpt_{name}") for name, *_ in md_layouts(world)}
    for name, shape, zero1 in md_layouts(world):
        r = runs[name] = torchrun([*base, "--output_model", ckpt[name], "--epochs", "1",
                                   *layout_args(shape, zero1)], f"torchrun cli.train {name}")
        ok = (r["group"] and f"nccl, world {world}" in r["group"][0] and r["summary"]
              and (r["summary"]["epochs_run"], r["summary"]["final_step"])
              == (1, MD_TRAIN_STEPS) and len(r["losses"]) == MD_TRAIN_STEPS
              and all(math.isfinite(x) for x in r["losses"]) and r["losses"][-1] < r["losses"][0])
        log(f"torchrun --nproc_per_node {world} cli.train {name} (mesh {shape}): {r['group']}; "
            f"losses {r['losses']}; {r['summary']}; {r['seconds']:.1f} s")
        if not ok:
            raise AssertionError(f"cli.train {name}: {r}")

    # the ZeRO-1 run again, one launch a process with --multihost
    port = free_port()
    zero1_shape = next(s for n, s, _ in md_layouts(world) if n == "zero1")
    args = [*base, "--output_model", os.path.join(root, "md_ckpt_multihost"), "--epochs", "1",
            *layout_args(zero1_shape, True), "--multihost",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world)]
    t1 = time.perf_counter()
    outs = run_processes([([sys.executable, "-m", "thermal3d_torch.cli.train", *args,
                            "--process_id", str(r)], clean_env()) for r in range(world)],
                         MD_TRAIN_TIMEOUT, "cli.train --multihost")
    mh = dict(train_log(outs[0]), seconds=time.perf_counter() - t1)
    log(f"cli.train --multihost x {world} (zero1): {mh['group']}; losses {mh['losses']}; "
        f"torchrun's {runs['zero1']['losses']}; {mh['seconds']:.1f} s")
    if mh["losses"] != runs["zero1"]["losses"] or mh["summary"] != runs["zero1"]["summary"] \
            or any(train_log(o)["losses"] for o in outs[1:]):
        raise AssertionError(f"--multihost differs from torchrun: {mh} vs {runs['zero1']}")

    # float32 steps against the single-process step, timed bf16 steps, and
    # the ZeRO-1 checkpoint restored, in one job of one process a card
    cases = [(name, shape, "float32", zero1) for name, shape, zero1 in md_layouts(world)]
    t1 = time.perf_counter()
    ranks = run_dist_job(torch, out, world, dict(
        cases=cases, device="cuda", backend=None, timed=md_layouts(world),
        timed_steps=MD_TIMED_STEPS, restore=ckpt["zero1"]), timeout=MD_JOB_TIMEOUT)
    errs = dist_errors(ranks, cases)
    hold_dist_errors(errs, cases, MD_FULL_DEPTH, world, f"{world}-rank NCCL")
    dp_bytes = errs["dp"]["slot_bytes"][0]
    z1_bytes = errs["zero1"]["slot_bytes"]
    if not all(dp_bytes / world <= b < 1.01 * dp_bytes / world for b in z1_bytes):
        raise AssertionError(f"ZeRO-1 over {world}: mu+nu bytes a rank {z1_bytes}, want about "
                             f"1/{world} of DP's {dp_bytes}")
    timed = {name: timed_summary(ranks["timed"][name], shape, name)
             for name, shape, _ in md_layouts(world)}
    # DP over fewer cards on the same global batch, in this call: steps/s
    # against the card count
    scaling = {world: timed["dp"]}
    for w in (1, 2):
        if w < world:
            job = run_dist_job(torch, out, w, dict(
                cases=[], device="cuda", backend=None, timed=[("dp", (w,), False)],
                timed_steps=MD_TIMED_STEPS), timeout=MD_JOB_TIMEOUT)
            scaling[w] = timed_summary(job["timed"]["dp"], (w,), "dp")
    restored = ranks["restore"]
    log(f"ZeRO-1 checkpoint (step {restored[0]['step']}) restored over {world} ranks: "
        f"{restored[0]['tensors']} tensors, unequal {restored[0]['unequal']}")
    if restored[0]["unequal"]:
        raise AssertionError(f"the restored ZeRO-1 state differs from the checkpoint: "
                             f"{restored[0]['unequal'][:10]}")
    job_s = time.perf_counter() - t1

    # the ZeRO-1 run resumed to one more epoch, then served from its checkpoint
    resumed = torchrun([*base, "--output_model", ckpt["zero1"], "--epochs", "2", "--resume",
                        *layout_args(zero1_shape, True)], "torchrun cli.train --resume")
    log(f"cli.train --resume (zero1, {world} ranks): {resumed['summary']}, epochs logged "
        f"{resumed['epochs']}, losses {resumed['losses']}; {resumed['seconds']:.1f} s")
    if resumed["summary"] is None or (resumed["summary"]["epochs_run"],
                                      resumed["summary"]["final_step"]) != \
            (2, 2 * MD_TRAIN_STEPS) or resumed["epochs"] != [2]:
        raise AssertionError(f"cli.train --resume: {resumed}")
    frames = os.path.join(root, "md_frames")
    os.makedirs(frames)
    for p in sorted(os.listdir(os.path.join(root, "thermal")))[:N_FIRE]:  # < CORRUPT_AT
        os.link(os.path.join(root, "thermal", p), os.path.join(frames, p))
    served = checkpoint_serves(torch, np, ckpt["zero1"], frames,
                               os.path.join(root, "md_ckpt_infer"))
    return dict(world=world, global_batch=MD_TRAIN_BATCH, cli_train=runs, multihost=mh,
                float32_vs_single=errs, timed_bf16=timed, dp_steps_by_cards=scaling,
                restore=dict(restored[0], bit_equal=True), resumed=resumed,
                cli_infer_from_checkpoint=served, job_seconds=job_s,
                seconds=time.perf_counter() - t0)


def phase_multi_device(torch, np, root: str, parts=MD_PARTS) -> dict:
    """The multi-device phase (see the comment above MD_N_RGB): on a host of
    one card it does not run and says why. Each part of `parts` (MD_PARTS by
    default) runs even when an earlier one failed, and the phase then raises
    naming each failure."""
    import os
    import traceback

    cards = torch.cuda.device_count()
    if cards < 2:
        reason = (f"{cards} card on this host: the phase runs the port's multi-device paths "
                  "on distinct cards, so it needs two")
        log(f"multi-device phase: not run ({reason})")
        return dict(ran=False, cards=cards, reason=reason)
    t0 = time.perf_counter()
    counts = sorted({2, cards})
    world = 4 if cards >= 4 else 2
    md_root = os.path.join(root, "md")
    paths = write_tree(np, md_root, n_rgb=MD_N_RGB)
    log(f"multi-device phase on {cards} cards: serving and pseudo-GT over {counts} cards, "
        f"training over {world} ranks")
    res, failed = dict(ran=True, cards=cards, counts=counts), {}
    parts_run = (("engine", lambda: md_engine_check(torch, np, counts, paths)),
             ("generator", lambda: md_generator_check(torch, np, counts)),
             ("tp_attention", lambda: dict(zip(("k2", "k3"), tp_attention_cases(torch, world)))),
             ("clis", lambda: md_cli_check(torch, np, counts, md_root)),
             ("training", lambda: md_train_check(torch, np, world, md_root)))
    for name, run in (p for p in parts_run if p[0] in parts):
        t1 = time.perf_counter()
        try:
            res[name] = run()
        except Exception as e:  # noqa: BLE001  (every part runs; the phase raises below)
            failed[name] = f"{type(e).__name__}: {e}"
            log(f"multi-device {name}: FAILED\n{traceback.format_exc()}")
        log(f"multi-device {name}: {time.perf_counter() - t1:.1f} s")
        sync_all(torch)
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"multi-device phase: {res['seconds']:.1f} s")
    if failed:
        raise AssertionError(f"multi-device phase: {len(failed)} part(s) failed: {failed}")
    return res


# phase 11: the serving artifact (thermal3d_torch/infer/export.py, cli/export.py)
# on the card. The native DUSt3R-224 artifact of the phase-4 seed's weights is
# exported by cli.export in a subprocess, then loaded and served in a fresh
# process that cannot import the port's models, engine, converters or
# preprocessing; K1-K3 run there as the ops of kernels/ops.py.
EXPORT_BATCH_SIZES = (32, 1)
EXPORT_SERVE_BATCHES = ((0, BATCH), (1, BATCH), (2, 5))  # (frame seed, frames): 5 pads to 32
EXPORT_BLOCKED = ("thermal3d_torch.models", "thermal3d_torch.infer.engine",
                  "thermal3d_torch.convert", "thermal3d_torch.preprocess")
EXPORT_MASTR_DEPTH = dict(enc_depth=2, dec_depth=2)
EXPORT_MASTR_HW = (512, 640)  # raw Freiburg frames, resized to 512² inside the program
EXPORT_SOFTMAX_SHAPE = (8, 16, 1024, 64)
EXPORT_TIMEOUT = 600

# the artifact's serving process: loads with the model code blocked, serves
# each batch with the counts set to 0 just before it, writes the outputs
EXPORT_SERVE_CODE = r"""
import json, sys, time

BLOCKED = tuple(json.loads(sys.argv[1]))

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.startswith(BLOCKED) or name.split(".")[0] in ("jax", "thermal3d"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from thermal3d_torch.infer.export import ServingArtifact
t0 = time.perf_counter()
art = ServingArtifact.load(sys.argv[2])
load_s = time.perf_counter() - t0
import importlib
fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
from thermal3d_torch.kernels.image_ops import percentile_enhance
counters = (percentile_enhance, fa.fused_rope_attention, fa.fused_rope_cross_attention,
            fa.flash_attention_pallas, fa.flash_attention_grouped, fa.flash_attention_multihead,
            fa.rope_attention_tc, fa.softmax_attention_tc)
frames = np.load(sys.argv[3])
batches = []
for i, name in enumerate(sorted(frames.files)):
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = art.infer(frames[name])
    seconds = time.perf_counter() - t0
    batches.append(dict(frames=int(frames[name].shape[0]), seconds=seconds,
                        launches={c.__name__: c.launches for c in counters if c.launches}))
    np.savez(sys.argv[4] + f"_{i}.npz", **out)
blocked = [m for m in sys.modules if m.startswith(BLOCKED) or m.split(".")[0] == "jax"]
print(json.dumps(dict(load_s=load_s, batches=batches, blocked_imported=blocked)))
"""


def export_weights(torch, root: str):
    """Phase 4's bf16 DUSt3R-224 weights (seed 0) as a .pth and the bf16
    engine on them, as cli.export builds it."""
    import os

    from thermal3d_torch.convert.from_pth import load_pth
    from thermal3d_torch.core.config import DUSTR_224_LINEAR
    from thermal3d_torch.infer.engine import InferenceEngine

    cfg = dataclasses.replace(DUSTR_224_LINEAR, compute_dtype="bfloat16")
    seeded = InferenceEngine(cfg, params_dtype="bfloat16", seed=0)
    pth = os.path.join(root, "dustr224_seed0.pth")
    torch.save({k: v.cpu() for k, v in seeded.model.state_dict().items()}, pth)
    del seeded
    state, _ = load_pth(pth, cfg)
    return cfg, state, pth


def export_native_check(torch, np, root: str, cfg, state, pth):
    """cli.export --platforms native in a subprocess, the artifact served in
    a process without the model code (counts a batch: K1 1, K2 40, K3 16,
    tensor-core K2 + K3), its outputs against the in-process engine (the
    engine's plain-twin gate; predicted bit-equal), and frames/s of
    ServingArtifact.infer beside engine.infer in turns in this process."""
    import os

    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.infer.export import ServingArtifact

    here = os.path.dirname(os.path.abspath(__file__))
    art_path = os.path.join(root, "dustr224_native.npz")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "thermal3d_torch.cli.export", "--weights", pth,
                          "--out", art_path, "--platforms", "native", "--params_dtype",
                          "bfloat16", "--batch_sizes", *map(str, EXPORT_BATCH_SIZES),
                          "--input_hw", *map(str, RAW_HW)],
                         cwd=here, capture_output=True, text=True, timeout=EXPORT_TIMEOUT)
    cli_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"cli.export failed ({res.returncode}):\n{res.stderr[-4000:]}")
    log(f"export: {res.stdout.strip()} ({cli_s:.1f} s with the process)")
    with np.load(art_path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        weight_bytes = sum(z[f"w_{i:05d}"].nbytes for i in range(meta["num_weights"]))
        program_bytes = {b: int(z[f"program_{b}"].nbytes) for b in meta["batch_sizes"]}
    if meta["portable_program"] or meta["platforms"] != ["cuda"]:
        raise AssertionError(f"cli.export --platforms native wrote {meta['platforms']}, "
                             f"portable {meta['portable_program']}")

    frames = {f"b{i}": raw_frames(np, seed)[:n] for i, (seed, n) in
              enumerate(EXPORT_SERVE_BATCHES)}
    frames_path = os.path.join(root, "export_frames.npz")
    np.savez(frames_path, **frames)
    out_prefix = os.path.join(root, "export_out")
    res = subprocess.run([sys.executable, "-c", EXPORT_SERVE_CODE, json.dumps(EXPORT_BLOCKED),
                          art_path, frames_path, out_prefix], cwd=here, capture_output=True,
                         text=True, timeout=EXPORT_TIMEOUT)
    if res.returncode != 0:
        raise RuntimeError(f"serving the artifact failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    served = json.loads(res.stdout.strip().splitlines()[-1])
    want = {"percentile_enhance": 1, "fused_rope_attention": 40,
            "fused_rope_cross_attention": 16, "rope_attention_tc": 56}
    for b in served["batches"]:
        if b["launches"] != want:
            raise AssertionError(f"the artifact did not run through K1-K3 as ops: a batch of "
                                 f"{b['frames']} launched {b['launches']}, want {want}")
    if served["blocked_imported"]:
        raise AssertionError(f"the artifact's process imported {served['blocked_imported']}")
    log(f"export: served in a process without the model code, load {served['load_s']:.1f} s, "
        f"launches a batch {want}")

    engine = InferenceEngine(cfg, state_dict=state, params_dtype="bfloat16")
    errs, max_abs = {}, {}
    for i, name in enumerate(sorted(frames)):
        ref = engine.infer(frames[name])
        with np.load(f"{out_prefix}_{i}.npz") as got:
            for k in ref:
                if got[k].shape != ref[k].shape:
                    raise AssertionError(f"artifact {k}: shape {got[k].shape}, engine "
                                         f"{ref[k].shape}")
                errs[k] = max(errs.get(k, 0.0), rel_err(got[k], ref[k], np))
                max_abs[k] = max(max_abs.get(k, 0.0),
                                 float(np.max(np.abs(got[k].astype(np.float64) - ref[k]))))
    log(f"export: native artifact vs engine, max|Δ|/max|ref| {errs}, max|Δ| {max_abs} "
        f"(limit {BF16_ENGINE_REL_LIMIT}; predicted 0)")
    if max(errs.values()) > BF16_ENGINE_REL_LIMIT:
        raise AssertionError(f"the native artifact disagrees with the engine: {errs}")

    art = ServingArtifact.load(art_path)
    batch = frames["b0"]
    art.infer(batch)  # warm
    fps = {"artifact": [], "engine": []}
    for which in ("artifact", "engine", "engine", "artifact"):
        fn = art.infer if which == "artifact" else engine.infer
        t0 = time.perf_counter()
        for _ in range(3):
            fn(batch)
        fps[which].append(3 * BATCH / (time.perf_counter() - t0))
    log(f"export: infer() frames/s, in turns: artifact {fps['artifact']}, engine "
        f"{fps['engine']}")
    del art, engine
    return dict(cli_seconds_with_process=cli_s, export_seconds=meta["export_seconds"],
                load_seconds=served["load_s"], artifact_bytes=os.path.getsize(art_path),
                weight_bytes=weight_bytes, program_bytes=program_bytes,
                served_batches=served["batches"], rel_err=errs, max_abs_err=max_abs,
                infer_fps_in_turns=fps)


def export_portable_check(torch, np, root: str, cfg, state):
    """The portable program exported on the CPU (sort enhance, plain
    attention, no op), loaded on the card, against the engine's plain twin
    there (attention_impl='torch', enhance_impl='sort'); no kernel launches."""
    import os

    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.infer.export import ServingArtifact, save_serving_artifact

    path = os.path.join(root, "dustr224_portable.npz")
    cpu_engine = InferenceEngine(cfg, state_dict=state, params_dtype="bfloat16", device="cpu")
    meta = save_serving_artifact(path, cpu_engine, batch_sizes=(BATCH,), input_hw=RAW_HW)
    del cpu_engine
    t0 = time.perf_counter()
    art = ServingArtifact.load(path, device="cuda")
    load_s = time.perf_counter() - t0
    twin = InferenceEngine(dataclasses.replace(cfg, attention_impl="torch"), state_dict=state,
                           params_dtype="bfloat16", enhance_impl="sort")
    frames = raw_frames(np, 0)
    got, launches = run_counted(lambda: art.infer(frames), {})
    ref = twin.infer(frames)
    errs = {k: rel_err(got[k], ref[k], np) for k in ref}
    log(f"export: portable artifact (exported on the CPU) on the card vs the plain twin, "
        f"max|Δ|/max|ref| {errs} (limit {BF16_ENGINE_REL_LIMIT}); launches {launches}")
    if max(errs.values()) > BF16_ENGINE_REL_LIMIT:
        raise AssertionError(f"the portable artifact disagrees with the plain twin: {errs}")
    del art, twin
    return dict(export_seconds=meta["export_seconds"], load_seconds=load_s, rel_err=errs,
                launches=launches)


def export_mastr_check(torch, np, root: str):
    """MASt3R-512 at EXPORT_MASTR_DEPTH, native and stereo, on 4 pairs of raw
    frames: K2/K3 at S=1024 as ops (K1 2, K2 enc + 2·dec, K3 2·dec a call),
    against an engine on the generator's model and weights."""
    import os

    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.infer.engine import InferenceEngine
    from thermal3d_torch.infer.export import ServingArtifact, save_serving_artifact
    from thermal3d_torch.pseudo_gt.generator import PseudoGTGenerator

    cfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16", **EXPORT_MASTR_DEPTH)
    gen = PseudoGTGenerator(cfg, batch_size=PAIR_BATCH, params_dtype="bfloat16")
    engine = InferenceEngine(cfg, state_dict=gen.model.state_dict(), params_dtype="bfloat16")
    del gen
    path = os.path.join(root, "mastr512_native.npz")
    meta = save_serving_artifact(path, engine, batch_sizes=(PAIR_BATCH,),
                                 input_hw=EXPORT_MASTR_HW, platforms=None, stereo=True)
    art = ServingArtifact.load(path)
    rng = np.random.default_rng(11)
    raw1, raw2 = ((21000.0 + 5000.0 * rng.uniform(size=(PAIR_BATCH, *EXPORT_MASTR_HW)))
                  / 65535.0 for _ in range(2))
    raw1, raw2 = raw1.astype(np.float32), raw2.astype(np.float32)
    enc, dec = cfg.enc_depth, cfg.dec_depth
    want = {"percentile_enhance": 2, "fused_rope_attention": enc + 2 * dec,
            "fused_rope_cross_attention": 2 * dec, "rope_attention_tc": enc + 4 * dec}
    got, launches = run_counted(lambda: art.infer(raw1, raw2), want)
    ref = engine.infer(raw1, raw2)
    errs = {k: rel_err(got[k], ref[k], np) for k in ref}
    log(f"export: MASt3R-512 (depth {enc}/{dec}) stereo artifact vs the engine on the "
        f"generator's weights, max|Δ|/max|ref| {errs} (limit {BF16_ENGINE_REL_LIMIT}); "
        f"launches {launches}")
    if max(errs.values()) > BF16_ENGINE_REL_LIMIT:
        raise AssertionError(f"the MASt3R-512 artifact disagrees with the engine: {errs}")
    del art, engine
    return dict(export_seconds=meta["export_seconds"], rel_err=errs, launches=launches,
                depth=EXPORT_MASTR_DEPTH, pairs=PAIR_BATCH, raw_hw=list(EXPORT_MASTR_HW))


def export_softmax_op_check(torch):
    """thermal3d_torch::softmax_attention for each K4-K6 entry, bf16 at
    EXPORT_SOFTMAX_SHAPE, torch.equal to the entry's wrapper."""
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    from thermal3d_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(EXPORT_SOFTMAX_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(EXPORT_SOFTMAX_SHAPE[-1])
    equal = {}
    for entry in ops.SOFTMAX_ENTRIES:
        equal[entry] = bool(torch.equal(ops.softmax_attention(q, k, v, scale, entry),
                                        getattr(fa, entry)(q, k, v, scale)))
    log(f"export: softmax_attention op == wrapper at {list(EXPORT_SOFTMAX_SHAPE)} bf16: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"the softmax_attention op differs from its wrapper: {equal}")
    return equal


def phase_export(torch, np, root: str):
    """Phase 11 (see the module docstring); returns its results and seconds."""
    t_phase = time.perf_counter()
    cfg, state, pth = export_weights(torch, root)
    res = dict(native=export_native_check(torch, np, root, cfg, state, pth))
    res["portable"] = export_portable_check(torch, np, root, cfg, state)
    del state
    gc.collect()
    res["mastr512"] = export_mastr_check(torch, np, root)
    res["softmax_op_equal"] = export_softmax_op_check(torch)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"export phase: {res['seconds']:.1f} s")
    return res


# phase 12: the workflow wrappers scripts/torch_run_*.sh, run with bash from
# the repository's root as users run them, on phase 6's Freiburg tree. Their
# `python` is WRAPPER_LAUNCHER, which runs the same module (-m) or stdin
# script (-) in this interpreter and at exit appends the process's kernel
# launch counts to a log: each wrapper must launch its path's kernels.
WRAPPER_TIMEOUT = 600  # seconds a wrapper may take
WRAPPER_LAUNCHER = r"""
import atexit, json, os, runpy, sys

ARGS = sys.argv[1:]
COUNTED = ("fused_rope_attention", "fused_rope_cross_attention", "flash_attention_pallas",
           "flash_attention_grouped", "flash_attention_multihead", "rope_attention_tc",
           "softmax_attention_tc", "rope_attention_3xtf32", "softmax_attention_3xtf32")


def record():
    counts = {}
    k1 = sys.modules.get("thermal3d_torch.kernels.image_ops")
    fa = sys.modules.get("thermal3d_torch.kernels.flash_attention")
    pose = sys.modules.get("thermal3d_torch.kernels.umeyama3x3")
    if k1 is not None:
        counts["percentile_enhance"] = k1.percentile_enhance.launches
    if fa is not None:
        counts.update((name, getattr(fa, name).launches) for name in COUNTED)
    if pose is not None:
        counts["kabsch3x3"] = pose.kabsch3x3.launches
    with open(os.environ["WRAPPER_LAUNCH_LOG"], "a") as f:
        f.write(json.dumps(dict(argv=ARGS, launches={k: v for k, v in counts.items() if v}))
                + "\n")


atexit.register(record)
if ARGS[:1] == ["-m"]:
    sys.argv = ARGS[1:]
    runpy.run_module(ARGS[1], run_name="__main__", alter_sys=True)
elif ARGS[:1] == ["-"]:
    sys.argv = ARGS
    exec(compile(sys.stdin.read(), "<stdin>", "exec"), {"__name__": "__main__"})
else:
    raise SystemExit(f"launcher: unsupported arguments {ARGS}")
"""
K1_K3 = ("percentile_enhance", "fused_rope_attention", "fused_rope_cross_attention",
         "rope_attention_tc")


def same_tree(got_dir: str, want_dir: str, what: str) -> int:
    """Every file of two output trees byte for byte; returns the count."""
    import os

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs)

    names = files(want_dir)
    if files(got_dir) != names or not names:
        raise AssertionError(f"{what}: files {files(got_dir)[:5]}... against {names[:5]}...")
    for rel in names:
        with open(os.path.join(got_dir, rel), "rb") as a, open(os.path.join(want_dir, rel),
                                                               "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{what}: {rel} differs from the direct call's")
    return len(names)


def phase_wrappers(torch, np, root: str):
    """Phase 12 (see the module docstring): each wrapper's exit code, files,
    launches and seconds, and the direct CLI calls its files are held to."""
    import glob
    import os

    from thermal3d_torch.cli import evaluate as cli_evaluate
    from thermal3d_torch.cli import infer as cli_infer
    from thermal3d_torch.cli import pseudo_gt as cli_pseudo_gt
    from thermal3d_torch.core.config import MASTR_512_CATMLPDPT
    from thermal3d_torch.data.freiburg import build_rgb_pair_index
    from thermal3d_torch.preprocess.enhance import (enhance_thermal_contrast,
                                                    enhance_thermal_fixed_range)
    from thermal3d_torch.preprocess.io import load_thermal_image
    from thermal3d_torch.pseudo_gt.generator import OUTPUT_DIRS, PseudoGTGenerator

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    wr = os.path.join(root, "wrappers")
    os.makedirs(os.path.join(wr, "bin"))
    launcher, launch_log = os.path.join(wr, "launcher.py"), os.path.join(wr, "launches.jsonl")
    with open(launcher, "w") as f:
        f.write(WRAPPER_LAUNCHER)
    shim = os.path.join(wr, "bin", "python")
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "{launcher}" "$@"\n')
    os.chmod(shim, 0o755)
    env = dict(os.environ, PATH=os.path.join(wr, "bin") + os.pathsep + os.environ["PATH"],
               PYTHONPATH=repo, WRAPPER_LAUNCH_LOG=launch_log)
    steps = {}

    def run(name, script, args=(), extra_env=(), want=K1_K3):
        """Run one wrapper; it must exit 0 and launch each kernel in `want`."""
        open(launch_log, "w").close()
        torch.cuda.empty_cache()  # the wrapper's process needs the card's memory
        t0 = time.perf_counter()
        proc = subprocess.run(["bash", os.path.join(repo, "scripts", script), *args], cwd=repo,
                              env=dict(env, **dict(extra_env)), capture_output=True, text=True,
                              timeout=WRAPPER_TIMEOUT)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{script}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        launches = {}
        with open(launch_log) as f:
            for line in f:
                for k, v in json.loads(line)["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        if not all(launches.get(k) for k in want):
            raise AssertionError(f"{script}: launches {launches}; each of {want} must launch"
                                 f"\n{proc.stdout[-2000:]}")
        log(f"wrappers: {script} exit 0 in {seconds:.1f} s; launches {launches}")
        steps[name] = dict(script=script, seconds=seconds, launches=launches)
        return proc

    # full-width, full-depth bf16 checkpoints from seed 0: MASt3R-512 here,
    # DUSt3R-224 from phase 11 (export_weights)
    pcfg = dataclasses.replace(MASTR_512_CATMLPDPT, compute_dtype="bfloat16")
    gen = PseudoGTGenerator(pcfg, params_dtype="bfloat16", seed=0)
    mastr_pth = os.path.join(wr, "mastr512_seed0.pth")
    torch.save({"state_dict": {k: v.cpu() for k, v in gen.model.state_dict().items()}},
               mastr_pth)
    del gen
    dustr_pth = os.path.join(root, "dustr224_seed0.pth")
    if not os.path.exists(dustr_pth):
        export_weights(torch, root)
    ds = os.path.join(root, "ds")
    thermal_dir = os.path.join(ds, "train", "seq_00_day", "00", "fl_ir_aligned")

    # 1. pseudo-GT at 512², frame_skip 5, against cli.pseudo_gt called here
    pgt, pgt_direct = os.path.join(wr, "pseudo_gt"), os.path.join(wr, "pseudo_gt_direct")
    run("generate_pseudo_gt", "torch_run_generate_pseudo_gt.sh",
        extra_env=dict(DATASET_DIR=ds, OUTPUT_DIR=pgt, WEIGHTS=mastr_pth),
        want=("fused_rope_attention", "fused_rope_cross_attention", "rope_attention_tc",
              "kabsch3x3"))
    n_pairs = len(build_rgb_pair_index(ds, frame_skip=5))
    counts = {d: len(os.listdir(os.path.join(pgt, d))) for d in OUTPUT_DIRS}
    if set(counts.values()) != {n_pairs}:
        raise AssertionError(f"pseudo-GT wrapper: {counts} files, want {n_pairs} a directory")
    n_steps = -(-n_pairs // PAIR_BATCH)
    _, direct_launches = run_counted(lambda: cli_pseudo_gt.main([
        "--dataset_dir", ds, "--output_dir", pgt_direct, "--weights", mastr_pth,
        "--img_size", "512", "512", "--frame_skip", "5"]),
        {"fused_rope_attention": 48 * n_steps, "fused_rope_cross_attention": 24 * n_steps,
         "rope_attention_tc": 72 * n_steps, "kabsch3x3": n_steps})
    steps["generate_pseudo_gt"].update(pairs=n_pairs, files=same_tree(
        pgt, pgt_direct, "pseudo-GT wrapper"), direct_launches=direct_launches)

    # 2. one epoch of training on that pseudo-GT (img 224, frame_skip 3)
    ckpt = os.path.join(wr, "train_ckpt")
    run("train", "torch_run_train_thermal_dustr.sh", extra_env=dict(
        DATASET_DIR=ds, PSEUDO_GT_DIR=pgt, WEIGHTS=dustr_pth, OUTPUT_MODEL=ckpt, EPOCHS="1"))
    metas = []
    for policy in ("best", "last"):
        (step,) = os.listdir(os.path.join(ckpt, policy))
        step_dir = os.path.join(ckpt, policy, step)
        if sorted(os.listdir(step_dir)) != ["meta.json", "model.pt", "optimizer.pt"]:
            raise AssertionError(f"train wrapper: {step_dir} holds {os.listdir(step_dir)}")
        with open(os.path.join(step_dir, "meta.json")) as f:
            metas.append(json.load(f))
    if not all(math.isfinite(m["val_loss"]) for m in metas):
        raise AssertionError(f"train wrapper: val_loss {metas}")
    steps["train"].update(best_and_last=metas)

    # 3. evaluation of the best checkpoint on the tree's thermal frames,
    # against depths named as evaluation/evaluator.find_matching_depth_file
    # matches them
    gt_dir = os.path.join(wr, "gt")
    os.makedirs(gt_dir)
    rng = np.random.default_rng(12)
    for path in sorted(glob.glob(os.path.join(thermal_dir, "*.png"))):
        gt = rng.uniform(1.0, 20.0, FRAME_HW).astype(np.float32)
        gt[:40] = 0.0  # outside the mask
        np.save(os.path.join(gt_dir, os.path.basename(path)[:-4] + "_depth.npy"), gt)
    ev, ev_direct = os.path.join(wr, "evaluation"), os.path.join(wr, "evaluation_direct")
    run("evaluate", "torch_run_evaluate_thermal_dustr.sh", ["--no_vis"], dict(
        MODEL=ckpt, THERMAL_DIR=thermal_dir, PSEUDO_GT_DIR=gt_dir, OUTPUT_DIR=ev))
    n_txt = len(glob.glob(os.path.join(ev, "*_metrics.txt")))
    if n_txt != N_RGB or not os.path.exists(os.path.join(ev, "metrics_summary.txt")):
        raise AssertionError(f"evaluate wrapper: {n_txt} metrics files, want {N_RGB}")
    _, direct_launches = run_counted(lambda: cli_evaluate.main([
        "--model", ckpt, "--thermal_dir", thermal_dir, "--pseudo_gt_dir", gt_dir,
        "--output_dir", ev_direct, "--img_size", "224", "224", "--no_vis"]),
        {"percentile_enhance": 1, "fused_rope_attention": 40, "fused_rope_cross_attention": 16,
         "rope_attention_tc": 56})
    steps["evaluate"].update(files=same_tree(ev, ev_direct, "evaluate wrapper"),
                             direct_launches=direct_launches)

    # 4. the grid search cut to one cell and one epoch through its arguments
    grid = os.path.join(wr, "grid")
    run("grid_search", "torch_run_grid_search_thermal_parameters.sh",
        ["--edge_weights", "0.5", "--smoothness_weights", "0.3", "--epochs", "1",
         "--output_dir", grid], dict(DATASET_DIR=ds, PSEUDO_GT_DIR=pgt, WEIGHTS=dustr_pth))
    with open(os.path.join(grid, "best_params.json")) as f:
        results = json.load(f)["results"]
    if [(r["edge_weight"], r["smoothness_weight"]) for r in results] != [(0.5, 0.3)] or \
            not math.isfinite(results[0]["val_loss"]) or \
            not os.path.exists(os.path.join(grid, "run_best_params.sh")):
        raise AssertionError(f"grid-search wrapper: {results}")
    steps["grid_search"].update(results=results)

    # 5. the preprocessing smoke test on one frame: cli.infer's depth file
    # against cli.infer called here, its line against the same code here
    frame = sorted(glob.glob(os.path.join(thermal_dir, "*.png")))[0]
    pre, pre_direct = os.path.join(wr, "preprocess"), os.path.join(wr, "preprocess_direct")
    proc = run("test_preprocessing", "torch_run_test_preprocessing.sh", [frame, pre])
    _, direct_launches = run_counted(lambda: cli_infer.main([
        "--img_path", frame, "--output_dir", pre_direct, "--no_vis"]),
        {"percentile_enhance": 1, "fused_rope_attention": 40, "fused_rope_cross_attention": 16,
         "rope_attention_tc": 56})
    gray = load_thermal_image(frame, normalize=True)
    on_card = torch.from_numpy(gray).to("cuda")
    enh = enhance_thermal_contrast(on_card).cpu().numpy()
    fixed = enhance_thermal_fixed_range(on_card).cpu().numpy()
    line = (f"decoded {gray.shape}; contrast-enhanced range [{enh.min():.3f},{enh.max():.3f}]; "
            f"fixed-range mean {fixed.mean():.3f}")
    if line not in proc.stdout.splitlines():
        raise AssertionError(f"preprocessing wrapper printed {proc.stdout[-500:]!r}, want {line!r}")
    steps["test_preprocessing"].update(files=same_tree(pre, pre_direct, "preprocessing wrapper"),
                                       line=line, direct_launches=direct_launches)
    seconds = time.perf_counter() - t_phase
    log(f"wrappers phase: {seconds:.1f} s (" + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in steps.items()) + ")")
    return dict(steps=steps, seconds=seconds)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    if argv and argv[0] == "--dist-worker":
        return dist_worker_main(argv[1:])
    if argv and not ((len(argv) == 2 and argv[0] in ("--compare-k2k3", "--compare-k4k6"))
                     or argv in (["--only-multi-gpu"], ["--only-export"], ["--only-wrappers"],
                                 ["--only-small-decoder"], ["--only-vit-h"], ["--only-window"])
                     or (argv[0] == "--only-head-dims" and len(argv) <= 2)
                     or (argv[0] == "--only-multi-card"
                         and set(argv[1:]) <= set(MD_PARTS) | {"check"})):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    if argv and argv[0] in ("--compare-k2k3", "--compare-k4k6"):
        log(card)
        compare = compare_k2k3 if argv[0] == "--compare-k2k3" else compare_k4k6
        return 0 if compare(torch, argv[1]) else 1
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build = phase_build()
    if argv[:1] == ["--only-head-dims"]:
        cuda_core = ParentCudaCore(argv[1]) if len(argv) == 2 else None
        k2_hd, k3_hd, k456_hd, poison, widths = head_dim_cases(torch, cuda_core)
        k2_d24, k3_d24 = d24_k2k3_cases(torch, cuda_core)
        k4_d24 = plain_attention_cases(torch, "flash_attention_pallas", PLAIN_ATTENTION_D24,
                                       cuda_core=cuda_core)
        print(card, flush=True)
        print(json.dumps({"build": build}), flush=True)
        print(json.dumps({"head_dims": dict(K2=k2_hd, K3=k3_hd, **k456_hd,
                                            d24=dict(K2=k2_d24, K3=k3_d24, K4=k4_d24),
                                            poison=poison, padded_width=widths)}), flush=True)
        print(json.dumps(device_line(torch)), flush=True)
        return 0
    if argv in (["--only-small-decoder"], ["--only-vit-h"]):
        name = argv[0].removeprefix("--only-").replace("-", "_")
        part = (phase_small_decoder if name == "small_decoder" else phase_vit_h)(torch, np)
        print(card, flush=True)
        print(json.dumps({"build": build}), flush=True)
        print(json.dumps({name: part}, default=float), flush=True)
        print(json.dumps(device_line(torch)), flush=True)
        return 0
    if argv == ["--only-window"]:
        log("kernels vs plain versions at the VGGT-1B window shapes:")
        cases = dict(K2=window_k2_cases(torch), K4=window_k4_cases(torch))
        log("K2/K3 at the MASt3R-512 shapes (S=1024), on the same key tiles:")
        mastr = dict(grid=(32, 32), reps=10, dtypes=("bfloat16",))
        cases["K2"] += attention_cases(torch, cross=False, batch=2 * PAIR_BATCH,
                                       widths=[(1024, 16)], **mastr)
        cases["K2"] += attention_cases(torch, cross=False, batch=PAIR_BATCH, widths=[(768, 12)],
                                       **mastr)
        cases["K3"] = attention_cases(torch, cross=True, batch=PAIR_BATCH, **mastr)
        window = phase_window(torch, np)
        print(card, flush=True)
        print(json.dumps({"build": build}), flush=True)
        print(json.dumps({"window": dict(window, cases=cases)}), flush=True)
        print(json.dumps(device_line(torch)), flush=True)
        return 0
    if argv == ["--only-export"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as root:
            export = phase_export(torch, np, root)
        print(card, flush=True)
        print(json.dumps({"export": export}, default=float), flush=True)
        return 0
    if argv[:1] == ["--only-multi-card"]:  # [PART ...]: those parts alone ('check': the check)
        parts = argv[1:]
        multi_card = multi_card_check(torch, np) if not parts or "check" in parts else None
        md_parts = [p for p in parts if p != "check"] if parts else list(MD_PARTS)
        multi_device = None
        if md_parts:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_md_") as root:
                multi_device = phase_multi_device(torch, np, root, md_parts)
        print(card, flush=True)
        print(json.dumps({"multi_card": multi_card}), flush=True)
        print(json.dumps({"multi_device": multi_device}, default=float), flush=True)
        return 0
    if argv == ["--only-wrappers"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_wrappers_") as root:
            write_tree(np, root)
            wrappers = phase_wrappers(torch, np, root)
        print(card, flush=True)
        print(json.dumps({"wrappers": wrappers}), flush=True)
        return 0
    if argv:  # --only-multi-gpu
        log("K2/K3 at the tensor-parallel shapes (tp=2):")
        tp_attention_cases(torch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mg_") as root:
            write_tree(np, root)
            multi_gpu = phase_multi_gpu(torch, np, root)
        print(card, flush=True)
        print(json.dumps({"multi_gpu": multi_gpu}, default=float), flush=True)
        return 0

    log("kernels vs plain versions at the serving shapes:")
    k1 = k1_cases(torch)
    k2 = attention_cases(torch, cross=False)
    k3 = attention_cases(torch, cross=True)
    log("kernels vs plain versions at the MASt3R-512 shapes (S=1024):")
    mastr = dict(grid=(32, 32), reps=10)
    k2 += attention_cases(torch, cross=False, batch=2 * PAIR_BATCH, widths=[(1024, 16)], **mastr)
    k2 += attention_cases(torch, cross=False, batch=PAIR_BATCH, widths=[(768, 12)], **mastr)
    k3 += attention_cases(torch, cross=True, batch=PAIR_BATCH, **mastr)
    log("K2/K3 at the tensor-parallel shapes of phase 10 (tp=2: 8 and 6 heads) and of the "
        "multi-device phase (tp=4: 4 and 3 heads):")
    k2_tp, k3_tp = tp_attention_cases(torch)
    k2_tp4, k3_tp4 = tp_attention_cases(torch, 4)
    k2_d24, k3_d24 = d24_k2k3_cases(torch)
    k2 += k2_d24
    k3 += k3_d24
    log("K2 and K4 at the VGGT-1B window shapes:")
    k2 += window_k2_cases(torch)
    k4_window = window_k4_cases(torch)
    log("K4-K6 (bf16 and float32 also at head_dim 24, on the packed route):")
    k456 = {name: plain_attention_cases(torch, name)
            + plain_attention_cases(torch, name, PLAIN_ATTENTION_D24)
            for name in ("flash_attention_pallas", "flash_attention_grouped",
                         "flash_attention_multihead")}
    k456["flash_attention_pallas"].append(size_one_axes_case(torch))
    k456["flash_attention_pallas"] += k4_window
    k2_hd, k3_hd, k456_hd, poison, widths = head_dim_cases(torch)
    log("the pseudo-GT pose's 3x3 kernel vs its plain sweeps and float64 numpy:")
    kabsch = kabsch_cases(torch, np)
    multi_card = multi_card_check(torch, np)
    engine = phase_engine(torch, np)
    engine["small_decoder"] = phase_small_decoder(torch, np)
    engine["vit_h"] = phase_vit_h(torch, np)
    pseudo_gt = phase_pseudo_gt(torch, np)
    window = phase_window(torch, np)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as root:
        files = phase_files(torch, np, card, engine, pseudo_gt, root)
        training = phase_training(torch, np, root)
        fire = phase_fire(torch, np, card, root)
        int8 = phase_int8(torch, np, root)
        multi_gpu = phase_multi_gpu(torch, np, root)
        multi_device = phase_multi_device(torch, np, root)
        export = phase_export(torch, np, root)
        wrappers = phase_wrappers(torch, np, root)
    export_served = {}  # the native artifact's launches over its served batches
    for batch in export["native"]["served_batches"]:
        for name, count in batch["launches"].items():
            export_served[name] = export_served.get(name, 0) + count

    # launches on each path's own run; `launches` is this slice's main path
    # (pseudo-GT) for K2-K6, the serving path for K1
    by_path = {}
    small_decoder, vit_h = engine["small_decoder"], engine["vit_h"]
    for path, counts in (("serving", engine["launches"]), ("serving_f32", engine["f32_launches"]),
                         ("serving_small_decoder", small_decoder["launches"]),
                         ("serving_small_decoder_f32", small_decoder["f32_launches"]),
                         ("serving_vit_h", vit_h["launches"]),
                         ("serving_vit_h_f32", vit_h["f32_launches"]),
                         ("pseudo_gt_auto", pseudo_gt["launches"]),
                         ("pseudo_gt_pallas", pseudo_gt["pallas"]["launches"]),
                         *((f"pseudo_gt_f32_{impl}", r["launches"])
                           for impl, r in pseudo_gt["float32"].items()),
                         *((f"pseudo_gt_{impl}_depth2", r["launches"])
                           for impl, r in pseudo_gt["reduced_depth"].items()),
                         ("window", window["launches"]),
                         ("files_infer_paths", files["infer_paths"]["launches"]),
                         ("files_cli_infer", files["cli_infer"]["launches"]),
                         ("files_cli_evaluate", files["cli_evaluate"]["launches"]),
                         ("files_generate_pseudo_gt", files["generate_pseudo_gt"]["launches"]),
                         ("files_test_set", files["test_set"]["launches"]),
                         ("training", training["launches"]),
                         *((f"fire_cli_infer_{mode}", r["launches"])
                           for mode, r in fire["cli_infer"].items()),
                         ("fire_ais_investigate", fire["ais_investigate"]["launches"]),
                         ("fire_cli_evaluate_panels", fire["cli_evaluate"]["launches"]),
                         *((f"int8_engine_{name}", int8["engine"][name]["launches"])
                           for name, _ in INT8_CONFIGS),
                         ("int8_generator", int8["generator"]["launches"]),
                         ("multi_gpu_engine", multi_gpu["engine"]["launches"]["mesh"]),
                         ("multi_gpu_generator", multi_gpu["generator"]["launches"]["mesh"]),
                         *((f"multi_gpu_gloo_{name}_rank0", e["launches"][0])
                           for name, e in multi_gpu["gloo_2rank"].items()
                           if isinstance(e, dict)),
                         *((f"int8_{k}", int8["files"][k]["launches"])
                           for k in ("cli_infer_int8_static", "cli_pseudo_gt_int8_test_set")),
                         ("export_native_artifact", export_served),
                         ("export_portable_artifact", export["portable"]["launches"]),
                         ("export_mastr512_artifact", export["mastr512"]["launches"]),
                         *((f"wrapper_{name}", step["launches"])
                           for name, step in wrappers["steps"].items())):
        for name, count in counts.items():
            by_path.setdefault(name, {})[path] = count
    if multi_device["ran"]:  # launches on distinct cards: a mesh batch, a rank's step
        md_paths = [(f"multi_device_engine_{n}_cards", m["launches"])
                    for n, m in multi_device.get("engine", {}).get("meshes", {}).items()]
        md_paths += [(f"multi_device_generator_{n}_cards", m["launches"])
                     for n, m in multi_device.get("generator", {}).get("meshes", {}).items()]
        md_paths += [(f"multi_device_train_{name}_rank0_step", t["launches_per_step"][0])
                     for name, t in multi_device["training"]["timed_bf16"].items()]
        for path, counts in md_paths:
            for name, count in counts.items():
                by_path.setdefault(name, {})[path] = count
    for counts in by_path.values():  # every kernel names the training path
        counts.setdefault("training", 0)

    def entry(name, source, replaces, cases, main_case, main_path):
        m = cases[main_case]
        extra = {}
        # the headers a tensor-core source includes (the key-tile loop K2-K6 share)
        tc_headers = [f"thermal3d_torch/kernels/csrc/{h}" for h in
                      ("key_tile_attention.cuh", "attention_tc.cuh", "hopper_tma.cuh")]
        tf32_src = "thermal3d_torch/kernels/csrc/attention_3xtf32.cu"
        # the packed route (head dims outside 16, 32, 64, 128): bf16 and float32
        packed = dict(bfloat16=f"{attn_src}::t3d_attention_tc_packed",
                      float32=f"{tf32_src}::t3d_attention_3xtf32_packed")
        if name.startswith("fused_rope"):  # K2/K3: bf16 and f32 on tensor cores
            extra = dict(headers=tc_headers, source_3xtf32=tf32_src, sources_packed=packed,
                         tensor_core_launches_by_path=by_path["rope_attention_tc"],
                         tf32x3_launches_by_path=by_path["rope_attention_3xtf32"])
        elif name.startswith("flash_attention"):  # K4-K6: the same split
            extra = dict(headers=tc_headers, source_3xtf32=tf32_src, sources_packed=packed,
                         tensor_core_launches_by_path=by_path["softmax_attention_tc"],
                         tf32x3_launches_by_path=by_path["softmax_attention_3xtf32"])
        elif name.endswith("3xtf32"):  # the float32 family: its own counts
            extra = dict(headers=tc_headers)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    **extra, launches=by_path[name][main_path], launches_by_path=by_path[name],
                    max_abs_err=max(c["max_abs_err"] for c in cases), ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                    library_ms=m["library_ms"], main_case=m, cases=cases)

    k2 += k2_tp + k2_tp4 + k2_hd  # after the cases the entries' main_case indices name
    k3 += k3_tp + k3_tp4 + k3_hd
    for name, cases in k456_hd.items():
        k456[name] += cases
    fa = importlib.import_module("thermal3d_torch.kernels.flash_attention")
    f32_k2k3 = [c for c in k2 + k3 if c["kernel"].startswith("3xtf32")]
    f32_k4k6 = [c for name in k456 for c in k456[name] if c["kernel"] == fa.TF32X3]

    def main_index(cases, shape):
        return next(i for i, c in enumerate(cases) if c["shape"] == shape)
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
        # the float32 family (3xTF32) of K2/K3 and of K4-K6, on their own
        # counts: main cases the S=1024 encoder call of K2 and K4
        entry("rope_attention_3xtf32", "thermal3d_torch/kernels/csrc/attention_3xtf32.cu",
              f"{fa_src}:310", f32_k2k3, main_index(f32_k2k3, [8, 1024, 1024]),
              "pseudo_gt_f32_auto"),
        entry("softmax_attention_3xtf32", "thermal3d_torch/kernels/csrc/attention_3xtf32.cu",
              f"{fa_src}:91", f32_k4k6, main_index(f32_k4k6, [8, 16, 1024, 64]),
              "pseudo_gt_f32_pallas"),
        # no TPU kernel: it stands for XLA's SVD and two det in the JAX pose;
        # main case a step of phase 5's generator (PAIR_BATCH covariances)
        entry("kabsch3x3", "thermal3d_torch/kernels/csrc/umeyama3x3.cu",
              "thermal3d/geometry/umeyama.py:39", kabsch, 1, "pseudo_gt_auto"),
    ]
    kernels[-3]["replaces_also"] = [f"{fa_src}:415"]  # K3 on the same kernel
    kernels[-2]["replaces_also"] = [f"{fa_src}:227", f"{fa_src}:164"]  # K5, K6
    print(card, flush=True)
    print(json.dumps({"build": build}), flush=True)
    print(json.dumps({"packed_route": dict(poison=poison, padded_width=widths)}), flush=True)
    print(json.dumps({"engine": engine}), flush=True)
    print(json.dumps({"pseudo_gt": pseudo_gt}), flush=True)
    print(json.dumps({"window": window}), flush=True)
    print(json.dumps({"files": files}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(fire["bench_line"], flush=True)
    print(json.dumps({"fire": fire}), flush=True)
    print(json.dumps({"int8": dict(int8, int_mm_launches_by_path=by_path["int_mm"])},
                     default=float), flush=True)
    print(json.dumps({"multi_gpu": multi_gpu}, default=float), flush=True)
    print(json.dumps({"export": export}, default=float), flush=True)
    print(json.dumps({"multi_card": multi_card}), flush=True)
    print(json.dumps({"multi_device": multi_device}, default=float), flush=True)
    print(json.dumps({"wrappers": wrappers}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps(device_line(torch)), flush=True)
    return 0


def device_line(torch) -> dict:
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
