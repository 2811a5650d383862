"""Each roofline's and MFU's operations, bytes and FLOP count at the cells'
own shapes, against counts written out by hand here."""

from __future__ import annotations

import json

import pytest

from benchmark.run import load_json, metric_module
from benchmark.tests.conftest import REPO

SPEC = load_json(REPO / "BENCHMARK.json")


def cell_inputs(cell: str):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    return (json.loads((REPO / config["file"]).read_text()),
            json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()))


SERVE = "dustr224-stream-b128"
PGT = "mastr512-pgt-b8"

# DUSt3R-224 on a chunk of 128 frames: 196 tokens, encoder 1024 wide (24
# blocks), decoder 768 wide (8 blocks, two branches), both over 128 images
M_SERVE = 128 * 196
ENC_BLOCK_N = 3 * 1024 + 1024 + 4 * 1024  # qkv, proj, fc1: K = 1024
DEC_BLOCK_N = 3 * 768 + 768 + 3 * 768 + 768 + 4 * 768  # qkv, proj, q/k/v, proj, fc1: K = 768
SERVE_GEMM_FLOPS = (24 * 2 * M_SERVE * (1024 * ENC_BLOCK_N + 4096 * 1024)
                    + 2 * 2 * M_SERVE * 1024 * 768
                    + 2 * 8 * 2 * M_SERVE * (768 * DEC_BLOCK_N + 3072 * 768))
SERVE_GEMM_BYTES = 2 * (
    24 * sum(M_SERVE * k + k * n + M_SERVE * n + n
             for k, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)))
    + 2 * (M_SERVE * 1024 + 1024 * 768 + M_SERVE * 768 + 768)
    + 16 * sum(M_SERVE * k + k * n + M_SERVE * n + n
               for k, n in ((768, 2304), (768, 768), (768, 768), (768, 768), (768, 768),
                            (768, 768), (768, 3072), (3072, 768))))
SERVE_ATTN_FLOPS = 24 * 4 * 128 * 196 ** 2 * 1024 + 32 * 4 * 128 * 196 ** 2 * 768
SERVE_ATTN_BYTES = (24 * (4 * 128 * 196 * 1024 * 2 + 2 * 196 * 64 * 4)
                    + 32 * (4 * 128 * 196 * 768 * 2 + 2 * 196 * 64 * 4))
SERVE_MODEL_FLOPS = (2 * 128 * 196 * (3 * 16 * 16) * 1024  # patch embedding
                     + SERVE_GEMM_FLOPS + SERVE_ATTN_FLOPS
                     + 2 * 2 * 128 * 196 * 768 * (4 * 16 * 16))  # two linear heads

# MASt3R-512 on a step of 8 pairs: 1024 tokens, the encoder over 16 images,
# each decoder branch (12 blocks) over 8
M_ENC, M_DEC = 16 * 1024, 8 * 1024
PGT_GEMM_FLOPS = (24 * 2 * M_ENC * (1024 * ENC_BLOCK_N + 4096 * 1024)
                  + 2 * 2 * M_DEC * 1024 * 768
                  + 2 * 12 * 2 * M_DEC * (768 * DEC_BLOCK_N + 3072 * 768))
PGT_ATTN_FLOPS = 24 * 4 * 16 * 1024 ** 2 * 1024 + 48 * 4 * 8 * 1024 ** 2 * 768
PGT_ATTN_BYTES = (24 * (4 * 16 * 1024 * 1024 * 2 + 2 * 1024 * 64 * 4)
                  + 48 * (4 * 8 * 1024 * 768 * 2 + 2 * 1024 * 64 * 4))
# one DPT head on one 512x512 image (32x32 tokens): (h, w, c_in, c_out, k)
DPT_CONVS = [
    (32, 32, 1024, 96, 1), (32, 32, 96, 96, 4),  # act_postprocess 0 (transpose k=4)
    (32, 32, 768, 192, 1), (32, 32, 192, 192, 2),  # 1 (transpose k=2)
    (32, 32, 768, 384, 1),  # 2
    (32, 32, 768, 768, 1), (16, 16, 768, 768, 3),  # 3 (stride 2)
    (128, 128, 96, 256, 3), (64, 64, 192, 256, 3), (32, 32, 384, 256, 3),
    (16, 16, 768, 256, 3),  # layer1_rn .. layer4_rn
    *[(16, 16, 256, 256, 3)] * 2, (32, 32, 256, 256, 1),  # refinenet4
    *[(32, 32, 256, 256, 3)] * 4, (64, 64, 256, 256, 1),  # refinenet3
    *[(64, 64, 256, 256, 3)] * 4, (128, 128, 256, 256, 1),  # refinenet2
    *[(128, 128, 256, 256, 3)] * 4, (256, 256, 256, 256, 1),  # refinenet1
    (256, 256, 256, 128, 3), (512, 512, 128, 128, 3), (512, 512, 128, 4, 1),  # head
]
DPT_FLOPS = sum(2 * h * w * ci * co * k * k for h, w, ci, co, k in DPT_CONVS)
PGT_MODEL_FLOPS = (2 * 16 * 1024 * (3 * 16 * 16) * 1024 + PGT_GEMM_FLOPS + PGT_ATTN_FLOPS
                   + 2 * 8 * DPT_FLOPS)


@pytest.mark.parametrize("metric, cell, operations", [
    ("gemm_roofline.serve", SERVE, SERVE_GEMM_FLOPS),
    ("k2k3_roofline.serve", SERVE, SERVE_ATTN_FLOPS),
    ("gemm_roofline.pgt", PGT, PGT_GEMM_FLOPS),
    ("k2k3_roofline.pgt", PGT, PGT_ATTN_FLOPS),
])
def test_operations(metric, cell, operations):
    cfg, traffic = cell_inputs(cell)
    assert metric_module(REPO, metric).operations(cfg, traffic) == operations


@pytest.mark.parametrize("metric, cell, nbytes", [
    ("gemm_roofline.serve", SERVE, SERVE_GEMM_BYTES),
    ("k2k3_roofline.serve", SERVE, SERVE_ATTN_BYTES),
    ("k2k3_roofline.pgt", PGT, PGT_ATTN_BYTES),
])
def test_bytes(metric, cell, nbytes):
    cfg, traffic = cell_inputs(cell)
    assert metric_module(REPO, metric).bytes_moved(cfg, traffic) == nbytes


@pytest.mark.parametrize("metric, cell, flops", [
    ("mfu.serve", SERVE, SERVE_MODEL_FLOPS),
    ("mfu.pgt", PGT, PGT_MODEL_FLOPS),
])
def test_model_flops(metric, cell, flops):
    cfg, traffic = cell_inputs(cell)
    assert metric_module(REPO, metric).flops_per_request(cfg, traffic) == flops


def test_least_time_takes_the_larger_bound_per_call():
    """The K2 calls of serving are bound by their bytes, those of pseudo-GT
    by their operations (at 989 TFLOP/s and 3.35 TB/s)."""
    cfg, traffic = cell_inputs(SERVE)
    serve = metric_module(REPO, "k2k3_roofline.serve").least_s(cfg, traffic)
    assert serve == pytest.approx(SERVE_ATTN_BYTES / 3.35e12, rel=1e-12)
    cfg, traffic = cell_inputs(PGT)
    pgt = metric_module(REPO, "k2k3_roofline.pgt").least_s(cfg, traffic)
    assert pgt == pytest.approx(PGT_ATTN_FLOPS / 989e12, rel=1e-12)
