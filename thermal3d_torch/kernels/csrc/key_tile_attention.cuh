// The key-tile core of the tensor-core attention kernels, CUDA C++ for
// sm_90a: one loop over 64-key tiles that rope_attention_tc.cu (K2/K3 at
// S > 256, K roped by a prologue) and attention_tc.cu (K4-K6, q/k already
// roped) both instantiate. bf16, head_dim 64.
//
// Block: 128 query rows of one (batch item, head), two warpgroups of 64
// rows, no producer warp, two blocks an SM (128 registers a thread; a
// ninth warp would cap every thread at 168 and leave one block an SM).
//   * K and V tiles stream by TMA through a ring of kRing stages, each with
//     a "full" mbarrier (the TMA's bytes landed) and an "empty" one (every
//     thread of the block is done with it). Thread 0 fills the first stages;
//     of the two warpgroups' thread 0, the one that releases a stage second
//     (the `claims` count) refills it with the tile kRing on.
//   * Each warpgroup issues tile t's QK^T (wgmma m64n64k16, Q and K from
//     shared memory, 128-byte swizzle) together with tile t-1's PV (P from
//     registers, V as the MN-major B operand), and runs tile t's online
//     softmax in place on the float32 scores while that PV runs. Only after
//     the PV's wait does it round p to bf16 into P's registers and rescale
//     O by the step's alpha: a write to a register that an issued wgmma
//     still reads (P packed during the PV, into registers ptxas shares
//     between the two tiles' P) makes ptxas serialize every wgmma of the
//     kernel (its C7513 warning), which undoes the overlap.
//   * O / l, rounded to bf16, goes through the warpgroup's Q rows in shared
//     memory and out by a TMA store that drops rows past the query count.
//
// The kernel's operands (an Op) supply what differs:
//   * Op::kQBytes, load_q: Q rows that arrive by TMA on the first stage's
//     full barrier (K4-K6), or none (0; K2/K3);
//   * stage_q: Q rows staged by the warpgroup's threads before the first
//     tile (K2/K3's RoPE), or nothing;
//   * load_kv: tile t's K and V boxes into a stage;
//   * softmax: the online-softmax step of a tile, in place (scores scaled,
//     masked past `valid` keys, the running max and float32 sum moved, p in
//     float32 where the score was, alpha for the rescale of O);
//   * store_o: the warpgroup's output box.
// Fragment layout of a warpgroup's 64 x 64 tile: the thread owns rows g and
// g + 8 of its warp's 16 (g = lane / 4), columns 8i + 2t + {0, 1} (t = lane
// % 4); o[4i + e] is row g + 8*(e >> 1), column 8i + 2t + (e & 1); l[r] and
// m[r] belong to row g + 8r.
#pragma once

#include "attention_tc.cuh"
#include "hopper_tma.cuh"

namespace {
namespace key_tiles {

constexpr int kRing = 4;                        // K/V stages
constexpr int kBlocksPerSm = 2;                 // 128 registers a thread
constexpr int kWgs = 2;                         // warpgroups, 64 query rows each
constexpr int kBlockThreads = 128 * kWgs;
constexpr int kBlockRows = kWgs * kTile;        // query rows a block
constexpr int kQArea = kWgs * kTileBytes;       // the block's Q rows, then its output
constexpr int kStageSize = 2 * kTileBytes;      // K, then V
constexpr int kBarsAt = kQArea + kRing * kStageSize;
constexpr int kSmem = 1024 + kBarsAt + 2 * kRing * 8 + kRing * 4;

// K2/K3's online softmax of one 64-key tile (the recipe of
// attention_common.cuh's key-tile loop: expf, every tile masked): scores
// scaled and masked past `valid` keys, the running max and sum moved, p =
// exp(s - m) in place of the scores. Its rounding to bf16 as PV's A operand
// and the output's rescale by alpha are left to the caller (after the
// previous tile's PV).
__device__ __forceinline__ void online_softmax_tile(float (&sc)[32], int valid, float scale,
                                                    int tq, float (&m)[2], float (&l)[2],
                                                    float (&alpha)[2]) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * tq + (e & 1);
      const float x = col < valid ? sc[4 * i + e] * scale : -INFINITY;
      sc[4 * i + e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);  // finite: every tile has a key
    alpha[r] = expf(m[r] - m_new);             // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = expf(sc[i] - m[(i >> 1) & 1]);  // masked: exp(-inf) = 0
    l[(i >> 1) & 1] += sc[i];
  }
}

// One block's attention over `seq` keys (see the header comment): smem_raw
// is the kernel's dynamic shared memory (kSmem bytes), op its operands.
template <class Op>
__device__ __forceinline__ void attend(unsigned char* smem_raw, const Op& op, int seq) {
  constexpr int R = kRing;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-byte aligned
  const uint32_t sbase = raw + (uint32_t)(base - smem_raw);
  const uint32_t ring = sbase + kQArea;
  const uint32_t full = sbase + kBarsAt;  // stage s: TMA landed
  const uint32_t empty = full + 8 * R;    // stage s: every thread done with it
  unsigned int* claims = reinterpret_cast<unsigned int*>(base + kBarsAt + 16 * R);
  const int tid = threadIdx.x;
  const int w = tid / 128;
  const int ctid = tid - 128 * w;
  const int tq = ctid & 3;
  const int block_row0 = blockIdx.x * kBlockRows;
  const int ntiles = (seq + kTile - 1) / kTile;
  auto load = [&](int t) {
    const uint32_t bar = full + 8 * (t % R);
    mbar_arrive_expect_tx(bar, 2 * kTileBytes + (t == 0 ? Op::kQBytes : 0));
    if (t == 0) op.load_q(sbase, bar, block_row0);
    op.load_kv(ring + (t % R) * kStageSize, bar, t);
  };
  if (tid == 0) {
    for (int st = 0; st < R; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kBlockThreads);
      claims[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < R && t < ntiles; ++t) load(t);
  }
  __syncthreads();
  // every thread is done with tile t's stage; of the two warpgroups' thread
  // 0, the second to get here refills it with tile t + R
  auto release = [&](int t) {
    const int st = t % R;
    mbar_arrive(empty + 8 * st);
    if (ctid == 0 && (atomicAdd(&claims[st], 1u) & 1u)) {
      mbar_wait_or_trap(empty + 8 * st, (t / R) & 1);
      if (t + R < ntiles) load(t + R);
    }
  };

  const uint32_t my_q = sbase + w * kTileBytes;
  const int row_base = block_row0 + w * kTile;
  op.stage_q(my_q, row_base, ctid, w);

  const uint64_t q_desc = smem_desc(my_q);
  float sc[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  uint32_t p[4][4];  // P of the last tile, PV's A operand

  auto issue_qk = [&](int t) {
    const uint64_t k_desc = smem_desc(ring + (t % R) * kStageSize);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  };
  auto issue_pv = [&](int t) {
    const uint64_t v_desc = smem_desc(ring + (t % R) * kStageSize + kTileBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(o, p[kk], v_desc + (uint64_t)((16 * kRowBytes * kk) >> 4));
  };
  // P, bf16, from the float32 p in sc: columns 16kk + {2t, 2t+1} (i = 2kk)
  // and 16kk + 8 + {2t, 2t+1} (i = 2kk + 1), rows g, g+8 -> a0, a1, then
  // a2, a3
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i >> 1][2 * (i & 1) + 0] = pack_bf16(sc[4 * i], sc[4 * i + 1]);
      p[i >> 1][2 * (i & 1) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e >> 1];
  };

  mbar_wait_or_trap(full, 0);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(sc);
  op.softmax(sc, seq, tq, m, l, alpha);
  pack();
  rescale();
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait_or_trap(full + 8 * (t % R), (t / R) & 1);
    wgmma_fence();
    issue_qk(t);
    wgmma_commit();
    issue_pv(t - 1);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // QK^T of tile t
    reg_fence(sc);
    op.softmax(sc, seq - kTile * t, tq, m, l, alpha);  // in sc: PV reads p
    wgmma_wait_all();  // PV of tile t - 1
    reg_fence(o);
    pack();
    rescale();
    release(t - 1);
  }
  wgmma_fence();
  issue_pv(ntiles - 1);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(o);
  release(ntiles - 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // o / l rounded to bf16 into the warpgroup's Q rows, out by a TMA store;
  // rows past the query count are dropped
  const int warp = ctid >> 5, g = (ctid & 31) >> 2;
  unsigned char* tile = base + w * kTileBytes;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = o[4 * i + 2 * r] / l[r];
      const float y = o[4 * i + 2 * r + 1] / l[r];
      *reinterpret_cast<__nv_bfloat162*>(tile + swizzle(row, i) + 4 * tq) =
          __floats2bfloat162_rn(x, y);
    }
  }
  fence_async_shared();
  named_barrier(1 + w, 128);
  if (ctid == 0) {
    op.store_o(my_q, row_base);
    bulk_commit();
    bulk_wait();
  }
}

}  // namespace key_tiles
}  // namespace
