// Shared core of the tensor-core attention kernels, CUDA C++ for sm_90a:
// rope_attention_tc.cu (K2/K3, fused RoPE) and attention_tc.cu (K4-K6,
// softmax attention on q/k that are already roped). bf16, head_dim 64.
//
// Arithmetic, the Pallas kernels', over keys in tiles of 64 with an online
// softmax (the recipe of attention_common.cuh's key-tile loop):
//   scores = (q . k accumulated in float32) * scale; keys >= Sk masked;
//   per tile: m_new = max(m, rowmax), p = exp(s - m_new) with its float32
//     sum, p rounded to bf16 before PV, the float32 sum and accumulator
//     rescaled by exp(m_old - m_new);
//   out = accumulator / sum, rounded to bf16.
//
// Block layout: one block per (128 query rows, head, batch item) with three
// warpgroups.
//   * Two consumer warpgroups own 64 query rows each. Each stages its rows
//     once into a swizzled bf16 Q buffer (the kernel's own step: RoPE for
//     K2/K3, a copy for K4-K6), then runs attend_key_tiles: per key tile
//     S = Q K^T with wgmma m64n64k16 (Q and K from shared memory, 128-byte
//     swizzle), the online softmax in registers, and O += P V with wgmma (P
//     from the score registers converted to bf16, V from shared memory as
//     the MN-major B operand). Both warpgroups read each K/V tile.
//   * One producer warpgroup (produce_tiles) fills a ring of kStages K/V
//     tiles by cp.async in the swizzled operand layout (rows >= Sk
//     zero-filled by the copy, never read). "full" and "empty" mbarriers
//     hand tiles over, so the copies of the next tiles overlap the
//     consumers' products on this one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head_dim
constexpr int kRowsPerWg = 64;    // query rows of one consumer warpgroup (wgmma M)
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kBlockRows = kRowsPerWg * kConsumers;
constexpr int kTile = 64;         // keys a tile (wgmma N of Q K^T, K of P V)
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRowBytes = kD * 2;                      // one bf16 row, 128 B
constexpr int kQBytes = kBlockRows * kRowBytes;        // 16 KB
constexpr int kTileBytes = kTile * kRowBytes;          // 8 KB
constexpr int kStageBytes = 2 * kTileBytes;            // K then V
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;  // + slack to align to 1024

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const uint32_t n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: rows of 128 bytes,
// 8-row atoms of 1024 bytes (1024-byte aligned), chunk c of row r stored at
// chunk c ^ (r % 8). The stride between atoms (8 rows on, or 8 k-rows on for
// the MN-major operand) is 1024 bytes; it goes into both offset fields, so
// the descriptor reads the same for the K-major (SBO) and MN-major (SBO or
// LBO, a single 64-wide atom along N) uses below.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kAtom = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kAtom << 16) | (kAtom << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator registers at this point of the program: reads after a
// wgmma wait may not move above it, writes before a wgmma may not sink below.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define T3D_ACC32(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define T3D_REGS32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64n64k16, A and B (K-major) from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T3D_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : T3D_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A from registers (4 x bf16x2), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T3D_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : T3D_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the block's pipeline -------------------------------------------------

// Shared-memory addresses of a block: the Q buffer (kBlockRows swizzled
// rows), the K/V ring (stage s: K at ring + s*kStageBytes, V after it) and
// the full / empty mbarriers of each stage.
struct TcSmem {
  uint32_t q, ring, full_bar, empty_bar;
};

// Lay the block's buffers out in its dynamic shared memory (kSmemBytes) and
// initialise the barriers; every thread of the block calls it.
__device__ __forceinline__ TcSmem tc_smem_init(unsigned char* smem_raw) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const TcSmem sm{base, base + kQBytes, base + kBarOffset, base + kBarOffset + 8 * kStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full_bar + 8 * s, 128);                  // the producer's threads
      mbar_init(sm.empty_bar + 8 * s, 128 * kConsumers);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// The producer warpgroup (ptid in [0, 128)): the K and V tiles of one head
// into the ring, rows >= seq zero-filled. kb and vb point at the head's row
// 0; rows are k_row and v_row elements apart, 16-byte aligned.
__device__ __forceinline__ void produce_tiles(const __nv_bfloat16* __restrict__ kb, long long k_row,
                                              const __nv_bfloat16* __restrict__ vb, long long v_row,
                                              int seq, const TcSmem& sm, int ptid) {
  const int ntiles = (seq + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(sm.empty_bar + 8 * s, ((t / kStages) & 1) ^ 1);
    const uint32_t k_smem = sm.ring + s * kStageBytes;
    const uint32_t v_smem = k_smem + kTileBytes;
    const int key0 = t * kTile;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int idx = ptid + 128 * it;  // 64 rows x 8 chunks
      const int r = idx >> 3;
      const int c = idx & 7;
      const bool valid = key0 + r < seq;
      const long long row = valid ? key0 + r : 0;
      cp_async16(v_smem + swizzle(r, c), vb + row * v_row + 8 * c, valid);
      cp_async16(k_smem + swizzle(r, c), kb + row * k_row + 8 * c, valid);
    }
    cp_async_wait_all();
    fence_async_shared();
    mbar_arrive(sm.full_bar + 8 * s);
  }
}

// One consumer warpgroup over every key tile of the ring, its 64 query rows
// staged (and fenced) at q_smem. On return o holds the unnormalised output
// fragment and l the whole rows' softmax sums. Fragment layout: the thread
// owns rows g and g + 8 of its warp's 16 (g = lane / 4), columns
// 8i + 2t + {0, 1} (t = lane % 4); o[4i + e] is row g + 8*(e >> 1), column
// 8i + 2t + (e & 1); l[r] is row g + 8r.
__device__ __forceinline__ void attend_key_tiles(uint32_t q_smem, const TcSmem& sm, int seq,
                                                 float scale, int lane, float (&o)[32],
                                                 float (&l)[2]) {
  const int tq = lane & 3;
  const int ntiles = (seq + kTile - 1) / kTile;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  l[0] = l[1] = 0.0f;
  const uint64_t q_desc = smem_desc(q_smem);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    mbar_wait(sm.full_bar + 8 * s, (t / kStages) & 1);
    const uint32_t k_smem = sm.ring + s * kStageBytes;
    const uint32_t v_smem = k_smem + kTileBytes;

    // S = Q K^T over the 64 dims, 4 steps of k16 (32 bytes into each row)
    wgmma_fence();
    const uint64_t k_desc = smem_desc(k_smem);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // online softmax over this tile (keys >= seq masked)
    const int valid = seq - t * kTile;
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
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);  // finite: every tile has a key
      alpha[r] = expf(m[r] - m_new);             // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t p[4][4];  // P as the A operand of 4 k16 steps
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = expf(sc[4 * i + e] - m[e >> 1]);  // masked: exp(-inf) = 0
        l[e >> 1] += e4[e];
        o[4 * i + e] *= alpha[e >> 1];
      }
      // columns 16kk + {2t, 2t+1} (i = 2kk) and 16kk + 8 + {2t, 2t+1}
      // (i = 2kk + 1): rows g, g+8 -> a0, a1, then a2, a3
      p[i >> 1][2 * (i & 1) + 0] = pack_bf16(e4[0], e4[1]);
      p[i >> 1][2 * (i & 1) + 1] = pack_bf16(e4[2], e4[3]);
    }

    // O += P V: V rows are the reduction axis (MN-major B), 16 rows a step
    wgmma_fence();
    const uint64_t v_desc = smem_desc(v_smem);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, p[kk], v_desc + (uint64_t)((16 * kRowBytes * kk) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    mbar_arrive(sm.empty_bar + 8 * s);
  }

  // the row sums were kept per thread over its columns; the quad holds the row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// Store one consumer warpgroup's output, o / l rounded to bf16: query row
// `row` of the head at ob + row * row_stride (elements), for the 64 rows
// from row0 (warp w of the warpgroup holds rows 16w..16w+15); rows >= seq
// are computed, not stored.
__device__ __forceinline__ void store_rows(const float (&o)[32], const float (&l)[2],
                                           __nv_bfloat16* __restrict__ ob, long long row_stride,
                                           int row0, int seq, int warp, int lane) {
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= seq) continue;
    __nv_bfloat16* orow = ob + (long long)row * row_stride;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = o[4 * i + 2 * r] / l[r];
      const float y = o[4 * i + 2 * r + 1] / l[r];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * tq) = __floats2bfloat162_rn(x, y);
    }
  }
}

}  // namespace
