// K2 + K3 on Hopper tensor cores: fused 2-D RoPE + softmax attention for
// bf16 with head_dim 64, CUDA C++ for sm_90a (wgmma, mbarriers, cp.async).
//
// Replaces the Pallas TPU kernel thermal3d/kernels/flash_attention.py::
// _fused_rope_kernel, reached through _fused_rope_attention_fwd (K2: the
// packed [B,S,3C] qkv projection, row stride 3C) and _fused_rope_xattn_fwd
// (K3: separate [B,S,C] q/k/v projections, row stride C). q, k and v are
// base pointers with a common row stride; head h sits at column h*64; the
// output is [B,S,C].
//
// Arithmetic, the Pallas kernel's, over keys in tiles of 64 with an online
// softmax (the recipe of attention_common.cuh's key-tile loop):
//   q and k roped in float32 from the cos/sin tables [S,64] (each product and
//     the sum rounded separately, no FMA), then rounded to bf16;
//   scores = (q . k accumulated in float32) * scale; keys >= S masked;
//   per tile: m_new = max(m, rowmax), p = exp(s - m_new) with its float32
//     sum, p rounded to bf16 before PV, the float32 sum and accumulator
//     rescaled by exp(m_old - m_new);
//   out = accumulator / sum, rounded to bf16.
//
// What bounds it on an H100: at S=196 the bytes (qkv in, out; about 3x the
// operations' time at 989 TFLOP/s); at S=1024 the operations (4*S^2*64 a
// head, about 250x the bytes' time). Design: one block per (128 query rows,
// head, batch item) with three warpgroups.
//   * Two consumer warpgroups own 64 query rows each. Each ropes its rows
//     once into a bf16 Q buffer, then per key tile computes S = Q K^T with
//     wgmma m64n64k16 (Q and K from shared memory, 128-byte swizzle), the
//     online softmax in registers, and O += P V with wgmma (P from the score
//     registers converted to bf16, V from shared memory as the MN-major B
//     operand). Both warpgroups read each K/V tile.
//   * One producer warpgroup fills a ring of kStages K/V tiles by cp.async
//     in the swizzled operand layout (rows >= S zero-filled by the copy,
//     never read). "full" and "empty" mbarriers hand tiles over, so the
//     copies of the next tiles overlap the consumers' products on this one.
//   * K is roped once per head, by a prologue kernel launched just before
//     on the same stream (rope_k_kernel: [B,S,*] rows -> a bf16 [B,H,S,64]
//     scratch). Roping K tiles in the producer instead repeats the RoPE for
//     every 128 query rows (8 times a head at S=1024) and measured slower at
//     S=1024 on an H100: four warps cannot rope a tile (8 KB of K, 32 KB of
//     cos/sin tables) in the time the consumers take to multiply one.
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

// ---- RoPE -----------------------------------------------------------------

// The cos/sin entries of one row's chunk pair (c, c + 2), c in {0, 1, 4, 5}.
struct PairTables {
  float ca[8], sa[8], cb[8], sb[8];
  __device__ __forceinline__ void load(const float* cos_row, const float* sin_row, int c) {
    const float* src[4] = {cos_row + 8 * c, sin_row + 8 * c, cos_row + 8 * c + 16,
                           sin_row + 8 * c + 16};
    float* dst[4] = {ca, sa, cb, sb};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      *reinterpret_cast<float4*>(dst[t]) = *reinterpret_cast<const float4*>(src[t]);
      *reinterpret_cast<float4*>(dst[t] + 4) = *reinterpret_cast<const float4*>(src[t] + 4);
    }
  }
};

// RoPE of one row's chunk pair (c, c + 2) of 8 elements each: element d of
// chunk c (an even quarter of the head) pairs with d + 16 (the odd quarter
// that follows). Rounded as rope_at in attention_common.cuh.
__device__ __forceinline__ void rope_pair(const __nv_bfloat16* row, const PairTables& tab, int c,
                                          uint4& lo, uint4& hi) {
  const uint4 a = *reinterpret_cast<const uint4*>(row + 8 * c);
  const uint4 b = *reinterpret_cast<const uint4*>(row + 8 * c + 16);
  const __nv_bfloat16* ta = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(&b);
  uint32_t* ol = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* oh = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    float rl[2], rh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = __bfloat162float(ta[i + e]);
      const float y = __bfloat162float(tb[i + e]);
      rl[e] = __fadd_rn(__fmul_rn(x, tab.ca[i + e]), __fmul_rn(-y, tab.sa[i + e]));
      rh[e] = __fadd_rn(__fmul_rn(y, tab.cb[i + e]), __fmul_rn(x, tab.sb[i + e]));
    }
    ol[i / 2] = pack_bf16(rl[0], rl[1]);
    oh[i / 2] = pack_bf16(rh[0], rh[1]);
  }
}

// Rope rows [row0, row0 + 64) of one head into a swizzled bf16 operand
// buffer of 64 rows; rows >= seq are zero. 128 threads, tid in [0, 128).
__device__ __forceinline__ void rope_rows(const __nv_bfloat16* __restrict__ x, long long row_stride,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int row0, int seq,
                                          uint32_t dst, int tid) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int task = tid + 128 * it;  // 64 rows x 4 chunk pairs
    const int r = task >> 2;
    const int pair = task & 3;
    const int c = (pair & 1) | ((pair & 2) << 1);  // 0, 1, 4, 5
    const int row = row0 + r;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (row < seq) {
      PairTables tables;
      tables.load(cos_t + (size_t)row * kD, sin_t + (size_t)row * kD, c);
      rope_pair(x + (long long)row * row_stride, tables, c, lo, hi);
    }
    st_shared16(dst + swizzle(r, c), lo);
    st_shared16(dst + swizzle(r, c + 2), hi);
  }
}

// ---- the kernels ------------------------------------------------------------

// RoPE of K into k_roped [B,H,S,64] bf16 (rows 128 bytes apart). Block: 64
// rows of one batch item and kPrologueHeads heads, 256 threads, one chunk
// pair a thread, which loads its cos/sin entries once for those heads.
constexpr int kPrologueHeads = 4;

__global__ void __launch_bounds__(256)
rope_attention_tc_rope_k_kernel(const __nv_bfloat16* __restrict__ k, long long row_stride,
                                const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                __nv_bfloat16* __restrict__ k_roped, int seq, int num_heads) {
  const int b = blockIdx.y;
  const int row = blockIdx.x * 64 + (threadIdx.x >> 2);
  if (row >= seq) return;
  const int pair = threadIdx.x & 3;
  const int c = (pair & 1) | ((pair & 2) << 1);  // 0, 1, 4, 5
  PairTables tables;
  tables.load(cos_t + (size_t)row * kD, sin_t + (size_t)row * kD, c);
  const __nv_bfloat16* src = k + ((long long)b * seq + row) * row_stride;
#pragma unroll
  for (int i = 0; i < kPrologueHeads; ++i) {
    const int h = blockIdx.z * kPrologueHeads + i;
    if (h >= num_heads) break;
    uint4 lo, hi;
    rope_pair(src + h * kD, tables, c, lo, hi);
    __nv_bfloat16* dst = k_roped + (((long long)b * num_heads + h) * seq + row) * kD;
    *reinterpret_cast<uint4*>(dst + 8 * c) = lo;
    *reinterpret_cast<uint4*>(dst + 8 * c + 16) = hi;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rope_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ v,
                         long long row_stride,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         const __nv_bfloat16* __restrict__ k_roped,
                         __nv_bfloat16* __restrict__ out, int seq, int num_heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t q_smem = base;
  const uint32_t ring = base + kQBytes;  // stage s: K at ring + s*kStageBytes, V after it
  const uint32_t full_bar = base + kBarOffset;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * seq * row_stride + (long long)h * kD;
  const int ntiles = (seq + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 128);                  // the producer's threads
      mbar_init(empty_bar + 8 * s, 128 * kConsumers);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: K (roped) and V tiles into the ring ----
    const int ptid = tid - 128 * kConsumers;
    const __nv_bfloat16* kr = k_roped + ((long long)b * num_heads + h) * seq * kD;
    const __nv_bfloat16* vb = v + in_off;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      mbar_wait(empty_bar + 8 * s, ((t / kStages) & 1) ^ 1);
      const uint32_t k_smem = ring + s * kStageBytes;
      const uint32_t v_smem = k_smem + kTileBytes;
      const int key0 = t * kTile;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int idx = ptid + 128 * it;  // 64 rows x 8 chunks
        const int r = idx >> 3;
        const int c = idx & 7;
        const bool valid = key0 + r < seq;
        const long long row = valid ? key0 + r : 0;
        cp_async16(v_smem + swizzle(r, c), vb + row * row_stride + 8 * c, valid);
        cp_async16(k_smem + swizzle(r, c), kr + row * kD + 8 * c, valid);
      }
      cp_async_wait_all();
      fence_async_shared();
      mbar_arrive(full_bar + 8 * s);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    const int ctid = tid - 128 * wg;
    const int warp = ctid >> 5;
    const int lane = ctid & 31;
    const int row_base = blockIdx.x * kBlockRows + wg * kRowsPerWg;
    const uint32_t my_q = q_smem + wg * kRowsPerWg * kRowBytes;
    rope_rows(q + in_off, row_stride, cos_t, sin_t, row_base, seq, my_q, ctid);
    fence_async_shared();
    named_barrier(1 + wg, 128);

    // accumulator fragment: thread owns rows g and g + 8 of its warp's 16,
    // columns 8i + 2t + {0, 1}; d[4i + e] is row g + 8*(e >> 1), column
    // 8i + 2t + (e & 1)
    const int g = lane >> 2;
    const int tq = lane & 3;
    float o[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = sc[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};
    const uint64_t q_desc = smem_desc(my_q);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full_bar + 8 * s, (t / kStages) & 1);
      const uint32_t k_smem = ring + s * kStageBytes;
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
      mbar_arrive(empty_bar + 8 * s);
    }

    // the row sums were kept per thread over its columns; the quad holds the row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int c = num_heads * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_base + 16 * warp + g + 8 * r;
      if (row >= seq) continue;  // rows past the sequence are computed, not stored
      __nv_bfloat16* orow = out + ((long long)b * seq + row) * c + h * kD;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = o[4 * i + 2 * r] / l[r];
        const float y = o[4 * i + 2 * r + 1] / l[r];
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * tq) = __floats2bfloat162_rn(x, y);
      }
    }
  }
}

}  // namespace

extern "C" {

// q/k/v: bf16 base pointers of [batch, seq, *] rows `row_stride` elements
// apart (head h at column h*64), 16-byte aligned, row_stride % 8 == 0;
// cos/sin: float32 [seq, 64], 16-byte aligned; k_roped: bf16 scratch of
// [batch, num_heads, seq, 64], 16-byte aligned, written here; out: bf16
// [batch, seq, num_heads*64] contiguous. head_dim must be 64. Launches the
// RoPE prologue, then the attention kernel, on `stream`. Returns a
// cudaError_t code.
int t3d_rope_attention_tc(const void* q, const void* k, const void* v, long long row_stride,
                          const float* cos_t, const float* sin_t, void* k_roped, void* out,
                          int batch, int seq, int num_heads, int head_dim, float scale,
                          void* stream) {
  if (head_dim != kD || seq <= 0 || row_stride % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 rope_grid((seq + 63) / 64, batch, (num_heads + kPrologueHeads - 1) / kPrologueHeads);
  rope_attention_tc_rope_k_kernel<<<rope_grid, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), row_stride, cos_t, sin_t,
      static_cast<__nv_bfloat16*>(k_roped), seq, num_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rope_attention_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockRows - 1) / kBlockRows, num_heads, batch);
  rope_attention_tc_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(v), row_stride,
      cos_t, sin_t,
      static_cast<const __nv_bfloat16*>(k_roped), static_cast<__nv_bfloat16*>(out), seq,
      num_heads, scale);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
