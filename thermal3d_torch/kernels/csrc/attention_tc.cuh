// wgmma building blocks of the tensor-core attention kernels, CUDA C++ for
// sm_90a: rope_attention_tc.cu (K2/K3, fused RoPE) and attention_tc.cu
// (K4-K6, softmax attention on q/k that are already roped), whose key-tile
// loop is key_tile_attention.cuh, in bf16; attention_3xtf32.cu (K2-K6 in
// float32) on the same loop. head_dim 64.
//
// Operands in shared memory use the 128-byte swizzle (rows of 128 bytes,
// 8-row atoms of 1024 bytes, chunk c of row r at chunk c ^ (r % 8)), the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: Q and K as K-major
// operands of S = Q K^T (wgmma m64n64k16), V as the MN-major B operand of
// O += P V with P from the score registers converted to bf16.
//
// float32 (3xTF32): each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna.tf32.f32), and each product is hi*hi + hi*lo +
// lo*hi, three wgmma m64n64k8 .tf32 products accumulating in float32. A
// float32 row of 64 is 256 bytes, so a 64-row operand is two 128-byte-wide
// halves (d 0-31, then d 32-63), 8 KB each, one after the other. tf32
// operands in shared memory must be K-major (the transpose bits are for
// 16-bit types only), so V enters P V transposed, as V^T [d][key].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head_dim
constexpr int kTile = 64;         // keys a tile (wgmma N of Q K^T, K of P V), query rows a warpgroup
constexpr int kRowBytes = kD * 2;                      // one bf16 row, 128 B
constexpr int kTileBytes = kTile * kRowBytes;          // 8 KB

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Generic-proxy writes to shared memory (st.shared) made visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d (+)= A B, m64n64k8 tf32, A and B (K-major) from shared memory.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " T3D_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : T3D_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k8 tf32, A from registers (4 x tf32: rows g, g+8, g, g+8
// of the warp's 16, columns t, t, t+4, t+4; not the accumulator's layout of
// an 8-column group, which holds columns 2t and 2t+1), B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " T3D_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : T3D_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// x rounded to tf32, nearest with ties away from zero (its low 13 bits 0).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU unit (ex2.approx: a relative error of at most 2^-22;
// 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
