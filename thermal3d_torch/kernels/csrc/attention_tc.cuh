// wgmma building blocks of the tensor-core attention kernels, CUDA C++ for
// sm_90a: rope_attention_tc.cu (K2/K3, fused RoPE) and attention_tc.cu
// (K4-K6, softmax attention on q/k that are already roped), whose key-tile
// loop is key_tile_attention.cuh, in bf16; attention_3xtf32.cu (K2-K6 in
// float32) on the same loop. Widths 16, 32, 64, 128 and 256 (kBuiltWidths;
// every other head dim zero-padded to one of them by the packed entries; the
// constants kD, kRowBytes and kTileBytes below are head_dim 64's, the
// one-pass K2/K3 kernel's).
//
// Operands in shared memory use the 128-byte swizzle (rows of 128 bytes,
// 8-row atoms of 1024 bytes, chunk c of row r at chunk c ^ (r % 8)), the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: Q and K as K-major
// operands of S = Q K^T (wgmma m64n64k16), V as the MN-major B operand of
// O += P V with P from the score registers converted to bf16. A row wider
// than 128 bytes (bf16 head_dim 128, float32 64 and 128) is split into
// panels of 128-byte rows, one after the other; a row narrower (bf16
// head_dim 16 and 32, float32 16) is one panel of 32- or 64-byte rows in
// the swizzle of that width (Rows below: CU_TENSOR_MAP_SWIZZLE_32B / 64B,
// the descriptor's layout types 3 and 2), so no operand carries padding.
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

// The head dims the direct entries serve, reading the operands in place
// (mirrored by flash_attention.py::DIRECT_HEAD_DIMS); they reject any other
// with cudaErrorInvalidValue.
inline bool serves_head_dim(int head_dim) {
  return head_dim == 16 || head_dim == 32 || head_dim == 64 || head_dim == 128;
}

// The widths the key-tile loop is instantiated at. Every other accepted
// head dim (a multiple of 4 up to 256) runs the packed entries at the
// smallest of these at least as wide, its operands zero-padded to it
// (mirrored by flash_attention.py::BUILT_WIDTHS and padded_width). Above
// 128 only 256 is built: a width of 192 (three bf16 panels, six float32
// ones) would cut D = 160's padding from 1.6x to 1.2x but was neither
// built nor measured, and D = 96 pads to 128 (192 bytes of bf16 is not a
// whole number of 128-byte panels, which key_tiles::RowTile needs).
constexpr int kBuiltWidths[] = {16, 32, 64, 128, 256};

// The built width a head dim runs at; 0 for one the kernels do not take.
inline int padded_width(int head_dim) {
  if (head_dim <= 0 || head_dim % 4) return 0;
  for (int w : kBuiltWidths)
    if (head_dim <= w) return w;
  return 0;
}

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

__device__ __forceinline__ void st_shared8(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive on named barrier `id` without waiting for it (the other side of a
// bar.sync of `threads` threads).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Hopper's register reallocation: every thread of a warpgroup runs it; a
// warpgroup that needs few registers gives them back (regs_down), one that
// needs many takes them (regs_up, which waits until they are free).
template <int N>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Rows of RB bytes (32, 64 or 128) in the RB-byte swizzle: 16-byte chunk c of
// row r stored at chunk c ^ ((r * RB / 128) % (RB / 16)), the pattern that
// repeats every 8 rows (an atom of 8 * RB bytes, aligned to its size).
template <int RB>
struct Rows {
  static_assert(RB == 32 || RB == 64 || RB == 128, "a swizzle of 32, 64 or 128 bytes");
  static constexpr uint64_t kLayout = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // descriptor's type

  // the byte offset of chunk c of row r
  static __device__ __forceinline__ uint32_t at(int row, int chunk) {
    return (uint32_t)(row * RB + ((chunk ^ ((row * RB >> 7) & (RB / 16 - 1))) << 4));
  }
  // a wgmma shared-memory matrix descriptor of 8-row atoms RB bytes wide,
  // 8 * RB bytes apart (SBO: 8 rows on, or 8 k-rows on for an MN-major
  // operand); `lbo`: the distance of two atoms along N of an MN-major
  // operand wider than one atom (unused otherwise)
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = 8 * RB) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(8 * RB >> 4) << 32) | (kLayout << 62);
  }
};

// head_dim 64's rows (128 bytes, 1024-byte atoms, chunk c of row r at chunk
// c ^ (r % 8)): the descriptor reads the same for the K-major and the
// MN-major use (one 64-wide atom along N)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) { return Rows<128>::desc(addr); }
__device__ __forceinline__ uint32_t swizzle(int row, int chunk) { return Rows<128>::at(row, chunk); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed wgmma groups, the newest,
// are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulator registers at this point of the program: reads after a
// wgmma wait may not move above it, writes before a wgmma may not sink below.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// m64nNk16 bf16 products (N in {16, 32, 64, 128, 256}) and m64nNk8 tf32
// ones (N in {16, 32, 64}) with A from registers: the PV of a head dim D = N (N / 2 accumulators a
// thread, the fragment layout of m64n64 continued over N / 8 column groups).
// N = 64 is wgmma_rs and wgmma_tf32_rs above.

// d += A B, m64n16k16, A from registers (4 x bf16x2), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n32k16, A from registers (4 x bf16x2), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n128k16, A from registers (4 x bf16x2), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n256k16, A from registers (4 x bf16x2), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A B, m64n16k8 tf32, A from registers (wgmma_tf32_rs's layout), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= A B, m64n32k8 tf32, A from registers (wgmma_tf32_rs's layout), B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_rs(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    static_assert(N == 256, "PV of 16, 32, 64, 128 or 256 columns");
    wgmma_rs_n256(d, a, b);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs_n(float (&d)[N / 2], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  if constexpr (N == 16) {
    wgmma_tf32_rs_n16(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "a tf32 PV of 16, 32 or 64 columns");
    wgmma_tf32_rs(d, a, b, accumulate);
  }
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
