// Hopper building blocks beside attention_tc.cuh's wgmma wrappers: tensor
// maps and TMA copies (cp.async.bulk.tensor), transaction-counted mbarriers
// and bulk-group waits. CUDA C++ for sm_90a.
//
// Tensor maps are encoded on the host with the CUDA driver API's
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the kernel libraries link cudart only), and passed to a kernel by value as
// a __grid_constant__ parameter. Every call encodes its own maps: the caching
// allocator hands the same address to another tensor later, so a map cached
// by pointer could describe the wrong tensor; a captured CUDA graph holds the
// maps by value.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (a benign race: every thread finds
// the same function); nullptr where the CUDA driver lacks it.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of `rank` dimensions (innermost first) with `dims`, byte `strides`
// of the outer ones and `box`, of 2-byte bf16 or 4-byte float32 elements,
// with the swizzle of the wgmma operands as wide as a box row (box[0]
// elements fill 32, 64 or 128 bytes: attention_tc.cuh's Rows). Elements of a
// box outside `dims` read as zeros and are not written.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                              cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const uint32_t row_bytes = box[0] * (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2);
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                       : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE) return cudaErrorInvalidValue;
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D bf16 map over `batch` items of `rows` rows of `width` elements, rows
// `row_stride` elements apart and items rows * row_stride apart, read and
// written in boxes of box_cols elements (16, 32 or 64: one swizzled row of
// 32, 64 or 128 bytes) x box_rows rows x 1 item. Rows >= `rows` of a box
// read as zeros and are not written: an item's box never reaches into the
// next item.
inline cudaError_t encode_bf16_rows(CUtensorMap* map, const void* base, uint64_t width,
                                    uint64_t rows, uint64_t batch, uint64_t row_stride,
                                    uint32_t box_rows, uint32_t box_cols = 64) {
  const cuuint64_t dims[3] = {width, rows, batch};
  const cuuint64_t strides[2] = {row_stride * 2, rows * row_stride * 2};  // bytes
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims, strides, box);
}

// A 4-D bf16 map over a [batch, heads, rows, width] operand given by its
// (batch, head, row) strides in bytes, which may come in any order (a
// [B,S,H,D] buffer read as [B,H,S,D] has its rows farther apart than its
// heads), read and written in boxes of box_cols elements x box_rows rows x 1
// head x 1 item, swizzled as encode_bf16_rows. Rows >= `rows` of a box read
// as zeros and are not written: a box never reaches into the next head or
// item.
inline cudaError_t encode_bf16_heads(CUtensorMap* map, const void* base, uint64_t rows,
                                     uint64_t heads, uint64_t batch, uint64_t batch_bytes,
                                     uint64_t head_bytes, uint64_t row_bytes, uint32_t box_rows,
                                     uint64_t width = 64, uint32_t box_cols = 64) {
  const cuuint64_t dims[4] = {width, rows, heads, batch};
  const cuuint64_t strides[3] = {row_bytes, head_bytes, batch_bytes};
  const cuuint32_t box[4] = {box_cols, box_rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box);
}

// The float32 forms of the two maps above: boxes of box_cols elements (32:
// 128 bytes; 16: 64 bytes) x box_rows rows, so a 64-wide row of a tile takes
// two boxes. encode_f32_rows: `batch` items of `rows` rows of `width`
// elements, rows `row_stride` elements apart, items `item_stride` elements
// apart.
inline cudaError_t encode_f32_rows(CUtensorMap* map, const void* base, uint64_t width,
                                   uint64_t rows, uint64_t batch, uint64_t row_stride,
                                   uint64_t item_stride, uint32_t box_cols = 32,
                                   uint32_t box_rows = 64) {
  const cuuint64_t dims[3] = {width, rows, batch};
  const cuuint64_t strides[2] = {row_stride * 4, item_stride * 4};  // bytes
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 3, dims, strides, box);
}

inline cudaError_t encode_f32_heads(CUtensorMap* map, const void* base, uint64_t rows,
                                    uint64_t heads, uint64_t batch, uint64_t batch_bytes,
                                    uint64_t head_bytes, uint64_t row_bytes, uint64_t width = 64,
                                    uint32_t box_cols = 32) {
  const cuuint64_t dims[4] = {width, rows, heads, batch};
  const cuuint64_t strides[3] = {row_bytes, head_bytes, batch_bytes};
  const cuuint32_t box[4] = {box_cols, 64, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, box);
}

// ---- device ---------------------------------------------------------------

// An mbarrier wait that traps after ~10 s (2^34 cycles) instead of hanging
// the card: a fault in a pipeline's accounting becomes a launch error.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// Arrive on a barrier and add `bytes` to the transactions its phase awaits.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One box of a 3-D map at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst (1024-byte aligned for the 128-byte swizzle); its
// bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D map at (c0, c1, c2, c3), as tma_load_3d.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory at src to a 3-D map at (c0, c1, c2); rows past
// the map's extent are dropped. Tracked by the issuing thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory at src to a 4-D map at (c0, c1, c2, c3), as
// tma_store_3d.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's stores have read their shared memory (it may be refilled).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The issuing thread's stores are complete in global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
