// K4 + K5 + K6 on Hopper tensor cores: softmax attention on q/k that are
// already roped, bf16 with head_dim 64, CUDA C++ for sm_90a (wgmma,
// mbarriers, cp.async).
//
// Replaces three Pallas TPU kernels of thermal3d/kernels/flash_attention.py
// that compute one function, tiled three ways for the TPU: K4
// _attention_kernel (via _flash_attention_fwd_pallas), K5 _grouped_kernel
// and K6 _multihead_kernel. Their arithmetic (_attention_kernel): scores in
// float32 times scale, float32 exp and sum, p rounded to bf16 before PV, the
// division after PV; here over keys in tiles of 64 with the online softmax
// of attention_tc.cuh, as the tensor-core K2/K3 kernel does it. float32 and
// other head dims run the CUDA-core kernel of attention.cu (the wrapper's
// attention_route).
//
// What bounds it on an H100: the operations at the port's shapes (4*Sq*Sk*64
// flops a head; at Sq = Sk = 1024 about 250x the bytes' time, at 196 about
// 3x the other way). Design: the block pipeline of attention_tc.cuh, one
// block per (128 query rows, head, batch item), with no RoPE and no
// prologue:
//   * each consumer warpgroup copies its 64 query rows into its swizzled Q
//     buffer as they are (rows >= Sq zero-filled), then walks the key tiles;
//   * the producer warpgroup copies K/V tiles straight from the inputs
//     (rows >= Sk zero-filled by cp.async, score columns >= Sk masked);
//   * query rows >= Sq are computed and not stored.
// q, k, v and out each come with their own (batch, head, row) strides, so
// the [B,S,H,D] views that attention_bshd hands over reach the kernel
// without a copy, and Sq and Sk are independent.
#include "attention_tc.cuh"

namespace {

// Where an operand lives, in elements: (b, h, row, d) is at
// base + b*batch + h*head + row*row + d.
struct Strides {
  long long batch, head, row;
};

// Copy rows [row0, row0 + 64) of one head into a swizzled bf16 operand
// buffer of 64 rows; rows >= seq are zero. 128 threads, tid in [0, 128).
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ x, long long row_stride,
                                          int row0, int seq, uint32_t dst, int tid) {
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = tid + 128 * it;  // 64 rows x 8 chunks
    const int r = idx >> 3;
    const int c = idx & 7;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq) val = *reinterpret_cast<const uint4*>(x + (long long)row * row_stride + 8 * c);
    st_shared16(dst + swizzle(r, c), val);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
softmax_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            Strides qs, Strides ks, Strides vs, Strides os, int sq, int sk,
                            float scale) {
  extern __shared__ unsigned char smem_raw[];
  const TcSmem sm = tc_smem_init(smem_raw);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (wg == kConsumers) {
    produce_tiles(k + b * ks.batch + h * ks.head, ks.row, v + b * vs.batch + h * vs.head, vs.row,
                  sk, sm, tid - 128 * kConsumers);
  } else {
    const int ctid = tid - 128 * wg;
    const int row_base = blockIdx.x * kBlockRows + wg * kRowsPerWg;
    const uint32_t my_q = sm.q + wg * kRowsPerWg * kRowBytes;
    load_rows(q + b * qs.batch + h * qs.head, qs.row, row_base, sq, my_q, ctid);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    float o[32], l[2];
    attend_key_tiles(my_q, sm, sk, scale, ctid & 31, o, l);
    store_rows(o, l, out + b * os.batch + h * os.head, os.row, row_base, sq, ctid >> 5,
               ctid & 31);
  }
}

}  // namespace

extern "C" {

// q: [batch, heads, sq, 64], k/v: [batch, heads, sk, 64] and out: like q,
// bf16, each given by its base pointer and, in `strides` (12 values, host
// memory), the (batch, head, row) strides in elements of q, k, v, out; the
// head_dim axis is contiguous. Base pointers 16-byte aligned, strides
// multiples of 8 elements. sq, sk >= 1. Returns a cudaError_t code.
int t3d_softmax_attention_tc(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int batch, int heads, int sq, int sk,
                             int head_dim, float scale, void* stream) {
  if (head_dim != kD || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaError_t err = cudaFuncSetAttribute(softmax_attention_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, heads, batch);
  softmax_attention_tc_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), qs, ks, vs, os, sq,
      sk, scale);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
