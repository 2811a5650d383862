// K4 + K5 + K6: softmax attention on pre-roped q/k, CUDA C++ for sm_90a.
//
// Replaces three Pallas TPU kernels of thermal3d/kernels/flash_attention.py
// that compute one function, tiled three ways for the TPU:
//   K4 _attention_kernel (via _flash_attention_fwd_pallas: [BH,S,D], S and
//      D padded to 128 and masked, 256-row q blocks);
//   K5 _grouped_kernel (via _flash_attention_fwd_grouped: [B,H,S,D], G heads
//      a program, no HBM padding, out-of-range V rows zeroed);
//   K6 _multihead_kernel (via _flash_attention_fwd_multihead: [B,H,S,D], all
//      heads of a batch item in one program).
// On Hopper the grid runs in parallel whatever the grouping, so one kernel
// serves all three; the wrappers (kernels/flash_attention.py) keep an entry
// and a launch count for each.
//
// Arithmetic, as _attention_kernel does it (:91-112):
//   scores = (q . k, operands in the storage type, accumulated in float32)
//            * scale; columns >= Sk take no part;
//   p = exp(scores - max) and its sum in float32;
//   out = (sum_j round_T(p_j) v_j, accumulated in float32) / sum, rounded to T.
// The keys are walked in tiles with an online softmax (attention_common.cuh):
// at S=1024 the K/V of one head are 256 KB in bf16, over the 227 KB a block
// may use. What bounds it on an H100, and the design, are in the note at the
// top of attention_common.cuh: operations bound the function; this kernel
// runs on CUDA cores. It serves float32 and head dims other than 64; bf16
// with head_dim 64 runs the tensor-core kernel of attention_tc.cu (the
// wrapper's attention_route).
//
// Any layout with a unit innermost stride is taken: the caller passes the
// batch, head and row strides of q, k, v and out, so [B,H,S,D] tensors and
// [B,S,H,D] views reach the kernel without a copy.
#include "attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, Strides qs, Strides ks,
                         Strides vs, Strides os, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t, int sq, int sk, int head_dim,
                         int tile, float scale) {
  attend_tiles<T, false>(q, k, v, out, qs, ks, vs, os, cos_t, sin_t, sq, sk, head_dim, tile,
                         scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const long long* st,
           int batch, int heads, int sq, int sk, int head_dim, float scale,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]};
  const Strides ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]};
  const Strides os{st[9], st[10], st[11]};
  return launch_tiled<T>(softmax_attention_kernel<T>, q, k, v, out, qs, ks, vs, os, nullptr,
                         nullptr, batch, heads, sq, sk, head_dim, scale, stream);
}

}  // namespace

extern "C" {

// q: [batch, heads, sq, head_dim], k/v: [batch, heads, sk, head_dim] and
// out: like q, each given by its base pointer and, in `strides` (12 values,
// host memory), the (batch, head, row) strides in elements of q, k, v, out;
// the head_dim axis is contiguous. head_dim % 4 == 0, <= 256; sq, sk >= 1.
// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t code.
int t3d_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                  const long long* strides, int batch, int heads, int sq, int sk,
                  int head_dim, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, strides, batch, heads, sq, sk, head_dim, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, strides, batch, heads, sq, sk, head_dim, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
