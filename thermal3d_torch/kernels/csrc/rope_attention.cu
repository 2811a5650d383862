// K2 + K3: fused 2-D RoPE + softmax attention, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel thermal3d/kernels/flash_attention.py::
// _fused_rope_kernel, reached through _fused_rope_attention_fwd (K2: the
// packed [B,S,3C] qkv projection of self-attention) and
// _fused_rope_xattn_fwd (K3: separate [B,S,C] projq/projk/projv outputs of
// the dual decoder's cross-attention). One kernel serves both: q, k and v
// are base pointers with a common row stride (3C for K2, C for K3).
//
// Arithmetic, as the Pallas kernel does it:
//   RoPE in float32 from the cos/sin tables [S,D] (rope.rope_tables layout),
//     t*cos + rot(t)*sin with rot(t) = [-t[d4:2d4], t[:d4], -t[3d4:], t[2d4:3d4]],
//     each product and the sum rounded separately (no FMA), then rounded to
//     the storage type T;
//   scores = (q . k accumulated in float32) * scale;
//   p = exp(scores - rowmax); denom = sum(p) in float32;
//   out = (sum_j round_T(p_j) v_j, accumulated in float32) / denom, rounded to T.
//
// What bounds it on an H100: at the serving shape (S=196, D=64, bf16) the
// function moves B*S*4C elements (qkv in, out) and does 4*B*H*S^2*D flops, so
// the bound is device memory by ~3x. Design: one block per (query-row tile of
// 64, head, batch item). The block stages the head's K (roped as it is loaded)
// and V for the whole sequence in shared memory (bf16: 25 KB each), so K/V are
// read from device memory once per tile and scores never leave the SM. Each
// warp owns groups of R query rows: RoPE on q into shared memory; lane j
// scores keys j, j+32, ... for the R rows at once; warp-shuffle max and sum;
// then each lane accumulates its pairs of output dims over all keys, again
// for R rows at once. On CUDA cores these loops are bound by issued
// instructions and dependent FMA chains, not by the card's memory: scoring R
// rows together lets every K and V load feed R rows and runs R independent
// accumulator chains. R is 4 in bf16. In float32 it is 1: K/V take twice the
// shared memory there, and the buffers of 4 rows would leave room for one
// block an SM instead of two, which measured slower on an H100. Loads are vectors: 4 elements of q and of a K row per
// load (K rows padded so that the 32 lanes, each on its own key, hit distinct
// banks), 4 probabilities and 2 elements of a V row per load. Each row's sums
// run in the same order as with one row a warp.
// This kernel uses CUDA cores, not tensor cores (wgmma), and holds all of
// K/V at once, so S is bounded by shared memory (S=196 fits). Longer
// sequences (MASt3R-512's S=1024) go to rope_attention_tiled_kernel, the
// key-tile loop with an online softmax of attention_common.cuh; the wrapper
// picks it when K/V of one head do not fit (t3d_rope_attention_smem_bytes).
#include "attention_common.cuh"

namespace {

constexpr int kRowsPerBlock = 64;

// Shared memory layout: K [S][D+4] T | V [S4][D] T (S4 = S rounded up to 4,
// pad rows zero) | (16-B aligned) q rows [warps][R][D] f32 |
// probabilities [warps][R][S4] f32 (pad entries zero).
__host__ __device__ inline size_t kv_bytes(int seq, int head_dim, size_t elem) {
  return align16(((size_t)seq * (head_dim + kPad) + (size_t)round4(seq) * head_dim) * elem);
}

__host__ __device__ inline size_t smem_bytes(int seq, int head_dim, size_t elem) {
  return kv_bytes(seq, head_dim, elem) +
         (size_t)kWarps * rows_per_warp(elem) * (head_dim + round4(seq)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, long long row_stride,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      T* __restrict__ out, int seq, int num_heads, int head_dim,
                      float scale) {
  constexpr int kRowsPerWarp = rows_per_warp(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = head_dim + kPad;
  const int seq4 = round4(seq);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)seq * kstride;
  float* qs = reinterpret_cast<float*>(smem + kv_bytes(seq, head_dim, sizeof(T)));
  float* ps = qs + kWarps * kRowsPerWarp * head_dim;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d4 = head_dim / 4;
  const size_t in_off = (size_t)b * seq * row_stride + (size_t)h * head_dim;
  const T* qb = q + in_off;
  const T* kb = k + in_off;
  const T* vb = v + in_off;
  const int c = num_heads * head_dim;
  T* ob = out + (size_t)b * seq * c + (size_t)h * head_dim;

  for (int idx = threadIdx.x; idx < seq4 * head_dim; idx += kThreads) {
    const int j = idx / head_dim;
    const int d = idx - j * head_dim;
    if (j < seq) {
      const float kr = rope_at(kb + (size_t)j * row_stride, cos_t + (size_t)j * head_dim,
                               sin_t + (size_t)j * head_dim, d, d4);
      ks[j * kstride + d] = Elem<T>::store(kr);
      vs[j * head_dim + d] = vb[(size_t)j * row_stride + d];
    } else {
      vs[j * head_dim + d] = Elem<T>::store(0.0f);  // pad rows meet p = 0
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * kRowsPerWarp * head_dim;  // [R][D]
  float* pw = ps + warp * kRowsPerWarp * seq4;      // [R][S4]
  if (lane < seq4 - seq) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) pw[i * seq4 + seq + lane] = 0.0f;
  }
  __syncthreads();

  const int tile0 = blockIdx.x * kRowsPerBlock;
  const int row_end = min(seq, tile0 + kRowsPerBlock);
  for (int r0 = tile0 + warp * kRowsPerWarp; r0 < row_end; r0 += kWarps * kRowsPerWarp) {
    // rows r0..r0+R-1; a row past the sequence (last tile only) is computed
    // on the last row's data and not stored
    for (int idx = lane; idx < kRowsPerWarp * head_dim; idx += 32) {
      const int i = idx / head_dim;
      const int d = idx - i * head_dim;
      const int r = min(r0 + i, seq - 1);
      const float qr = rope_at(qb + (size_t)r * row_stride, cos_t + (size_t)r * head_dim,
                               sin_t + (size_t)r * head_dim, d, d4);
      qw[idx] = Elem<T>::load(Elem<T>::store(qr));
    }
    __syncwarp();

    float mx[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = -INFINITY;
    for (int j = lane; j < seq; j += 32) {
      const T* krow = ks + j * kstride;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i] = 0.0f;
      for (int d = 0; d < head_dim; d += 4) {
        const float4 kv = Elem<T>::load4(krow + d);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * head_dim + d);  // broadcast
          acc[i] = fmaf(qv.x, kv.x, acc[i]);
          acc[i] = fmaf(qv.y, kv.y, acc[i]);
          acc[i] = fmaf(qv.z, kv.z, acc[i]);
          acc[i] = fmaf(qv.w, kv.w, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float s = acc[i] * scale;
        pw[i * seq4 + j] = s;
        mx[i] = fmaxf(mx[i], s);
      }
    }
    float sum[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      mx[i] = warp_max(mx[i]);
      sum[i] = 0.0f;
    }
    for (int j = lane; j < seq; j += 32) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float e = expf(pw[i * seq4 + j] - mx[i]);
        sum[i] += e;
        pw[i * seq4 + j] = Elem<T>::load(Elem<T>::store(e));  // p enters PV in the storage type
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sum[i] = warp_sum(sum[i]);
    __syncwarp();

    float2 acc[kRowsPerWarp][kMaxPairSlices];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int t = 0; t < kMaxPairSlices; ++t) acc[i][t] = make_float2(0.0f, 0.0f);
    }
    for (int j0 = 0; j0 < seq4; j0 += 4) {
      float pj[kRowsPerWarp][4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + i * seq4 + j0);  // broadcast
        pj[i][0] = p4.x;
        pj[i][1] = p4.y;
        pj[i][2] = p4.z;
        pj[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = vs + (j0 + jj) * head_dim;
#pragma unroll
        for (int t = 0; t < kMaxPairSlices; ++t) {
          const int d = 2 * (lane + 32 * t);
          if (d < head_dim) {
            const float2 vv = Elem<T>::load2(vrow + d);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              acc[i][t].x = fmaf(pj[i][jj], vv.x, acc[i][t].x);
              acc[i][t].y = fmaf(pj[i][jj], vv.y, acc[i][t].y);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (r0 + i >= seq) break;
      T* orow = ob + (size_t)(r0 + i) * c;
#pragma unroll
      for (int t = 0; t < kMaxPairSlices; ++t) {
        const int d = 2 * (lane + 32 * t);
        if (d < head_dim) {
          orow[d] = Elem<T>::store(acc[i][t].x / sum[i]);
          orow[d + 1] = Elem<T>::store(acc[i][t].y / sum[i]);
        }
      }
    }
    __syncwarp();  // qw/pw are rewritten for the next rows
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, long long row_stride,
           const float* cos_t, const float* sin_t, void* out, int batch, int seq,
           int num_heads, int head_dim, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(seq, head_dim, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      rope_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kRowsPerBlock - 1) / kRowsPerBlock, num_heads, batch);
  rope_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      row_stride, cos_t, sin_t, static_cast<T*>(out), seq, num_heads, head_dim, scale);
  return (int)cudaGetLastError();
}

// K2/K3 for long sequences: the key-tile loop with RoPE on q and k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_attention_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out, Strides qs,
                            Strides ks, Strides vs, Strides os, const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t, int sq, int sk, int head_dim,
                            int tile, float scale) {
  attend_tiles<T, true>(q, k, v, out, qs, ks, vs, os, cos_t, sin_t, sq, sk, head_dim, tile,
                        scale);
}

template <typename T>
int launch_long(const void* q, const void* k, const void* v, long long row_stride,
                const float* cos_t, const float* sin_t, void* out, int batch, int seq,
                int num_heads, int head_dim, float scale, cudaStream_t stream) {
  const Strides in{(long long)seq * row_stride, head_dim, row_stride};
  const long long c = (long long)num_heads * head_dim;
  const Strides o{seq * c, head_dim, c};
  return launch_tiled<T>(rope_attention_tiled_kernel<T>, q, k, v, out, in, in, in, o, cos_t,
                         sin_t, batch, num_heads, seq, seq, head_dim, scale, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; elem_size is 4 (float32) or 2 (bf16).
unsigned long long t3d_rope_attention_smem_bytes(int seq, int head_dim, int elem_size) {
  return (unsigned long long)smem_bytes(seq, head_dim, (size_t)elem_size);
}

// q/k/v: base pointers of [batch, seq, *] rows with `row_stride` elements
// between consecutive rows (head h at column h*head_dim); out: [batch, seq,
// num_heads*head_dim] contiguous. head_dim % 4 == 0, <= 256. dtype: 0 float32,
// 1 bfloat16. Returns a cudaError_t code.
int t3d_rope_attention(int dtype, const void* q, const void* k, const void* v,
                       long long row_stride, const float* cos_t, const float* sin_t,
                       void* out, int batch, int seq, int num_heads, int head_dim,
                       float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, row_stride, cos_t, sin_t, out, batch, seq, num_heads,
                         head_dim, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, row_stride, cos_t, sin_t, out, batch, seq,
                                 num_heads, head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The same function for sequences whose K/V do not fit in one block's
// shared memory: the key-tile loop. Same arguments and return.
int t3d_rope_attention_tiled(int dtype, const void* q, const void* k, const void* v,
                             long long row_stride, const float* cos_t, const float* sin_t,
                             void* out, int batch, int seq, int num_heads, int head_dim,
                             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_long<float>(q, k, v, row_stride, cos_t, sin_t, out, batch, seq, num_heads,
                              head_dim, scale, s);
  if (dtype == 1)
    return launch_long<__nv_bfloat16>(q, k, v, row_stride, cos_t, sin_t, out, batch, seq,
                                      num_heads, head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
