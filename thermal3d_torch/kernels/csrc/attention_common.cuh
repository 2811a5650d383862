// Shared pieces of the attention kernels, CUDA C++ for sm_90a:
// rope_attention.cu (K2/K3, fused RoPE) and attention.cu (K4-K6, plain
// softmax attention). Element access for float32 / bf16, warp reductions,
// the RoPE of one element, and the key-tile loop with an online softmax.
//
// The key-tile loop (attend_tiles) computes, for each query row,
//   scores = (q . k accumulated in float32) * scale,
//   out    = (sum_j round_T(p_j) v_j, accumulated in float32) / sum_j p_j,
// the arithmetic of the Pallas kernels (the division after PV, p rounded to
// the storage type T before PV), over keys that arrive in tiles of `tile`
// rows. Each tile's p_j = exp(s_j - m) is taken against the running max m
// of the row; when a later tile raises m, the float32 sum and accumulator
// are rescaled by exp(m_old - m_new). So p is rounded to T against a
// running max, not the final one: in float32 that changes only summation
// order; in bf16 the output is no longer bit-equal to a one-shot softmax,
// and stays within the same limits (2e-5 f32, 2^-6 bf16).
//
// What bounds it on an H100: at S=1024, D=64 the matmul flops (4*S^2*D a
// head) outweigh the bytes by ~250x, so the bound is operations. This
// version runs the products on CUDA cores (no wgmma), so it is far from
// that bound; the design keeps it simple and right. One block per (query
// tile of kWarps*R rows, head, batch item). Each warp owns R query rows
// (R = 4 in bf16, 1 in float32, as in the one-shot K2/K3 kernel) and keeps
// their running max, sum and output accumulator in registers. The block
// walks the keys in tiles: all threads stage a K tile (roped as it is
// loaded, for K2/K3) and a V tile in shared memory, then each warp scores
// its R rows against the tile (lane j on keys j, j+32, ...), updates the
// online softmax, and accumulates PV (lane l on output dims 2l, 2l+1, ...).
// K/V of a head are read once per block from device memory (L2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory one H100 block may use

// query rows a warp scores together, by element size (see rope_attention.cu)
__host__ __device__ constexpr int rows_per_warp(size_t elem) { return elem == 4 ? 1 : 4; }
constexpr int kMaxPairSlices = 4;  // head_dim <= 256: a lane owns <= 4 dim pairs
// K rows are D+4 elements apart: with D % 4 == 0 every row starts 16-byte
// (float) or 8-byte (bf16) aligned, and lane l's vector load starts at bank
// 4l (float, 8 lanes a phase) or 2l (bf16, 16 lanes a phase): no conflicts.
constexpr int kPad = 4;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// RoPE'd value of element d of one head's row, in float32.
template <typename T>
__device__ __forceinline__ float rope_at(const T* row, const float* cos_row,
                                         const float* sin_row, int d, int d4) {
  const bool even_quarter = ((d / d4) & 1) == 0;
  const float t = Elem<T>::load(row[d]);
  const float partner = Elem<T>::load(row[even_quarter ? d + d4 : d - d4]);
  const float r = even_quarter ? -partner : partner;
  return __fadd_rn(__fmul_rn(t, cos_row[d]), __fmul_rn(r, sin_row[d]));
}

// Where an operand lives, in elements: (b, h, row, d) is at
// base + b*batch + h*head + row*row + d.
struct Strides {
  long long batch, head, row;
};

// Shared memory of the key-tile loop: K tile [tile][D+4] T | V tile
// [tile][D] T | (16-B aligned) q rows [warps][R][D] f32 | probabilities
// [warps][R][tile] f32. `tile` is a multiple of 32.
__host__ __device__ inline size_t tiled_smem_bytes(int tile, int head_dim, size_t elem) {
  return align16((size_t)tile * (2 * head_dim + kPad) * elem) +
         (size_t)kWarps * rows_per_warp(elem) * (head_dim + tile) * sizeof(float);
}

// The largest key tile (128, 64 or 32 keys) whose buffers fit; 0 if none.
inline int pick_tile(int head_dim, size_t elem) {
  for (int tile = 128; tile >= 32; tile /= 2)
    if (tiled_smem_bytes(tile, head_dim, elem) <= kSmemLimit) return tile;
  return 0;
}

template <typename T>
__device__ __forceinline__ float load_row_elem(const T* row, const float* cos_t,
                                               const float* sin_t, int r, int d,
                                               int head_dim, bool rope) {
  if (!rope) return Elem<T>::load(row[d]);
  return rope_at(row, cos_t + (size_t)r * head_dim, sin_t + (size_t)r * head_dim, d,
                 head_dim / 4);
}

// Body of the key-tile kernels; see the note at the top. Grid:
// (ceil(sq / (kWarps*R)), heads, batch), kThreads threads, dynamic shared
// memory tiled_smem_bytes(tile, head_dim, sizeof(T)). kRope: RoPE q and k
// from the cos/sin tables [S, D] (needs sq == sk).
template <typename T, bool kRope>
__device__ __forceinline__ void attend_tiles(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             Strides qs, Strides ks, Strides vs, Strides os,
                                             const float* __restrict__ cos_t,
                                             const float* __restrict__ sin_t, int sq, int sk,
                                             int head_dim, int tile, float scale) {
  constexpr int R = rows_per_warp(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int kstride = head_dim + kPad;
  T* ktile = reinterpret_cast<T*>(smem);
  T* vtile = ktile + (size_t)tile * kstride;
  float* qrows =
      reinterpret_cast<float*>(smem + align16((size_t)tile * (2 * head_dim + kPad) * sizeof(T)));
  float* probs = qrows + kWarps * R * head_dim;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.batch + h * qs.head;
  const T* kb = k + b * ks.batch + h * ks.head;
  const T* vb = v + b * vs.batch + h * vs.head;
  T* ob = out + b * os.batch + h * os.head;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qrows + warp * R * head_dim;  // [R][D]
  float* pw = probs + warp * R * tile;      // [R][tile]
  // this warp's rows r0..r0+R-1; a row past the sequence (last block only)
  // is computed on the last row's data and not stored
  const int r0 = (blockIdx.x * kWarps + warp) * R;
  for (int idx = lane; idx < R * head_dim; idx += 32) {
    const int i = idx / head_dim;
    const int d = idx - i * head_dim;
    const int r = min(r0 + i, sq - 1);
    const float x = load_row_elem(qb + r * qs.row, cos_t, sin_t, r, d, head_dim, kRope);
    qw[idx] = Elem<T>::load(Elem<T>::store(x));  // q enters QK in the storage type
  }

  float m[R], l[R];
  float2 acc[R][kMaxPairSlices];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxPairSlices; ++t) acc[i][t] = make_float2(0.0f, 0.0f);
  }

  for (int j0 = 0; j0 < sk; j0 += tile) {
    const int n = min(tile, sk - j0);
    const int n4 = round4(n);
    __syncthreads();  // every warp is done with the previous tile (and qw is written)
    for (int idx = threadIdx.x; idx < n4 * head_dim; idx += kThreads) {
      const int j = idx / head_dim;
      const int d = idx - j * head_dim;
      if (j < n) {
        const int key = j0 + j;
        const float kx = load_row_elem(kb + key * ks.row, cos_t, sin_t, key, d, head_dim, kRope);
        ktile[j * kstride + d] = Elem<T>::store(kx);
        vtile[j * head_dim + d] = vb[key * vs.row + d];
      } else {
        vtile[j * head_dim + d] = Elem<T>::store(0.0f);  // pad rows meet p = 0
      }
    }
    __syncthreads();

    float tmax[R];
#pragma unroll
    for (int i = 0; i < R; ++i) tmax[i] = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const T* krow = ktile + j * kstride;
      float dot[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dot[i] = 0.0f;
      for (int d = 0; d < head_dim; d += 4) {
        const float4 kv = Elem<T>::load4(krow + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + i * head_dim + d);  // broadcast
          dot[i] = fmaf(qv.x, kv.x, dot[i]);
          dot[i] = fmaf(qv.y, kv.y, dot[i]);
          dot[i] = fmaf(qv.z, kv.z, dot[i]);
          dot[i] = fmaf(qv.w, kv.w, dot[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float s = dot[i] * scale;
        pw[i * tile + j] = s;
        tmax[i] = fmaxf(tmax[i], s);
      }
    }
    float tsum[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float m_new = fmaxf(m[i], warp_max(tmax[i]));  // finite: the tile has a key
      const float alpha = expf(m[i] - m_new);              // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int t = 0; t < kMaxPairSlices; ++t) {
        acc[i][t].x *= alpha;
        acc[i][t].y *= alpha;
      }
      tsum[i] = 0.0f;
    }
    for (int j = lane; j < n4; j += 32) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float e = j < n ? expf(pw[i * tile + j] - m[i]) : 0.0f;
        tsum[i] += e;
        pw[i * tile + j] = Elem<T>::load(Elem<T>::store(e));  // p enters PV in the storage type
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) l[i] += warp_sum(tsum[i]);
    __syncwarp();

    for (int jb = 0; jb < n4; jb += 4) {
      float pj[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + i * tile + jb);  // broadcast
        pj[i][0] = p4.x;
        pj[i][1] = p4.y;
        pj[i][2] = p4.z;
        pj[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = vtile + (jb + jj) * head_dim;
#pragma unroll
        for (int t = 0; t < kMaxPairSlices; ++t) {
          const int d = 2 * (lane + 32 * t);
          if (d < head_dim) {
            const float2 vv = Elem<T>::load2(vrow + d);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc[i][t].x = fmaf(pj[i][jj], vv.x, acc[i][t].x);
              acc[i][t].y = fmaf(pj[i][jj], vv.y, acc[i][t].y);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= sq) break;
    T* orow = ob + (r0 + i) * os.row;
#pragma unroll
    for (int t = 0; t < kMaxPairSlices; ++t) {
      const int d = 2 * (lane + 32 * t);
      if (d < head_dim) {
        orow[d] = Elem<T>::store(acc[i][t].x / l[i]);
        orow[d + 1] = Elem<T>::store(acc[i][t].y / l[i]);
      }
    }
  }
}

// Host side of a key-tile kernel: pick the tile, raise the shared-memory
// limit, launch on `stream`. Returns a cudaError_t code.
template <typename T, typename Kernel>
int launch_tiled(Kernel kernel, const void* q, const void* k, const void* v, void* out,
                 Strides qs, Strides ks, Strides vs, Strides os, const float* cos_t,
                 const float* sin_t, int batch, int heads, int sq, int sk, int head_dim,
                 float scale, cudaStream_t stream) {
  const int tile = pick_tile(head_dim, sizeof(T));
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem_bytes(tile, head_dim, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kWarps * rows_per_warp(sizeof(T));
  const dim3 grid((sq + rows - 1) / rows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, os, cos_t, sin_t, sq, sk, head_dim, tile, scale);
  return (int)cudaGetLastError();
}

}  // namespace
