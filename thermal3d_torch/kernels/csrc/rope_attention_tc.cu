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
// Arithmetic, the Pallas kernel's: q and k roped in float32 from the cos/sin
// tables [S,64] (each product and the sum rounded separately, no FMA), then
// rounded to bf16; then the 64-key online softmax of attention_tc.cuh.
//
// What bounds it on an H100: at S=196 the bytes (qkv in, out; about 3x the
// operations' time at 989 TFLOP/s); at S=1024 the operations (4*S^2*64 a
// head, about 250x the bytes' time). Design: the block pipeline of
// attention_tc.cuh (one block per 128 query rows, head and batch item; two
// consumer warpgroups on wgmma, one producer warpgroup feeding a K/V ring).
//   * Each consumer warpgroup ropes its 64 query rows once into its Q buffer.
//   * K is roped once per head, by a prologue kernel launched just before
//     on the same stream (rope_k_kernel: [B,S,*] rows -> a bf16 [B,H,S,64]
//     scratch), which the producer copies from. Roping K tiles in the
//     producer instead repeats the RoPE for every 128 query rows (8 times a
//     head at S=1024) and measured slower at S=1024 on an H100: four warps
//     cannot rope a tile (8 KB of K, 32 KB of cos/sin tables) in the time
//     the consumers take to multiply one.
#include "attention_tc.cuh"

namespace {

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
  const TcSmem sm = tc_smem_init(smem_raw);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * seq * row_stride + (long long)h * kD;

  if (wg == kConsumers) {
    // producer: K (roped) and V tiles into the ring
    produce_tiles(k_roped + ((long long)b * num_heads + h) * seq * kD, kD, v + in_off, row_stride,
                  seq, sm, tid - 128 * kConsumers);
  } else {
    // consumers: 64 query rows each
    const int ctid = tid - 128 * wg;
    const int row_base = blockIdx.x * kBlockRows + wg * kRowsPerWg;
    const uint32_t my_q = sm.q + wg * kRowsPerWg * kRowBytes;
    rope_rows(q + in_off, row_stride, cos_t, sin_t, row_base, seq, my_q, ctid);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    float o[32], l[2];
    attend_key_tiles(my_q, sm, seq, scale, ctid & 31, o, l);
    const int c = num_heads * kD;
    store_rows(o, l, out + (long long)b * seq * c + (long long)h * kD, c, row_base, seq,
               ctid >> 5, ctid & 31);
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
