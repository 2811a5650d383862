// K4 + K5 + K6 on Hopper tensor cores: softmax attention on q/k that are
// already roped, bf16 with head_dim 64, CUDA C++ for sm_90a (wgmma, TMA,
// mbarriers).
//
// Replaces three Pallas TPU kernels of thermal3d/kernels/flash_attention.py
// that compute one function, tiled three ways for the TPU: K4
// _attention_kernel (via _flash_attention_fwd_pallas), K5 _grouped_kernel
// and K6 _multihead_kernel. Their arithmetic (_attention_kernel): scores in
// float32 times scale, float32 exp and sum, p rounded to bf16 before PV, the
// division after PV; here over keys in tiles of 64 with an online softmax
// (running max and sum, O rescaled when the max moves). float32 and other
// head dims run the CUDA-core kernel of attention.cu (the wrapper's
// attention_route).
//
// What bounds it on an H100: the operations at the port's shapes (4*Sq*Sk*64
// flops a head; at Sq = Sk = 1024 about 250x the bytes' time, at 196 about
// 3x the other way), and, between a tile's two products, the CUDA cores'
// softmax, which at head_dim 64 takes longer than the tensor cores' share
// of the tile. Design: the key-tile core of key_tile_attention.cuh, which
// K2/K3 share at S > 256: one block per (128 query rows, head, batch item),
// two warpgroups and two blocks an SM, K and V tiles through two 4-stage
// TMA rings, tile t's QK^T issued with tile t-1's PV and tile t's softmax run
// while that PV does, O out by a TMA store.
// What is K4-K6's own:
//   * Operands by 4-D tensor maps over (64, rows, heads, batch) with each
//     operand's own strides, so the [B,S,H,D] views that attention_bshd
//     hands over reach the kernel without a copy; Q's map has Sq rows, K's
//     and V's Sk, so rows past either read as zeros and the store drops
//     output rows past Sq: a box never reaches into the next head or item.
//     Each warpgroup's 64 Q rows come by one TMA load on the first K/V
//     stage's barrier.
//   * The softmax step folds scale * log2(e) into one FFMA a score and takes
//     2^x on the MUFU unit (ex2.approx), for the running max and alpha too;
//     only the last key tile, where Sk - 64t < 64, is masked (a template
//     flag: full tiles carry no compare or select).
#include "key_tile_attention.cuh"

namespace {

// The online softmax of one 64-key tile on raw scores s (QK^T, unscaled),
// in place: with c = scale * log2(e), the running max m of s, p = 2^(s*c -
// m*c) in one FFMA and a MUFU op (exp(s*scale - max) up to rounding), alpha
// = 2^((m_old - m_new)*c), 0 on the first tile; keys past `valid` masked
// where kMask (the last tile only), p = 0 there. The float32 sum l moves
// with alpha; p's rounding to bf16 and O's rescale are the caller's.
template <bool kMask>
__device__ __forceinline__ void exp2_softmax_tile(float (&sc)[32], int valid, float c, int tq,
                                                  float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask && 8 * i + 2 * tq + (e & 1) >= valid) sc[4 * i + e] = -INFINITY;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[4 * i + e]);
    }
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);  // finite: every tile has a key
    alpha[r] = exp2_approx((m[r] - m_new) * c);  // 2^-inf = 0 on the first tile
    m[r] = m_new;
    mc[r] = m_new * c;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], c, -mc[(i >> 1) & 1]));  // masked: 2^-inf = 0
    l[(i >> 1) & 1] += sc[i];
  }
}

// K4-K6's operands of the key-tile core: q, k, v and out by 4-D maps
// (encode_bf16_heads, boxes of 64 rows), Q by TMA on the first stage.
struct SoftmaxOperands {
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const CUtensorMap* tm_o;
  int h, b;
  float c;  // scale * log2(e)

  static constexpr uint32_t kQBytes = key_tiles::Bf16Tiles::kQArea;  // both warpgroups' rows
  __device__ void load_q(uint32_t q_area, uint32_t bar, int block_row0) const {
#pragma unroll
    for (int w = 0; w < key_tiles::kWgs; ++w)
      tma_load_4d(q_area + w * kTileBytes, tm_q, bar, 0, block_row0 + w * kTile, h, b);
  }
  __device__ void load_k(uint32_t stage, uint32_t bar, int t) const {
    tma_load_4d(stage, tm_k, bar, 0, kTile * t, h, b);
  }
  __device__ void load_v(uint32_t stage, uint32_t bar, int t) const {
    tma_load_4d(stage, tm_v, bar, 0, kTile * t, h, b);
  }
  __device__ void stage_q(uint32_t, int, int, int, uint32_t) const {}  // Q came with stage 0
  __device__ void softmax(float (&sc)[32], int valid, int tq, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) const {
    if (valid < kTile) {
      exp2_softmax_tile<true>(sc, valid, c, tq, m, l, alpha);
    } else {
      exp2_softmax_tile<false>(sc, valid, c, tq, m, l, alpha);
    }
  }
  __device__ void store_o(uint32_t src, int row_base) const {
    tma_store_4d(tm_o, src, 0, row_base, h, b);
  }
};

__global__ void __launch_bounds__(key_tiles::kBlockThreads, key_tiles::Bf16Tiles::kBlocksPerSm)
softmax_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o, int sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const SoftmaxOperands op{&tm_q, &tm_k, &tm_v, &tm_o, (int)blockIdx.y, (int)blockIdx.z,
                           scale * kLog2e};
  key_tiles::attend<key_tiles::Bf16Tiles>(smem_raw, op, sk);
}

// The byte stride a tensor map takes for an axis of size 1, which the kernel
// never steps along (the wrapper passes 0 there): one row.
constexpr long long kSizeOneStrideBytes = kRowBytes;

constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// The byte strides the tensor maps of a call take, from `strides` as
// t3d_softmax_attention_tc gets them (12 values: (batch, head, row) of q,
// k, v, out in elements): 2 bytes an element, kSizeOneStrideBytes for an
// axis of size 1. Written to `bytes` (12 values). Mirrored by
// flash_attention.py::tc_map_strides.
void t3d_softmax_attention_tc_map_strides(const long long* strides, int batch, int heads, int sq,
                                          int sk, long long* bytes) {
  for (int i = 0; i < 12; ++i) {
    const int operand = i / 3;  // q, k, v, out
    const int rows = operand == 1 || operand == 2 ? sk : sq;
    const int extent = i % 3 == 0 ? batch : i % 3 == 1 ? heads : rows;
    bytes[i] = extent == 1 ? kSizeOneStrideBytes : 2 * strides[i];
  }
}

// q: [batch, heads, sq, 64], k/v: [batch, heads, sk, 64] and out: like q,
// bf16, each given by its base pointer and, in `strides` (12 values, host
// memory), the (batch, head, row) strides in elements of q, k, v, out; the
// head_dim axis is contiguous. Base pointers 16-byte aligned, strides
// multiples of 8 elements (the wrapper sends 0 for an axis of size 1).
// sq, sk >= 1. Launches on `stream`, on the current device. Returns a
// cudaError_t code.
int t3d_softmax_attention_tc(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int batch, int heads, int sq, int sk,
                             int head_dim, float scale, void* stream) {
  if (head_dim != kD || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static bool ready[kMaxDevices];  // the kernel's shared memory, set once a device
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(softmax_attention_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               key_tiles::Bf16Tiles::kSmem);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  long long bytes[12];
  t3d_softmax_attention_tc_map_strides(strides, batch, heads, sq, sk, bytes);
  const void* bases[4] = {q, k, v, out};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const uint64_t rows = i == 1 || i == 2 ? sk : sq;
    err = encode_bf16_heads(&maps[i], bases[i], rows, heads, batch, bytes[3 * i],
                            bytes[3 * i + 1], bytes[3 * i + 2], kTile);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sq + key_tiles::kBlockRows - 1) / key_tiles::kBlockRows, heads, batch);
  softmax_attention_tc_kernel<<<grid, key_tiles::kBlockThreads, key_tiles::Bf16Tiles::kSmem,
                                (cudaStream_t)stream>>>(maps[0], maps[1], maps[2], maps[3], sk,
                                                        scale);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
