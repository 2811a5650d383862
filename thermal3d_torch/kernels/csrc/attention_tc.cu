// K4 + K5 + K6 on Hopper tensor cores: softmax attention on q/k that are
// already roped, bf16 with head_dim 16, 32, 64 or 128, CUDA C++ for sm_90a
// (wgmma, TMA, mbarriers).
//
// Replaces three Pallas TPU kernels of thermal3d/kernels/flash_attention.py
// that compute one function, tiled three ways for the TPU: K4
// _attention_kernel (via _flash_attention_fwd_pallas), K5 _grouped_kernel
// and K6 _multihead_kernel. Their arithmetic (_attention_kernel): scores in
// float32 times scale, float32 exp and sum, p rounded to bf16 before PV, the
// division after PV; here over keys in tiles of 64 with an online softmax
// (running max and sum, O rescaled when the max moves). float32 runs
// attention_3xtf32.cu, and head dims outside {16, 32, 64, 128} the
// CUDA-core kernel of attention.cu (the wrapper's attention_route).
//
// What bounds it on an H100: the operations at the port's shapes (4*Sq*Sk*D
// flops a head; at Sq = Sk = 1024, D = 64 about 250x the bytes' time, at 196
// about 3x the other way), and, between a tile's two products, the CUDA
// cores' softmax, whose work a score does not shrink with D: at head_dim 64
// it takes longer than the tensor cores' share of the tile, at 16 and 32
// longer still. Design: the key-tile core of key_tile_attention.cuh, which
// K2/K3 share at S > 256: one block per (128 query rows, head, batch item),
// two warpgroups and two blocks an SM (one at head_dim 128), K and V tiles
// through a 4-stage TMA ring, tile t's QK^T issued with tile t-1's PV and
// tile t's softmax run while that PV does, O out by a TMA store. Each head
// dim is an instantiation (Bf16Tiles<D>: rows of 2D bytes as panels of
// min(128, 2D) bytes in the swizzle of that width, one TMA box a panel).
// What is K4-K6's own:
//   * Operands by 4-D tensor maps over (D, rows, heads, batch) with each
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

// K4-K6's operands of the key-tile core at head dim D: q, k, v and out by
// 4-D maps (encode_bf16_heads, boxes of a panel's columns x 64 rows), Q by
// TMA on the first stage.
template <int D>
struct SoftmaxOperands {
  using Tiles = key_tiles::Bf16Tiles<D>;
  using Tile = typename Tiles::Tile;
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const CUtensorMap* tm_o;
  int h, b;
  float c;  // scale * log2(e)

  static constexpr uint32_t kQBytes = Tiles::kQArea;  // both warpgroups' rows
  __device__ void load_q(uint32_t q_area, uint32_t bar, int block_row0) const {
#pragma unroll
    for (int w = 0; w < Tiles::kWgs; ++w)
#pragma unroll
      for (int j = 0; j < Tile::kPanels; ++j)
        tma_load_4d(q_area + w * Tiles::kWgQBytes + j * Tile::kPanel, tm_q, bar,
                    j * Tile::kBoxCols, block_row0 + w * kTile, h, b);
  }
  __device__ void load_k(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_load_4d(stage + j * Tile::kPanel, tm_k, bar, j * Tile::kBoxCols, kTile * t, h, b);
  }
  __device__ void load_v(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_load_4d(stage + j * Tile::kPanel, tm_v, bar, j * Tile::kBoxCols, kTile * t, h, b);
  }
  __device__ void stage_q(uint32_t, int, int, int, uint32_t) const {}  // Q came with stage 0
  __device__ void softmax(float (&sc)[32], int valid, int tq, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) const {
    if (valid < kTile) {
      key_tiles::exp2_softmax_tile<true>(sc, valid, c, tq, m, l, alpha);
    } else {
      key_tiles::exp2_softmax_tile<false>(sc, valid, c, tq, m, l, alpha);
    }
  }
  __device__ void store_o(uint32_t src, int row_base) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_store_4d(tm_o, src + j * Tile::kPanel, j * Tile::kBoxCols, row_base, h, b);
  }
};

template <int D>
__global__ void __launch_bounds__(key_tiles::Bf16Tiles<D>::kBlockThreads,
                                  key_tiles::Bf16Tiles<D>::kBlocksPerSm)
softmax_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o, int sk, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const SoftmaxOperands<D> op{&tm_q, &tm_k, &tm_v, &tm_o, (int)blockIdx.y, (int)blockIdx.z,
                              scale * kLog2e};
  key_tiles::attend<key_tiles::Bf16Tiles<D>>(smem_raw, op, sk);
}

// The byte stride a tensor map takes for an axis of size 1, which the kernel
// never steps along (the wrapper passes 0 there): one row.
long long size_one_stride_bytes(int head_dim) { return 2LL * head_dim; }

constexpr int kMaxDevices = 64;

// The kernel at head dim D on its four maps (q, k, v, out), its dynamic
// shared memory set once a device.
template <int D>
cudaError_t launch(const CUtensorMap (&maps)[4], int batch, int heads, int sq, int sk,
                   float scale, int device, cudaStream_t stream) {
  using Tiles = key_tiles::Bf16Tiles<D>;
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        softmax_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles::kSmem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid((sq + Tiles::kBlockRows - 1) / Tiles::kBlockRows, heads, batch);
  softmax_attention_tc_kernel<D><<<grid, Tiles::kBlockThreads, Tiles::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The byte strides the tensor maps of a call take, from `strides` as
// t3d_softmax_attention_tc gets them (12 values: (batch, head, row) of q,
// k, v, out in elements): 2 bytes an element, one row (2 * head_dim bytes)
// for an axis of size 1. Written to `bytes` (12 values). Mirrored by
// flash_attention.py::tc_map_strides.
void t3d_softmax_attention_tc_map_strides(const long long* strides, int batch, int heads, int sq,
                                          int sk, int head_dim, long long* bytes) {
  for (int i = 0; i < 12; ++i) {
    const int operand = i / 3;  // q, k, v, out
    const int rows = operand == 1 || operand == 2 ? sk : sq;
    const int extent = i % 3 == 0 ? batch : i % 3 == 1 ? heads : rows;
    bytes[i] = extent == 1 ? size_one_stride_bytes(head_dim) : 2 * strides[i];
  }
}

// q: [batch, heads, sq, D], k/v: [batch, heads, sk, D] and out: like q,
// bf16, D = head_dim of 16, 32, 64 or 128, each given by its base pointer
// and, in `strides` (12 values, host memory), the (batch, head, row)
// strides in elements of q, k, v, out; the head_dim axis is contiguous. Base
// pointers 16-byte aligned, strides multiples of 8 elements (the wrapper
// sends 0 for an axis of size 1). sq, sk >= 1. Launches on `stream`, on the
// current device. Returns a cudaError_t code.
int t3d_softmax_attention_tc(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int batch, int heads, int sq, int sk,
                             int head_dim, float scale, void* stream) {
  if (sq <= 0 || sk <= 0 || !serves_head_dim(head_dim))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  long long bytes[12];
  t3d_softmax_attention_tc_map_strides(strides, batch, heads, sq, sk, head_dim, bytes);
  const void* bases[4] = {q, k, v, out};
  const uint32_t box_cols = head_dim < 64 ? head_dim : 64;  // a panel row: min(128 B, the row)
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const uint64_t rows = i == 1 || i == 2 ? sk : sq;
    err = encode_bf16_heads(&maps[i], bases[i], rows, heads, batch, bytes[3 * i],
                            bytes[3 * i + 1], bytes[3 * i + 2], kTile, head_dim, box_cols);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 16: return (int)launch<16>(maps, batch, heads, sq, sk, scale, device, st);
    case 32: return (int)launch<32>(maps, batch, heads, sq, sk, scale, device, st);
    case 64: return (int)launch<64>(maps, batch, heads, sq, sk, scale, device, st);
    default: return (int)launch<128>(maps, batch, heads, sq, sk, scale, device, st);
  }
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
