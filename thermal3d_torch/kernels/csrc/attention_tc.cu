// K4 + K5 + K6 on Hopper tensor cores: softmax attention on q/k that are
// already roped, bf16 at every head dim the wrappers accept (a multiple of
// 4 up to 256), CUDA C++ for sm_90a
// (wgmma, TMA, mbarriers).
//
// Replaces three Pallas TPU kernels of thermal3d/kernels/flash_attention.py
// that compute one function, tiled three ways for the TPU: K4
// _attention_kernel (via _flash_attention_fwd_pallas), K5 _grouped_kernel
// and K6 _multihead_kernel. Their arithmetic (_attention_kernel): scores in
// float32 times scale, float32 exp and sum, p rounded to bf16 before PV, the
// division after PV; here over keys in tiles of 64 with an online softmax
// (running max and sum, O rescaled when the max moves). float32 runs
// attention_3xtf32.cu (the wrapper's attention_route). Head dims 16, 32, 64
// and 128 take the direct entry; every other head dim, K2/K3's too (their
// RoPE in its prologue), the packed entry (t3d_attention_tc_packed, below):
//   * A prologue packs what TMA cannot read in place (q and k where they are
//     roped; any operand whose base or strides are not 16-byte multiples,
//     which includes every one at head dims of 4 mod 8) into a scratch
//     [B*H, S, Dp] zero-padded to Dp, the smallest built width at least as
//     wide (attention_tc.cuh's padded_width: 16, 32, 64, 128, 256); an
//     operand read in place has a 4-D map whose innermost extent is the
//     head dim, so the boxes of width Dp read zeros past it and never a lane
//     of the next head. QK^T over the zero lanes is exact.
//   * The key-tile loop at Dp (Bf16Tiles<Dp>; at 256 one warpgroup a block,
//     K and V in rings of their own) with K4-K6's exp2 step, and each row's
//     head_dim columns stored by the threads (key_tiles::store_rows): a TMA
//     box of a head 40 bytes wide cannot be written.
//   * The padding costs Dp/D of the products (1.6x at D = 80), and the pack
//     a read and a write of what it packs.
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
  static constexpr bool kThreadStore = false;         // out by TMA (store_o)
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

// ---- the packed route: every accepted head dim, zero-padded -----------------

// The pack prologue: those of q, k, v that `pack` names (bits 0, 1, 2),
// read by their (batch, head, row) strides at any alignment (key_tiles::
// load_quad), q and k roped where cos_t is not null (K2/K3, rounded to bf16
// as the direct kernels round them), into the scratch qp [B*H, Sq, Dp], kp
// and vp [B*H, Sk, Dp], lanes d .. Dp - 1 zero. Block: kPackRows rows of one
// (batch item, head), 256 threads, 4 elements a task (an 8-byte store); a
// thread issues the loads of all its tasks of an operand before it stores
// any (one round trip to memory an operand, not one a task). It reads no
// column of another head.
constexpr int kPackRows = 32;

template <int Dp>
__global__ void __launch_bounds__(256)
attention_pack_kernel(const __nv_bfloat16* __restrict__ q, key_tiles::HeadStrides qs,
                      const __nv_bfloat16* __restrict__ k, key_tiles::HeadStrides ks,
                      const __nv_bfloat16* __restrict__ v, key_tiles::HeadStrides vs,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      __nv_bfloat16* __restrict__ qp, __nv_bfloat16* __restrict__ kp,
                      __nv_bfloat16* __restrict__ vp, int heads, int sq, int sk, int d,
                      int pack) {
  constexpr int kQuads = Dp / 4;                                  // tasks a row
  constexpr int kTasks = (kPackRows * kQuads + 255) / 256;        // tasks a thread
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const int row0 = blockIdx.x * kPackRows;
  for (int which = 0; which < 3; ++which) {  // q, k, v
    if (!((pack >> which) & 1)) continue;
    const int rows = which == 0 ? sq : sk;
    const key_tiles::HeadStrides st = which == 0 ? qs : which == 1 ? ks : vs;
    const __nv_bfloat16* src = (which == 0 ? q : which == 1 ? k : v) + b * st.batch + h * st.head;
    __nv_bfloat16* dst = (which == 0 ? qp : which == 1 ? kp : vp) + bh * rows * Dp;
    const bool rope = which < 2 && cos_t != nullptr;
    float x[kTasks][4];
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int task = threadIdx.x + 256 * i;
      const int row = row0 + task / kQuads, e = 4 * (task % kQuads);
      if (task < kPackRows * kQuads && row < rows)
        key_tiles::packed_quad(src + row * st.row, e, d,
                               rope ? cos_t + (size_t)row * d : nullptr,
                               rope ? sin_t + (size_t)row * d : nullptr, x[i]);
    }
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int task = threadIdx.x + 256 * i;
      const int row = row0 + task / kQuads, e = 4 * (task % kQuads);
      if (task < kPackRows * kQuads && row < rows)
        *reinterpret_cast<uint2*>(dst + (long long)row * Dp + e) =
            make_uint2(pack_bf16(x[i][0], x[i][1]), pack_bf16(x[i][2], x[i][3]));
    }
  }
}

// K4-K6's operands over the pack's scratch (4-D maps of the contiguous
// [B, H, S, Dp] buffers), the output's first d columns stored by the
// threads (out: the head's row 0, rows out_row elements apart).
template <int Dp>
struct PackedOperands : SoftmaxOperands<Dp> {
  using Tile = typename SoftmaxOperands<Dp>::Tile;
  __nv_bfloat16* out;
  long long out_row;
  int d, sq;

  static constexpr bool kThreadStore = true;
  __device__ void store_rows(const unsigned char* tile, int row_base, int ctid) const {
    key_tiles::store_rows<Tile>(tile, out, out_row, d, row_base, sq, ctid);
  }
};

template <int Dp>
__global__ void __launch_bounds__(key_tiles::Bf16Tiles<Dp>::kBlockThreads,
                                  key_tiles::Bf16Tiles<Dp>::kBlocksPerSm)
packed_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* out,
                           long long out_batch, long long out_head, long long out_row, int sq,
                           int sk, int d, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const PackedOperands<Dp> op{{&tm_q, &tm_k, &tm_v, nullptr, h, b, scale * kLog2e},
                              out + b * out_batch + h * out_head,
                              out_row,
                              d,
                              sq};
  key_tiles::attend<key_tiles::Bf16Tiles<Dp>>(smem_raw, op, sk);
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

// The packed route at width Dp: the operands TMA cannot read in place (q
// and k wherever they are roped) packed into the scratch (qp, kp, vp one
// after the other), then the key-tile kernel on 4-D maps of each operand,
// in place or packed; the kernel's dynamic shared memory set once a device.
template <int Dp>
cudaError_t launch_packed(const void* q, const void* k, const void* v, void* out,
                          const long long* strides, const float* cos_t, const float* sin_t,
                          void* scratch, int batch, int heads, int sq, int sk, int d, float scale,
                          int device, cudaStream_t st) {
  using Tiles = key_tiles::Bf16Tiles<Dp>;
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(packed_attention_tc_kernel<Dp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles::kSmem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const long long bh = (long long)batch * heads;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* kp = qp + bh * sq * Dp;
  __nv_bfloat16* vp = kp + bh * sk * Dp;
  const void* bases[3] = {q, k, v};
  const __nv_bfloat16* packed[3] = {qp, kp, vp};
  int pack = 0;
  for (int i = 0; i < 3; ++i)
    if ((i < 2 && cos_t != nullptr) || !key_tiles::in_place(bases[i], strides, i, d, 2))
      pack |= 1 << i;
  if (pack) {
    using HS = key_tiles::HeadStrides;
    const dim3 pack_grid(((sq > sk ? sq : sk) + kPackRows - 1) / kPackRows, heads, batch);
    attention_pack_kernel<Dp><<<pack_grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), HS{strides[0], strides[1], strides[2]},
        static_cast<const __nv_bfloat16*>(k), HS{strides[3], strides[4], strides[5]},
        static_cast<const __nv_bfloat16*>(v), HS{strides[6], strides[7], strides[8]}, cos_t,
        sin_t, qp, kp, vp, heads, sq, sk, d, pack);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const uint64_t rows = i == 0 ? sq : sk;
    if ((pack >> i) & 1) {
      err = encode_bf16_heads(&maps[i], packed[i], rows, heads, batch, 2ull * heads * rows * Dp,
                              2ull * rows * Dp, 2ull * Dp, kTile, Dp, Tiles::Tile::kBoxCols);
    } else {
      uint64_t bytes[3];
      key_tiles::operand_bytes(strides, i, d, 2, bytes);
      err = encode_bf16_heads(&maps[i], bases[i], rows, heads, batch, bytes[0], bytes[1],
                              bytes[2], kTile, d, Tiles::Tile::kBoxCols);
    }
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + Tiles::kBlockRows - 1) / Tiles::kBlockRows, heads, batch);
  packed_attention_tc_kernel<Dp><<<grid, Tiles::kBlockThreads, Tiles::kSmem, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), strides[9], strides[10],
      strides[11], sq, sk, d, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The built width a head dim runs at (attention_tc.cuh::padded_width): the
// smallest of 16, 32, 64, 128 and 256 at least as wide; 0 for a head dim the
// kernels do not take. Mirrored by flash_attention.py::padded_width.
int t3d_attention_tc_padded_width(int head_dim) { return padded_width(head_dim); }

// Bytes of the scratch t3d_attention_tc_packed takes: bf16 [batch*heads, sq,
// Dp] for q, then [batch*heads, sk, Dp] for k and for v, Dp the padded width.
unsigned long long t3d_attention_tc_packed_scratch_bytes(int batch, int heads, int sq, int sk,
                                                         int head_dim) {
  return 2ull * batch * heads * ((unsigned long long)sq + 2ull * sk) * padded_width(head_dim);
}

// K2-K6 in bf16 at any head_dim the kernels take (a multiple of 4 up to
// 256), the operands packed first: q [batch, heads, sq, head_dim], k/v
// [batch, heads, sk, head_dim] and out like q, each by its base pointer and,
// in `strides` (12 values, host memory), the (batch, head, row) strides in
// elements of q, k, v, out (0 for an axis of size 1); the head_dim axis is
// contiguous. q, k and v at any alignment; out 8-byte aligned, its strides
// multiples of 4. cos/sin: float32 [sq, head_dim] tables to rope q and k with
// (K2/K3, sq == sk), or null (K4-K6). scratch: of
// t3d_attention_tc_packed_scratch_bytes, 16-byte aligned. Launches the pack
// and the key-tile kernel at the padded width on `stream`, on the current
// device. Returns a cudaError_t code.
int t3d_attention_tc_packed(const void* q, const void* k, const void* v, void* out,
                            const long long* strides, const float* cos_t, const float* sin_t,
                            void* scratch, int batch, int heads, int sq, int sk, int head_dim,
                            float scale, void* stream) {
  const int dp = padded_width(head_dim);
  if (dp == 0 || sq <= 0 || sk <= 0 || scratch == nullptr || (cos_t != nullptr && sq != sk))
    return (int)cudaErrorInvalidValue;
  for (int i = 9; i < 12; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dp) {
    case 16:
      return (int)launch_packed<16>(q, k, v, out, strides, cos_t, sin_t, scratch, batch, heads,
                                    sq, sk, head_dim, scale, device, st);
    case 32:
      return (int)launch_packed<32>(q, k, v, out, strides, cos_t, sin_t, scratch, batch, heads,
                                    sq, sk, head_dim, scale, device, st);
    case 64:
      return (int)launch_packed<64>(q, k, v, out, strides, cos_t, sin_t, scratch, batch, heads,
                                    sq, sk, head_dim, scale, device, st);
    case 128:
      return (int)launch_packed<128>(q, k, v, out, strides, cos_t, sin_t, scratch, batch, heads,
                                     sq, sk, head_dim, scale, device, st);
    default:
      return (int)launch_packed<256>(q, k, v, out, strides, cos_t, sin_t, scratch, batch, heads,
                                     sq, sk, head_dim, scale, device, st);
  }
}

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
// bf16, D = head_dim of 16, 32, 64 or 128 (every other:
// t3d_attention_tc_packed), each given by its base pointer
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
