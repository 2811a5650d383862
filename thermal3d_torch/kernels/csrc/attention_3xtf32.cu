// K2-K6 in float32 on Hopper tensor cores, 3xTF32, at every head dim the
// wrappers accept (a multiple of 4 up to 256), CUDA C++ for sm_90a (wgmma,
// TMA, mbarriers).
//
// Replaces, for float32 operands (every call of a model at its default
// compute_dtype), the Pallas TPU kernels of
// thermal3d/kernels/flash_attention.py: _fused_rope_kernel (K2 through
// _fused_rope_attention_fwd on the packed [B,S,3C] projection, K3 through
// _fused_rope_xattn_fwd on separate [B,S,C] ones) and the softmax attention
// on q/k that are already roped, tiled three ways for the TPU: K4
// _attention_kernel, K5 _grouped_kernel, K6 _multihead_kernel. Head dims
// 16, 32, 64 and 128 take the direct entries below; every other head dim the
// packed entry (t3d_attention_3xtf32_packed, the end of this file).
//
// Arithmetic. The products run on tensor cores as 3xTF32 (attention_tc.cuh:
// x = hi + lo, each product hi*hi + hi*lo + lo*hi in float32, about 2^-21
// relative a product); everything else is float32 arithmetic as the plain
// version has it: RoPE from the cos/sin tables [S,D] with each product and
// the sum rounded separately (no FMA), scores times scale, a 64-key online
// softmax (key_tiles::online_softmax_tile: expf, running max and float32
// sum, O rescaled when the max moves, every tile masked), p kept in float32
// (split into hi and lo as PV's A operand), and the division after PV.
//
// What bounds it on an H100: the operations, 4*Sq*Sk*D flops a head at the
// 3xTF32 rate of 495/3 = 165 TFLOP/s (at S = 196 and S = 1024 above the
// bytes' time at 3.35 TB/s); on CUDA cores the float32 peak is 67 TFLOP/s.
// Design:
//   * A prologue (attention_3xtf32_split_kernel) reads each head's K and V
//     once, ropes K for K2/K3, and writes K's tf32 hi and lo ([B*H, S, D]
//     each) and V's, transposed ([B*H, D, S8], S8 = S rounded up to 8, the
//     keys of each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 that P's
//     A fragment takes, the padding zero), to a scratch the caller allocates
//     (t3d_attention_3xtf32_scratch_bytes). wgmma takes tf32 operands
//     K-major only, and V enters PV as the B operand [key][d], which is
//     MN-major: V^T is. Splitting once a head,
//     rather than in every block that reads a tile (8 blocks a head at S =
//     1024), keeps the loop's CUDA-core work to the softmax and P's split.
//   * The key-tile loop of key_tile_attention.cuh in its Tf32x3Tiles<D>
//     policy: one block per 128 query rows of a (batch item, head), two
//     warpgroups of 64 rows, one block an SM (at D = 64: Q hi/lo 64 KB; by
//     TMA, two stages of K hi and lo and two of V^T hi and lo, 32 KB each, a
//     K stage free once its QK^T is done, a V stage once its PV is); tile t's
//     QK^T (3 * D/8 wgmma m64n64k8) is issued with tile t-1's PV (24 more,
//     m64nDk8, P from registers), and tile t's softmax runs while that PV
//     does. Each tile's PV goes into a fresh accumulator that the CUDA cores
//     add to O (the tensor cores round an accumulator toward zero at every
//     step, and O over all 16 tiles at S=1024 drifted ~6e-6 from the plain
//     version; a tile at a time, ~9e-7 on an H100). At D = 128 a block is
//     one warpgroup of 64 rows with one K and one V stage (64 KB each beside
//     Q's 64 KB), its PV in two halves of 64 columns (the policy's header).
//     Q and K rows of D floats are panels of min(128, 4D) bytes, each one
//     TMA box, swizzled as wide as its rows (64 bytes at D = 16).
//   * Q: K2/K3's warpgroups rope and split their 64 rows from device memory
//     (stage_q); K4-K6's arrive by TMA (4-D maps of q's strides, so the
//     [B,S,H,D] views attention_bshd hands over need no copy) with the first
//     stage and are split in place. The prologue reads K4-K6's K and V by
//     their strides the same way.
//   * O / l in float32 out of the warpgroup's Q hi tile by a TMA store a
//     panel, rows past the query count dropped.
#include "key_tile_attention.cuh"

namespace {

using key_tiles::RowTile;
using key_tiles::Tf32x3Tiles;

using key_tiles::HeadStrides;

__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The 3xTF32 split of four values.
__device__ __forceinline__ void split4(const float (&x)[4], uint4& hi, uint4& lo) {
  split_tf32(x[0], hi.x, lo.x);
  split_tf32(x[1], hi.y, lo.y);
  split_tf32(x[2], hi.z, lo.z);
  split_tf32(x[3], hi.w, lo.w);
}

// The chunk pairs of a row at head dim D: elements d .. d+3 of an even
// quarter and d + D/4 .. d + D/4 + 3 of the odd quarter that follows, for
// pair 0 .. D/8 - 1; at D = 64, d in {0, 4, 8, 12, 32, 36, 40, 44}.
template <int D>
__device__ __forceinline__ int pair_col(int pair) {
  constexpr int kQuarter = D / 4, kPerQuarter = kQuarter / 4;
  return (pair % kPerQuarter) * 4 + (pair / kPerQuarter) * 2 * kQuarter;
}

// RoPE in place of a row's chunk pair (a: d .. d+3, b: d+Q .. d+Q+3, Q =
// D/4) from the row's cos/sin entries: t*cos + rot(t)*sin with rot(t) =
// -t[d+Q] on the even quarter and t[d-Q] on the odd, each product and the
// sum rounded separately (as the plain version rounds them).
template <int D>
__device__ __forceinline__ void rope_pair4(float (&a)[4], float (&b)[4],
                                           const float* __restrict__ cos_row,
                                           const float* __restrict__ sin_row, int d) {
  float ca[4], sa[4], cb[4], sb[4];
  load4(ca, cos_row + d);
  load4(sa, sin_row + d);
  load4(cb, cos_row + d + D / 4);
  load4(sb, sin_row + d + D / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = a[i], y = b[i];
    a[i] = __fadd_rn(__fmul_rn(x, ca[i]), __fmul_rn(-y, sa[i]));
    b[i] = __fadd_rn(__fmul_rn(y, cb[i]), __fmul_rn(x, sb[i]));
  }
}

// ---- the prologue: K and V split into tf32 hi and lo ------------------------

constexpr int kSplitRows = 64;  // keys a prologue block

// Block: 64 keys of one (batch item, head), 256 threads. K rows (roped where
// cos_t is not null) -> kh, kl [B*H, S, D]; V rows -> through shared memory
// -> vth, vtl [B*H, D, seq8], keys past S written as zeros.
template <int D>
__global__ void __launch_bounds__(256)
attention_3xtf32_split_kernel(const float* __restrict__ k, HeadStrides ks,
                              const float* __restrict__ v, HeadStrides vs,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              uint32_t* __restrict__ kh, uint32_t* __restrict__ kl,
                              uint32_t* __restrict__ vth, uint32_t* __restrict__ vtl, int seq,
                              int seq8, int heads) {
  __shared__ float vt[kSplitRows][D + 1];
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * kSplitRows;
  const long long bh = (long long)b * heads + h;
  const float* kb = k + b * ks.batch + h * ks.head;
  const float* vb = v + b * vs.batch + h * vs.head;
  for (int task = threadIdx.x; task < kSplitRows * (D / 8); task += blockDim.x) {
    const int row = row0 + task / (D / 8);
    if (row >= seq) break;  // tasks run row by row
    const int d = pair_col<D>(task % (D / 8));
    float a[4], c[4];
    load4(a, kb + row * ks.row + d);
    load4(c, kb + row * ks.row + d + D / 4);
    if (cos_t != nullptr)
      rope_pair4<D>(a, c, cos_t + (size_t)row * D, sin_t + (size_t)row * D, d);
    uint4 ah, al, ch, cl;
    split4(a, ah, al);
    split4(c, ch, cl);
    const long long at = (bh * seq + row) * D + d;
    *reinterpret_cast<uint4*>(kh + at) = ah;
    *reinterpret_cast<uint4*>(kh + at + D / 4) = ch;
    *reinterpret_cast<uint4*>(kl + at) = al;
    *reinterpret_cast<uint4*>(kl + at + D / 4) = cl;
  }
  for (int task = threadIdx.x; task < kSplitRows * (D / 4); task += blockDim.x) {
    const int r = task / (D / 4), d = (task % (D / 4)) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row0 + r < seq) load4(x, vb + (row0 + r) * vs.row + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) vt[r][d + i] = x[i];
  }
  __syncthreads();
  for (int task = threadIdx.x; task < D * 16; task += blockDim.x) {
    const int d = task >> 4, kq = (task & 15) * 4;
    if (row0 + kq >= seq8) continue;
    // positions kq .. kq+3 of an 8-key group hold its keys 0, 2, 4, 6 (kq % 8
    // == 0) or 1, 3, 5, 7: the order of P's columns in PV's A fragment
    const int k0 = (kq & ~7) + ((kq >> 2) & 1);
    const float x[4] = {vt[k0][d], vt[k0 + 2][d], vt[k0 + 4][d], vt[k0 + 6][d]};
    uint4 hi, lo;
    split4(x, hi, lo);
    const long long at = (bh * D + d) * seq8 + row0 + kq;
    *reinterpret_cast<uint4*>(vth + at) = hi;
    *reinterpret_cast<uint4*>(vtl + at) = lo;
  }
}

// ---- the key-tile kernels ---------------------------------------------------

// What K2/K3 and K4-K6 share at head dim D: the prologue's K hi/lo tiles
// (3-D maps, a box a panel: min(32, D) floats x 64 rows) and V^T hi/lo tiles
// (boxes of 32 keys x D rows; keys past S read as zeros; V^T is S8 keys
// wide, zero past S) of head bh by TMA, and the expf online softmax.
template <int D>
struct SplitKvOperands {
  using Tiles = Tf32x3Tiles<D>;
  using Tile = typename Tiles::Tile;
  const CUtensorMap* tm_kh;
  const CUtensorMap* tm_kl;
  const CUtensorMap* tm_vh;
  const CUtensorMap* tm_vl;
  int bh;
  float scale;

  __device__ void load_k(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j) {
      tma_load_3d(stage + j * Tile::kPanel, tm_kh, bar, j * Tile::kBoxCols, kTile * t, bh);
      tma_load_3d(stage + Tile::kBytes + j * Tile::kPanel, tm_kl, bar, j * Tile::kBoxCols,
                  kTile * t, bh);
    }
  }
  __device__ void load_v(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_3d(stage + j * Tiles::kVtPanel, tm_vh, bar, kTile * t + 32 * j, 0, bh);
      tma_load_3d(stage + Tiles::kVtTile + j * Tiles::kVtPanel, tm_vl, bar, kTile * t + 32 * j,
                  0, bh);
    }
  }
  __device__ void softmax(float (&sc)[32], int valid, int tq, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) const {
    key_tiles::online_softmax_tile(sc, valid, scale, tq, m, l, alpha);
  }
};

// K2/K3: Q roped and split by the warpgroup from the [B, S, *] rows (q: the
// head's column 0 of batch item b), the output [B, S, C] (tm_o).
template <int D>
struct RopeF32Operands : SplitKvOperands<D> {
  using Tile = typename SplitKvOperands<D>::Tile;
  const CUtensorMap* tm_o;
  const float* q;
  long long row_stride;
  const float* cos_t;
  const float* sin_t;
  int seq, h, b;

  static constexpr uint32_t kQBytes = 0;  // Q does not come by TMA
  static constexpr bool kThreadStore = false;  // out by TMA (store_o)
  __device__ void load_q(uint32_t, uint32_t, int) const {}
  // rows [row_base, row_base + 64) roped, split into the hi and lo tiles at
  // my_q; rows >= seq zero. 64 rows x D/8 chunk pairs, D/16 a thread.
  __device__ void stage_q(uint32_t my_q, int row_base, int ctid, int w, uint32_t) const {
#pragma unroll
    for (int it = 0; it < D / 16; ++it) {
      const int task = ctid + 128 * it;
      const int r = task / (D / 8);
      const int d = pair_col<D>(task % (D / 8));
      const int row = row_base + r;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < seq) {
        load4(a, q + row * row_stride + d);
        load4(c, q + row * row_stride + d + D / 4);
        rope_pair4<D>(a, c, cos_t + (size_t)row * D, sin_t + (size_t)row * D, d);
      }
      uint4 ah, al, ch, cl;
      split4(a, ah, al);
      split4(c, ch, cl);
      st_shared16(my_q + Tile::at(r, d), ah);
      st_shared16(my_q + Tile::at(r, d + D / 4), ch);
      st_shared16(my_q + Tile::kBytes + Tile::at(r, d), al);
      st_shared16(my_q + Tile::kBytes + Tile::at(r, d + D / 4), cl);
    }
    fence_async_shared();
    named_barrier(1 + w, 128);
  }
  __device__ void store_o(uint32_t src, int row_base) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_store_3d(tm_o, src + j * Tile::kPanel, h * D + j * Tile::kBoxCols, row_base, b);
  }
};

// K4-K6: Q by TMA (4-D map of q's strides) on the first stage, split in
// place once it landed; the output by the 4-D map of out's strides.
template <int D>
struct SoftmaxF32Operands : SplitKvOperands<D> {
  using Tiles = Tf32x3Tiles<D>;
  using Tile = typename Tiles::Tile;
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_o;
  int h, b;

  static constexpr uint32_t kQBytes = Tiles::kWgs * Tile::kBytes;  // the warpgroups' hi tiles
  static constexpr bool kThreadStore = false;                        // out by TMA (store_o)
  __device__ void load_q(uint32_t q_area, uint32_t bar, int block_row0) const {
#pragma unroll
    for (int w = 0; w < Tiles::kWgs; ++w)
#pragma unroll
      for (int j = 0; j < Tile::kPanels; ++j)
        tma_load_4d(q_area + w * Tiles::kWgQBytes + j * Tile::kPanel, tm_q, bar,
                    j * Tile::kBoxCols, block_row0 + w * kTile, h, b);
  }
  // the warpgroup's hi tile, once stage 0 landed: hi in place, lo beside it
  // (the two tiles share a layout, so the split is element by element)
  __device__ void stage_q(uint32_t my_q, int, int ctid, int w, uint32_t full0) const {
    mbar_wait_or_trap(full0, 0);
#pragma unroll
    for (int it = 0; it < Tile::kBytes / 16 / 128; ++it) {
      const uint32_t at = my_q + 16 * (ctid + 128 * it);
      const uint4 x = ld_shared16(at);
      const float f[4] = {__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                          __uint_as_float(x.w)};
      uint4 hi, lo;
      split4(f, hi, lo);
      st_shared16(at, hi);
      st_shared16(at + Tile::kBytes, lo);
    }
    fence_async_shared();
    named_barrier(1 + w, 128);
  }
  __device__ void store_o(uint32_t src, int row_base) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_store_4d(tm_o, src + j * Tile::kPanel, j * Tile::kBoxCols, row_base, h, b);
  }
};

template <int D>
__global__ void __launch_bounds__(Tf32x3Tiles<D>::kBlockThreads, Tf32x3Tiles<D>::kBlocksPerSm)
rope_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_kh,
                             const __grid_constant__ CUtensorMap tm_kl,
                             const __grid_constant__ CUtensorMap tm_vh,
                             const __grid_constant__ CUtensorMap tm_vl,
                             const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ q,
                             long long row_stride, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, int seq, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const RopeF32Operands<D> op{{&tm_kh, &tm_kl, &tm_vh, &tm_vl, b * heads + h, scale},
                              &tm_o,
                              q + (long long)b * seq * row_stride + (long long)h * D,
                              row_stride,
                              cos_t,
                              sin_t,
                              seq,
                              h,
                              b};
  key_tiles::attend<Tf32x3Tiles<D>>(smem_raw, op, seq);
}

template <int D>
__global__ void __launch_bounds__(Tf32x3Tiles<D>::kBlockThreads, Tf32x3Tiles<D>::kBlocksPerSm)
softmax_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_kh,
                                const __grid_constant__ CUtensorMap tm_kl,
                                const __grid_constant__ CUtensorMap tm_vh,
                                const __grid_constant__ CUtensorMap tm_vl,
                                const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_o, int sk, int heads,
                                float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const SoftmaxF32Operands<D> op{{&tm_kh, &tm_kl, &tm_vh, &tm_vl, b * heads + h, scale},
                                 &tm_q,
                                 &tm_o,
                                 h,
                                 b};
  key_tiles::attend<Tf32x3Tiles<D>>(smem_raw, op, sk);
}

// ---- the packed route: every accepted head dim, zero-padded -----------------

// The pack prologue at width Dp: q (where pack_q), k and v read by their
// (batch, head, row) strides an element at a time (any alignment), q and k
// roped where cos_t is not null (K2/K3); q into qp [B*H, Sq, Dp] float32, K
// split into kh, kl [B*H, Sk, Dp] and V, transposed, into vth, vtl [B*H, Dp,
// Sk8] (the split kernel's layout: keys of each 8-key group in P's
// A-fragment order for attend, in their natural order for the width-256
// schedule, whose P comes from shared memory); lanes d .. Dp - 1 and keys
// past Sk zero. Block: 32 keys (and query rows) of one (batch item, head),
// 256 threads, 4 elements a task. It reads no column of another head.
constexpr int kPackKeys = 32;

template <int Dp>
__global__ void __launch_bounds__(256)
attention_3xtf32_pack_kernel(const float* __restrict__ q, HeadStrides qs,
                             const float* __restrict__ k, HeadStrides ks,
                             const float* __restrict__ v, HeadStrides vs,
                             const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                             float* __restrict__ qp, uint32_t* __restrict__ kh,
                             uint32_t* __restrict__ kl, uint32_t* __restrict__ vth,
                             uint32_t* __restrict__ vtl, int heads, int sq, int sk, int sk8,
                             int d, bool pack_q) {
  constexpr bool kPermute = Dp <= 128;  // attend's P from registers
  constexpr int kQuads = Dp / 4;        // tasks a row
  constexpr int kTasks = (kPackKeys * kQuads + 255) / 256;  // tasks a thread
  __shared__ float vt[kPackKeys][Dp + 1];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * heads + h;
  const int row0 = blockIdx.x * kPackKeys;
  const float* qb = q + b * qs.batch + h * qs.head;
  const float* kb = k + b * ks.batch + h * ks.head;
  const float* vb = v + b * vs.batch + h * vs.head;
  // every load of the thread's tasks first, then the stores (one round trip
  // to memory, not one a task)
  float xq[kTasks][4], xk[kTasks][4], xv[kTasks][4];
#pragma unroll
  for (int i = 0; i < kTasks; ++i) {
    const int task = threadIdx.x + 256 * i;
    const int row = row0 + task / kQuads, e = 4 * (task % kQuads);
    const bool live = task < kPackKeys * kQuads;
    const float* cos_row = cos_t == nullptr ? nullptr : cos_t + (size_t)row * d;
    const float* sin_row = cos_t == nullptr ? nullptr : sin_t + (size_t)row * d;
    if (live && pack_q && row < sq)
      key_tiles::packed_quad(qb + row * qs.row, e, d, cos_row, sin_row, xq[i]);
    if (live && row < sk) {
      key_tiles::packed_quad(kb + row * ks.row, e, d, cos_row, sin_row, xk[i]);
      key_tiles::packed_quad(vb + row * vs.row, e, d, nullptr, nullptr, xv[i]);
    } else {
      xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kTasks; ++i) {
    const int task = threadIdx.x + 256 * i;
    if (task >= kPackKeys * kQuads) break;
    const int r = task / kQuads, e = 4 * (task % kQuads);
    const int row = row0 + r;
    if (pack_q && row < sq)
      *reinterpret_cast<float4*>(qp + (bh * sq + row) * Dp + e) =
          make_float4(xq[i][0], xq[i][1], xq[i][2], xq[i][3]);
    if (row < sk) {
      uint4 hi, lo;
      split4(xk[i], hi, lo);
      *reinterpret_cast<uint4*>(kh + (bh * sk + row) * Dp + e) = hi;
      *reinterpret_cast<uint4*>(kl + (bh * sk + row) * Dp + e) = lo;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) vt[r][e + j] = xv[i][j];
  }
  __syncthreads();
  for (int task = threadIdx.x; task < Dp * (kPackKeys / 4); task += blockDim.x) {
    const int e = task / (kPackKeys / 4), kq = (task % (kPackKeys / 4)) * 4;
    if (row0 + kq >= sk8) continue;
    // positions kq .. kq+3 of an 8-key group: its keys 0, 2, 4, 6 (kq % 8 ==
    // 0) or 1, 3, 5, 7 where kPermute, else kq .. kq+3
    const int k0 = kPermute ? (kq & ~7) + ((kq >> 2) & 1) : kq;
    const int step = kPermute ? 2 : 1;
    const float x[4] = {vt[k0][e], vt[k0 + step][e], vt[k0 + 2 * step][e], vt[k0 + 3 * step][e]};
    uint4 hi, lo;
    split4(x, hi, lo);
    const long long at = (bh * Dp + e) * sk8 + row0 + kq;
    *reinterpret_cast<uint4*>(vth + at) = hi;
    *reinterpret_cast<uint4*>(vtl + at) = lo;
  }
}

// Up to width 128: K4-K6's operands (attend, Tf32x3Tiles<Dp>) over the pack's
// scratch (q by a 4-D map of the contiguous [B, H, Sq, Dp] buffer), the
// output's first d columns stored by the threads (out: the head's row 0,
// rows out_row elements apart).
template <int Dp>
struct PackedF32Operands : SoftmaxF32Operands<Dp> {
  using Tile = typename SoftmaxF32Operands<Dp>::Tile;
  float* out;
  long long out_row;
  int d, sq;

  static constexpr bool kThreadStore = true;
  __device__ void store_rows(const unsigned char* tile, int row_base, int ctid) const {
    key_tiles::store_rows<Tile>(tile, out, out_row, d, row_base, sq, ctid);
  }
};

// Width 256 (key_tiles::attend_wide): Q's hi tile, K's halves and V^T's
// halves from the pack's scratch by 3-D maps, the expf online softmax, the
// output stored by the threads.
struct WideF32Operands {
  using W = key_tiles::WideTf32;
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_kh;
  const CUtensorMap* tm_kl;
  const CUtensorMap* tm_vh;
  const CUtensorMap* tm_vl;
  float* out;
  long long out_row;
  int h, b, bh, d, sq;
  float scale;

  // Q's hi tile by a 4-D map (q in place, or the pack's [B, H, Sq, 256])
  __device__ void load_q(uint32_t q_hi, uint32_t bar, int row0) const {
#pragma unroll
    for (int p = 0; p < W::QTile::kPanels; ++p)
      tma_load_4d(q_hi + p * W::QTile::kPanel, tm_q, bar, p * W::QTile::kBoxCols, row0, h, b);
  }
  // K hi and lo of key tile t, columns 128j .. 128j + 127
  __device__ void load_k_half(uint32_t buf, uint32_t bar, int t, int j) const {
#pragma unroll
    for (int p = 0; p < W::KHalf::kPanels; ++p) {
      const int col = 128 * j + p * W::KHalf::kBoxCols;
      tma_load_3d(buf + p * W::KHalf::kPanel, tm_kh, bar, col, kTile * t, bh);
      tma_load_3d(buf + W::KHalf::kBytes + p * W::KHalf::kPanel, tm_kl, bar, col, kTile * t, bh);
    }
  }
  // V^T hi and lo of key tile t, rows 128j .. 128j + 127, in two panels of 32 keys
  __device__ void load_vt_half(uint32_t buf, uint32_t bar, int t, int j) const {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      tma_load_3d(buf + p * W::kVtPanel, tm_vh, bar, kTile * t + 32 * p, 128 * j, bh);
      tma_load_3d(buf + 2 * W::kVtPanel + p * W::kVtPanel, tm_vl, bar, kTile * t + 32 * p,
                  128 * j, bh);
    }
  }
  __device__ void softmax(float (&sc)[32], int valid, int tq, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) const {
    key_tiles::online_softmax_tile(sc, valid, scale, tq, m, l, alpha);
  }
  __device__ void store_rows(const unsigned char* tile, int row_base, int ctid) const {
    key_tiles::store_rows<W::QTile>(tile, out, out_row, d, row_base, sq, ctid);
  }
};

template <int Dp>
__global__ void __launch_bounds__(Tf32x3Tiles<Dp>::kBlockThreads, Tf32x3Tiles<Dp>::kBlocksPerSm)
packed_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_kh,
                               const __grid_constant__ CUtensorMap tm_kl,
                               const __grid_constant__ CUtensorMap tm_vh,
                               const __grid_constant__ CUtensorMap tm_vl,
                               const __grid_constant__ CUtensorMap tm_q, float* out,
                               long long out_batch, long long out_head, long long out_row,
                               int heads, int sq, int sk, int d, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const PackedF32Operands<Dp> op{
      {{&tm_kh, &tm_kl, &tm_vh, &tm_vl, b * heads + h, scale}, &tm_q, nullptr, h, b},
      out + b * out_batch + h * out_head,
      out_row,
      d,
      sq};
  key_tiles::attend<Tf32x3Tiles<Dp>>(smem_raw, op, sk);
}

__global__ void __launch_bounds__(key_tiles::WideTf32::kBlockThreads, 1)
packed_attention_3xtf32_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_kh,
                                    const __grid_constant__ CUtensorMap tm_kl,
                                    const __grid_constant__ CUtensorMap tm_vh,
                                    const __grid_constant__ CUtensorMap tm_vl, float* out,
                                    long long out_batch, long long out_head, long long out_row,
                                    int heads, int sq, int sk, int d, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const WideF32Operands op{&tm_q,  &tm_kh, &tm_kl, &tm_vh,
                           &tm_vl, out + b * out_batch + h * out_head,
                           out_row, h,      b,     b * heads + h,
                           d,      sq,      scale};
  key_tiles::attend_wide(smem_raw, op, sk);
}

// ---- host -------------------------------------------------------------------

constexpr int kMaxDevices = 64;

int seq8_of(int seq) { return (seq + 7) & ~7; }

// The four parts of the scratch, in order: K hi, K lo, V^T hi, V^T lo.
struct Scratch {
  uint32_t *kh, *kl, *vth, *vtl;
};

Scratch scratch_parts(void* scratch, int batch, int heads, int seq, int head_dim) {
  const long long bh = (long long)batch * heads;
  uint32_t* base = static_cast<uint32_t*>(scratch);
  const long long k_elems = bh * seq * head_dim, vt_elems = bh * head_dim * seq8_of(seq);
  return Scratch{base, base + k_elems, base + 2 * k_elems, base + 2 * k_elems + vt_elems};
}

// Set a kernel's dynamic shared memory once a device.
template <class Kernel>
cudaError_t prepare(Kernel kernel, int smem, bool (&ready)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) ready[device] = true;
  return err;
}

// The prologue at head dim D on (k, ks) and (v, vs), then the maps of its
// four outputs.
template <int D>
cudaError_t split_kv(const void* k, HeadStrides ks, const void* v, HeadStrides vs,
                     const float* cos_t, const float* sin_t, const Scratch& s, int batch,
                     int heads, int seq, cudaStream_t st, CUtensorMap (&maps)[4]) {
  using Tile = typename Tf32x3Tiles<D>::Tile;
  const int seq8 = seq8_of(seq);
  const dim3 grid((seq + kSplitRows - 1) / kSplitRows, heads, batch);
  attention_3xtf32_split_kernel<D><<<grid, 256, 0, st>>>(
      static_cast<const float*>(k), ks, static_cast<const float*>(v), vs, cos_t, sin_t, s.kh,
      s.kl, s.vth, s.vtl, seq, seq8, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t bh = (uint64_t)batch * heads;
  err = encode_f32_rows(&maps[0], s.kh, D, seq, bh, D, (uint64_t)seq * D, Tile::kBoxCols);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[1], s.kl, D, seq, bh, D, (uint64_t)seq * D, Tile::kBoxCols);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[2], s.vth, seq8, D, bh, seq8, (uint64_t)D * seq8, 32, D);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[3], s.vtl, seq8, D, bh, seq8, (uint64_t)D * seq8, 32, D);
  return err;
}

// K2/K3 at head dim D: the prologue, then the key-tile kernel.
template <int D>
cudaError_t rope_attention(const void* q, const void* k, const void* v, long long row_stride,
                           const float* cos_t, const float* sin_t, void* scratch, void* out,
                           int batch, int seq, int heads, float scale, cudaStream_t st,
                           int device) {
  using Tiles = Tf32x3Tiles<D>;
  static bool ready[kMaxDevices];
  cudaError_t err = prepare(rope_attention_3xtf32_kernel<D>, Tiles::kSmem, ready, device);
  if (err != cudaSuccess) return err;
  const HeadStrides rows{(long long)seq * row_stride, D, row_stride};
  CUtensorMap maps[4], tm_o;
  err = split_kv<D>(k, rows, v, rows, cos_t, sin_t, scratch_parts(scratch, batch, heads, seq, D),
                    batch, heads, seq, st, maps);
  if (err != cudaSuccess) return err;
  const uint64_t c = (uint64_t)heads * D;
  err = encode_f32_rows(&tm_o, out, c, seq, batch, c, seq * c, Tiles::Tile::kBoxCols);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + Tiles::kBlockRows - 1) / Tiles::kBlockRows, heads, batch);
  rope_attention_3xtf32_kernel<D><<<grid, Tiles::kBlockThreads, Tiles::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], tm_o, static_cast<const float*>(q), row_stride, cos_t,
      sin_t, seq, heads, scale);
  return cudaGetLastError();
}

// K4-K6 at head dim D: the prologue on k and v by their strides, then the
// key-tile kernel on q's and out's 4-D maps.
template <int D>
cudaError_t softmax_attention(const void* q, const void* k, const void* v, void* out,
                              const long long* strides, void* scratch, int batch, int heads,
                              int sq, int sk, float scale, cudaStream_t st, int device) {
  using Tiles = Tf32x3Tiles<D>;
  static bool ready[kMaxDevices];
  cudaError_t err = prepare(softmax_attention_3xtf32_kernel<D>, Tiles::kSmem, ready, device);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4], tm_q, tm_o;
  err = split_kv<D>(k, HeadStrides{strides[3], strides[4], strides[5]}, v,
                    HeadStrides{strides[6], strides[7], strides[8]}, nullptr, nullptr,
                    scratch_parts(scratch, batch, heads, sk, D), batch, heads, sk, st, maps);
  if (err != cudaSuccess) return err;
  // q's and out's maps: 4 bytes an element, one row (4 * D bytes: the kernel
  // never steps along it) for an axis of size 1
  long long bytes[6];
  const int extents[3] = {batch, heads, sq};
  for (int i = 0; i < 6; ++i) {
    const long long stride = strides[i < 3 ? i : 9 + (i - 3)];
    bytes[i] = extents[i % 3] == 1 ? 4LL * D : 4 * stride;
  }
  err = encode_f32_heads(&tm_q, q, sq, heads, batch, bytes[0], bytes[1], bytes[2], D,
                         Tiles::Tile::kBoxCols);
  if (err == cudaSuccess)
    err = encode_f32_heads(&tm_o, out, sq, heads, batch, bytes[3], bytes[4], bytes[5], D,
                           Tiles::Tile::kBoxCols);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + Tiles::kBlockRows - 1) / Tiles::kBlockRows, heads, batch);
  softmax_attention_3xtf32_kernel<D><<<grid, Tiles::kBlockThreads, Tiles::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], tm_q, tm_o, sk, heads, scale);
  return cudaGetLastError();
}

// The packed route's scratch, in order: q [B*H, Sq, Dp] float32, then the
// split kernel's four parts at width Dp for Sk keys.
struct PackedScratch {
  float* q;
  Scratch kv;
};

PackedScratch packed_parts(void* scratch, int batch, int heads, int sq, int sk, int dp) {
  float* q = static_cast<float*>(scratch);
  return PackedScratch{q, scratch_parts(q + (long long)batch * heads * sq * dp, batch, heads, sk,
                                        dp)};
}

// The packed route at width Dp: the pack (q only where it is roped or TMA
// cannot read it in place: a 16-byte aligned base and strides), then the
// key-tile kernel (attend at Dp <= 128, attend_wide at 256) on maps of the
// scratch and, for an in-place q, a 4-D map of q whose innermost extent is
// d (the boxes read zeros past it, never a lane of the next head).
template <int Dp>
cudaError_t launch_packed(const void* q, const void* k, const void* v, void* out,
                          const long long* strides, const float* cos_t, const float* sin_t,
                          void* scratch, int batch, int heads, int sq, int sk, int d, float scale,
                          int device, cudaStream_t st) {
  constexpr bool kWide = Dp > 128;
  static bool ready[kMaxDevices];
  cudaError_t err;
  if constexpr (kWide) {
    err = prepare(packed_attention_3xtf32_wide_kernel, key_tiles::WideTf32::kSmem, ready, device);
  } else {
    err = prepare(packed_attention_3xtf32_kernel<Dp>, Tf32x3Tiles<Dp>::kSmem, ready, device);
  }
  if (err != cudaSuccess) return err;
  const PackedScratch s = packed_parts(scratch, batch, heads, sq, sk, Dp);
  const int sk8 = seq8_of(sk);
  const bool pack_q = cos_t != nullptr || !key_tiles::in_place(q, strides, 0, d, 4);
  const dim3 pack_grid(((sq > sk ? sq : sk) + kPackKeys - 1) / kPackKeys, heads, batch);
  attention_3xtf32_pack_kernel<Dp><<<pack_grid, 256, 0, st>>>(
      static_cast<const float*>(q), HeadStrides{strides[0], strides[1], strides[2]},
      static_cast<const float*>(k), HeadStrides{strides[3], strides[4], strides[5]},
      static_cast<const float*>(v), HeadStrides{strides[6], strides[7], strides[8]}, cos_t,
      sin_t, s.q, s.kv.kh, s.kv.kl, s.kv.vth, s.kv.vtl, heads, sq, sk, sk8, d, pack_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t bh = (uint64_t)batch * heads;
  constexpr uint32_t kBoxCols = Dp < 32 ? Dp : 32;  // a panel row: min(128 B, the row)
  const uint32_t vt_rows = kWide ? 128 : Dp;         // V^T rows a box
  CUtensorMap maps[5];  // kh, kl, vth, vtl, q
  err = encode_f32_rows(&maps[0], s.kv.kh, Dp, sk, bh, Dp, (uint64_t)sk * Dp, kBoxCols);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[1], s.kv.kl, Dp, sk, bh, Dp, (uint64_t)sk * Dp, kBoxCols);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[2], s.kv.vth, sk8, Dp, bh, sk8, (uint64_t)Dp * sk8, 32, vt_rows);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[3], s.kv.vtl, sk8, Dp, bh, sk8, (uint64_t)Dp * sk8, 32, vt_rows);
  if (err != cudaSuccess) return err;
  // q's map: 4-D over q in place (one row's bytes for an axis of size 1) or
  // over the pack's contiguous [B, H, Sq, Dp]
  uint64_t qb[3] = {4ull * heads * sq * Dp, 4ull * sq * Dp, 4ull * Dp};
  if (!pack_q) key_tiles::operand_bytes(strides, 0, d, 4, qb);
  err = encode_f32_heads(&maps[4], pack_q ? static_cast<const void*>(s.q) : q, sq, heads, batch,
                         qb[0], qb[1], qb[2], pack_q ? Dp : d, kBoxCols);
  if (err != cudaSuccess) return err;
  float* o = static_cast<float*>(out);
  if constexpr (kWide) {
    const dim3 grid((sq + kTile - 1) / kTile, heads, batch);
    packed_attention_3xtf32_wide_kernel<<<grid, key_tiles::WideTf32::kBlockThreads,
                                          key_tiles::WideTf32::kSmem, st>>>(
        maps[4], maps[0], maps[1], maps[2], maps[3], o, strides[9], strides[10], strides[11],
        heads, sq, sk, d, scale);
  } else {
    using Tiles = Tf32x3Tiles<Dp>;
    const dim3 grid((sq + Tiles::kBlockRows - 1) / Tiles::kBlockRows, heads, batch);
    packed_attention_3xtf32_kernel<Dp><<<grid, Tiles::kBlockThreads, Tiles::kSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], o, strides[9], strides[10], strides[11],
        heads, sq, sk, d, scale);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The built width a head dim runs at (attention_tc.cuh::padded_width); 0 for
// a head dim the kernels do not take. Mirrored by
// flash_attention.py::padded_width.
int t3d_attention_3xtf32_padded_width(int head_dim) { return padded_width(head_dim); }

// Bytes of the scratch t3d_attention_3xtf32_packed takes: float32 [batch *
// heads, sq, Dp] for q, then t3d_attention_3xtf32_scratch_bytes at Dp for sk
// keys, Dp the padded width.
unsigned long long t3d_attention_3xtf32_packed_scratch_bytes(int batch, int heads, int sq, int sk,
                                                             int head_dim) {
  const unsigned long long dp = padded_width(head_dim), bh = (unsigned long long)batch * heads;
  return 4ull * (bh * sq * dp + 2 * bh * sk * dp + 2 * bh * dp * seq8_of(sk));
}

// K2-K6 in float32 at any head_dim the kernels take (a multiple of 4 up to
// 256), the operands packed first; the arguments as attention_tc.cu's
// t3d_attention_tc_packed (q, k, v at any alignment; out 16-byte aligned,
// its strides multiples of 4; cos/sin for K2/K3, sq == sk, or null), scratch
// of t3d_attention_3xtf32_packed_scratch_bytes, 16-byte aligned. Launches
// the pack and the key-tile kernel at the padded width on `stream`, on the
// current device. Returns a cudaError_t code.
int t3d_attention_3xtf32_packed(const void* q, const void* k, const void* v, void* out,
                                const long long* strides, const float* cos_t,
                                const float* sin_t, void* scratch, int batch, int heads, int sq,
                                int sk, int head_dim, float scale, void* stream) {
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

// Bytes of the scratch a call takes: K hi and lo, [batch*heads, seq,
// head_dim] each, then V^T hi and lo, [batch*heads, head_dim, seq rounded
// up to 8] each, all 4-byte words. For K4-K6, seq is Sk.
unsigned long long t3d_attention_3xtf32_scratch_bytes(int batch, int heads, int seq,
                                                      int head_dim) {
  const unsigned long long bh = (unsigned long long)batch * heads;
  return 4ull * (2 * bh * seq * head_dim + 2 * bh * head_dim * seq8_of(seq));
}

// K2/K3: q/k/v float32 base pointers of [batch, seq, *] rows `row_stride`
// elements apart (head h at column h*head_dim), 16-byte aligned, row_stride
// % 4 == 0; cos/sin float32 [seq, head_dim]; scratch of
// t3d_attention_3xtf32_scratch_bytes, 16-byte aligned; out float32 [batch,
// seq, heads*head_dim] contiguous. head_dim 16, 32, 64 or 128 (every other:
// t3d_attention_3xtf32_packed). Launches, on
// `stream` and the current device, the prologue and the key-tile kernel.
// Returns a cudaError_t code.
int t3d_rope_attention_3xtf32(const void* q, const void* k, const void* v, long long row_stride,
                              const float* cos_t, const float* sin_t, void* scratch, void* out,
                              int batch, int seq, int heads, int head_dim, float scale,
                              void* stream) {
  if (!serves_head_dim(head_dim) || seq <= 0 || row_stride % 4 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  switch (head_dim) {
    case 16:
      return (int)rope_attention<16>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch, seq,
                                     heads, scale, st, device);
    case 32:
      return (int)rope_attention<32>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch, seq,
                                     heads, scale, st, device);
    case 64:
      return (int)rope_attention<64>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch, seq,
                                     heads, scale, st, device);
    default:
      return (int)rope_attention<128>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch,
                                      seq, heads, scale, st, device);
  }
}

// K4-K6: q [batch, heads, sq, head_dim], k/v [batch, heads, sk, head_dim],
// out like q, float32, each by its base pointer (16-byte aligned) and, in
// `strides` (12 values, host memory), the (batch, head, row) strides in
// elements of q, k, v, out, multiples of 4 (the wrapper sends 0 for an axis
// of size 1); head_dim (16, 32, 64 or 128; every other:
// t3d_attention_3xtf32_packed) contiguous. scratch as for K2/K3
// with seq = sk. sq, sk >= 1. Launches, on `stream` and the current device,
// the prologue and the key-tile kernel. Returns a cudaError_t code.
int t3d_softmax_attention_3xtf32(const void* q, const void* k, const void* v, void* out,
                                 const long long* strides, void* scratch, int batch, int heads,
                                 int sq, int sk, int head_dim, float scale, void* stream) {
  if (!serves_head_dim(head_dim) || sq <= 0 || sk <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  switch (head_dim) {
    case 16:
      return (int)softmax_attention<16>(q, k, v, out, strides, scratch, batch, heads, sq, sk,
                                        scale, st, device);
    case 32:
      return (int)softmax_attention<32>(q, k, v, out, strides, scratch, batch, heads, sq, sk,
                                        scale, st, device);
    case 64:
      return (int)softmax_attention<64>(q, k, v, out, strides, scratch, batch, heads, sq, sk,
                                        scale, st, device);
    default:
      return (int)softmax_attention<128>(q, k, v, out, strides, scratch, batch, heads, sq, sk,
                                         scale, st, device);
  }
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
