// K2 + K3 on Hopper tensor cores: fused 2-D RoPE + softmax attention for
// bf16 with head_dim 16, 32, 64 or 128, CUDA C++ for sm_90a (wgmma, TMA,
// mbarriers). Every other head dim the wrappers accept runs attention_tc.cu's
// packed entry, which ropes q and k in its prologue.
//
// Replaces the Pallas TPU kernel thermal3d/kernels/flash_attention.py::
// _fused_rope_kernel, reached through _fused_rope_attention_fwd (K2: the
// packed [B,S,3C] qkv projection, row stride 3C) and _fused_rope_xattn_fwd
// (K3: separate [B,S,C] q/k/v projections, row stride C). q, k and v are
// base pointers with a common row stride; head h sits at column h*D; the
// output is [B,S,C]. q and k are roped in float32 from the cos/sin tables
// [S,D] (quarters of D/4: element d of an even quarter pairs with d + D/4;
// each product and the sum rounded separately, no FMA), then rounded to
// bf16. Two schedules, chosen by S and D (t3d_rope_attention_tc_schedule):
//
// One pass, head_dim 64 and S <= 256 (every serving, training and
// tensor-parallel call of the configured models: S = 196). What bounds it on an H100: the bytes, q, k, v read once and the
// output written once (51.4 MB, 15.4 us at 3.35 TB/s for [32,196,3072] H16;
// the products take about a third of that at 989 TFLOP/s), and, as built,
// the CUDA cores' RoPE and softmax, which run longer than either (their L2
// table loads and dependency chains with 8 warps an SM). The arithmetic is
// the Pallas kernel's: every score of a row in registers, one max over the
// whole row, p = exp(s - max) (2^x on the MUFU unit) with its float32 sum,
// p rounded to bf16, PV, the division after PV (a reciprocal and one
// correction step). Design (rope_attention_one_pass_kernel):
//   * A work item is one (batch item, head) and its query rows, all of them,
//     or a part of 1-2 64-row tiles where the card would be short of items
//     (the tensor-parallel shapes: 12-64 heads for 132 SMs). A persistent
//     grid of one block an SM walks the items with a static stride.
//   * A block is two warpgroups, an item each, in their own Q/K/V buffers
//     (32 KB each) and output tile: while one ropes or runs its softmax on
//     the CUDA cores, the other's wgmma run. No producer warp: a ninth warp
//     would cap every thread at 168 registers (ptxas allots registers by SM
//     quadrant; setmaxnreg did not lift the cap), and a row's scores need
//     up to 255. Each warpgroup's thread 0 issues its own TMA loads (3-D
//     tensor maps: rows >= S read as zeros, never the next batch item's):
//     the next item's Q and K once the last query tile has its scores, V
//     once its PV is done; the tiles run last-first when the last holds few
//     rows, so those loads overlap a whole tile's work.
//   * K and Q are roped in shared memory, in place; each of q, k, v is read
//     from device memory once, and no scratch is written. The cos/sin rows
//     come from L2 (100 KB at S = 196, read once an item, for Q and K).
//   * Scores: KT = ceil(S/64) wgmma products of a 64-row tile, m64n64k16
//     but an m64n8k16 last tile where it holds at most 8 keys (4 at S=196);
//     PV: a k16 step for each 16 keys, P from registers. Warps whose 16 rows
//     all lie past S skip the softmax and the output.
//   * The output goes through the warpgroup's shared-memory tile and out by
//     a TMA store, rows >= S dropped.
//
// Key tiles, S > 256 at head_dim 64 (the pseudo-GT's S = 1024, VGGT's 1374
// and 32,976), and every S at head_dims 16, 32 and 128 (e.g. a decoder of 512
// wide and 16 heads). What bounds it: the operations (4*S^2*D a head, about
// 250x the bytes' time at S = 1024 and D = 64), and the CUDA cores' online
// softmax between a tile's two products, whose work a score does not shrink
// with D: at D = 64 a 64-key tile's 4,096 exponentials take the MUFU units
// about as long as its two products take the tensor cores. The softmax step
// is K4-K6's at every head dim (attention_tc.cu: scale * log2(e) folded into
// one FFMA a score, 2^x on the MUFU unit, only the last tile masked); the
// expf step that older builds took at head_dim 64 (accurate expf, a separate
// scale, every tile masked) read 1.6x K4's time on the same loop on an H100.
// Design (rope_attention_key_tile_kernel, on key_tile_attention.cuh's core,
// which K4-K6 share):
//   * A prologue kernel launched just before on the same stream ropes K once
//     per head (rope_attention_tc_rope_kernel: [B,S,*] rows -> a bf16
//     [B,H,S,D] scratch the caller allocates,
//     t3d_rope_attention_tc_scratch_bytes), and at head_dim 64 Q too, into a
//     second [B,H,S,D] after it. Roping K tiles in the block instead repeats
//     the RoPE for every 128 query rows (8 times a head at S=1024) and
//     measured slower at S=1024 on an H100.
//   * Head dim 64 (kPingPong): key_tiles::attend_ping_pong, a persistent
//     block an SM walking 192-row work items: a producer warpgroup whose one
//     thread streams Q and the K and V tiles by TMA, and three consumer
//     warpgroups of 64 rows whose products take turns at the tensor cores
//     (named barriers), so their softmax runs while the others' products do
//     (1.16x attend's rate at S = 32,976 on an H100, equal at 1374).
//   * The other head dims: key_tiles::attend, a block a 128 query rows of one
//     head, two warpgroups of 64, no producer warp, two blocks an SM (one at
//     head dim 128), Q roped by the warpgroup from device memory, K and V
//     tiles by TMA through a ring of 4 stages; each warpgroup issues tile t's
//     QK^T together with tile t-1's PV, runs tile t's softmax while that PV
//     runs, then rounds p to bf16 and rescales O once the PV is done. Each
//     head dim is an instantiation of Bf16Tiles<D>.
//   * O goes out through shared memory by a TMA store.
#include <type_traits>

#include "key_tile_attention.cuh"

namespace {

// ---- RoPE -----------------------------------------------------------------

// The cos/sin entries of one row's chunk pair: 8 (or 4) elements from a of
// an even quarter and from b of the odd quarter after it.
struct PairTables {
  float ca[8], sa[8], cb[8], sb[8];
};

__device__ __forceinline__ void put4(float* dst, float4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// The entries of elements a .. a+N-1 and b .. b+N-1 (N = 8 or 4) of a row's
// cos and sin, through the read-only path.
template <int N = 8>
__device__ __forceinline__ void load_tables(PairTables& t, const float* __restrict__ cos_row,
                                            const float* __restrict__ sin_row, int a, int b) {
  const float4* ca = reinterpret_cast<const float4*>(cos_row + a);
  const float4* sa = reinterpret_cast<const float4*>(sin_row + a);
  const float4* cb = reinterpret_cast<const float4*>(cos_row + b);
  const float4* sb = reinterpret_cast<const float4*>(sin_row + b);
  put4(t.ca, __ldg(ca));
  if constexpr (N == 8) put4(t.ca + 4, __ldg(ca + 1));
  put4(t.sa, __ldg(sa));
  if constexpr (N == 8) put4(t.sa + 4, __ldg(sa + 1));
  put4(t.cb, __ldg(cb));
  if constexpr (N == 8) put4(t.cb + 4, __ldg(cb + 1));
  put4(t.sb, __ldg(sb));
  if constexpr (N == 8) put4(t.sb + 4, __ldg(sb + 1));
}

// RoPE of one row's chunk pair: a holds elements of an even quarter of the
// head, b the elements a quarter on (the odd quarter that follows), 8 of
// each in a uint4 or 4 in a uint2 (V). Each product and the sum rounded
// separately, as the plain version rounds them.
template <class V>
__device__ __forceinline__ void rope_chunks(const V a, const V b, const PairTables& tab, V& lo,
                                            V& hi) {
  constexpr int kElems = sizeof(V) / 2;
  const __nv_bfloat16* ta = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(&b);
  uint32_t* ol = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* oh = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < kElems; i += 2) {
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

// RoPE of the chunk pair at elements a and b of a row in device memory.
template <class V>
__device__ __forceinline__ void rope_pair(const __nv_bfloat16* row, const PairTables& tab, int a,
                                          int b, V& lo, V& hi) {
  rope_chunks(*reinterpret_cast<const V*>(row + a), *reinterpret_cast<const V*>(row + b), tab, lo,
              hi);
}

// RoPE in place of the chunk pair (c, c + 2) of row r of a swizzled bf16
// operand buffer in shared memory (head_dim 64).
__device__ __forceinline__ void rope_swizzled(unsigned char* buf, int r, int c,
                                              const PairTables& tab) {
  uint4* a = reinterpret_cast<uint4*>(buf + swizzle(r, c));
  uint4* b = reinterpret_cast<uint4*>(buf + swizzle(r, c + 2));
  rope_chunks(*a, *b, tab, *a, *b);
}

// The chunk pairs of a row at head dim D: a task ropes kGroup elements of an
// even quarter (from `col(pair)`) and the kGroup a quarter (D/4) on; kGroup
// = 8 (a 16-byte chunk) but 4 at D = 16, whose quarter is 4 wide. kPairs
// tasks cover a row: at D = 64, chunks (0, 2), (1, 3), (4, 6), (5, 7).
template <int D>
struct RopePairs {
  static constexpr int kQuarter = D / 4;
  static constexpr int kGroup = kQuarter < 8 ? kQuarter : 8;
  static constexpr int kPairs = D / (2 * kGroup);
  using V = typename std::conditional<kGroup == 8, uint4, uint2>::type;
  static __device__ __forceinline__ int col(int pair) {
    constexpr int per_quarter = kQuarter / kGroup;
    return (pair / per_quarter) * 2 * kQuarter + (pair % per_quarter) * kGroup;
  }
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint4 v) { st_shared16(addr, v); }
__device__ __forceinline__ void st_shared(uint32_t addr, uint2 v) { st_shared8(addr, v); }

// Rope rows [row0, row0 + 64) of one head (head dim D) into a swizzled bf16
// operand tile of 64 rows (key_tiles::RowTile<D, 2>); rows >= seq are zero.
// 128 threads, tid in [0, 128).
template <int D>
__device__ __forceinline__ void rope_rows(const __nv_bfloat16* __restrict__ x, long long row_stride,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int row0, int seq,
                                          uint32_t dst, int tid) {
  using R = RopePairs<D>;
  using Tile = key_tiles::RowTile<D, 2>;
  using V = typename R::V;
#pragma unroll
  for (int it = 0; it < 64 * R::kPairs / 128; ++it) {
    const int task = tid + 128 * it;  // 64 rows x kPairs chunk pairs
    const int r = task / R::kPairs;
    const int a = R::col(task % R::kPairs);
    const int b = a + R::kQuarter;
    const int row = row0 + r;
    V lo{}, hi{};
    if (row < seq) {
      PairTables tables;
      load_tables<R::kGroup>(tables, cos_t + (size_t)row * D, sin_t + (size_t)row * D, a, b);
      rope_pair(x + (long long)row * row_stride, tables, a, b, lo, hi);
    }
    st_shared(dst + Tile::at(r, a), lo);
    st_shared(dst + Tile::at(r, b), hi);
  }
}

// ---- key tiles: the RoPE prologue -------------------------------------------

// The schedule of the key-tile kernel at head dim D, chosen by the tile
// policy: bf16 at width 64 runs key_tiles::attend_ping_pong (a producer
// warpgroup, three consumers in ping-pong, a persistent block an SM, 64-key
// tiles through an 8-stage ring), with Q roped by the prologue beside K; the
// other widths run key_tiles::attend (two blocks an SM, one at D = 128), Q
// roped in the kernel.
template <int D>
constexpr bool kPingPong = D == 64;
using PingPong = key_tiles::PingPongTiles;

// RoPE of K into k_roped [B,H,S,D] bf16 (rows 2D bytes apart), and of Q into
// q_roped (the same layout) where q_roped is not null. Block: 64 rows of one
// batch item and kPrologueHeads heads, 64 * kPairs threads (256 at D = 64),
// one chunk pair a thread, which loads its cos/sin entries once for those
// heads and both operands.
constexpr int kPrologueHeads = 4;

template <int D>
__global__ void __launch_bounds__(64 * RopePairs<D>::kPairs)
rope_attention_tc_rope_kernel(const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ q, long long row_stride,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              __nv_bfloat16* __restrict__ k_roped,
                              __nv_bfloat16* __restrict__ q_roped, int seq, int num_heads) {
  using R = RopePairs<D>;
  using V = typename R::V;
  const int b = blockIdx.y;
  const int row = blockIdx.x * 64 + threadIdx.x / R::kPairs;
  if (row >= seq) return;
  const int a = R::col(threadIdx.x % R::kPairs);
  const int bcol = a + R::kQuarter;
  PairTables tables;
  load_tables<R::kGroup>(tables, cos_t + (size_t)row * D, sin_t + (size_t)row * D, a, bcol);
  const long long src_row = ((long long)b * seq + row) * row_stride;
#pragma unroll
  for (int i = 0; i < kPrologueHeads; ++i) {
    const int h = blockIdx.z * kPrologueHeads + i;
    if (h >= num_heads) break;
    const long long dst_row = (((long long)b * num_heads + h) * seq + row) * D;
    V lo, hi;
    rope_pair(k + src_row + h * D, tables, a, bcol, lo, hi);
    *reinterpret_cast<V*>(k_roped + dst_row + a) = lo;
    *reinterpret_cast<V*>(k_roped + dst_row + bcol) = hi;
    if (q_roped != nullptr) {
      rope_pair(q + src_row + h * D, tables, a, bcol, lo, hi);
      *reinterpret_cast<V*>(q_roped + dst_row + a) = lo;
      *reinterpret_cast<V*>(q_roped + dst_row + bcol) = hi;
    }
  }
}

// ---- key tiles: the attention kernel ----------------------------------------

// K2/K3's operands of the key-tile core (key_tile_attention.cuh) at head dim
// D: the roped K tiles of the prologue's scratch (tm_k: [B*H, S, D]) and V
// (tm_v: the [B, S, *] rows) by TMA, a box a panel, Q roped by the
// warpgroup from device memory (rope_rows), K4-K6's exp2 step, and the [B,
// S, C] output (tm_o).
template <int D>
struct RopeKeyTileOperands {
  using Tile = typename key_tiles::Bf16Tiles<D>::Tile;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const CUtensorMap* tm_o;
  const __nv_bfloat16* q;  // the head's column 0 of batch item b
  long long row_stride;
  const float* cos_t;
  const float* sin_t;
  int seq, num_heads, h, b;
  float c;  // scale * log2(e)

  static constexpr uint32_t kQBytes = 0;  // Q does not come by TMA
  static constexpr bool kThreadStore = false;  // out by TMA (store_o)
  __device__ void load_q(uint32_t, uint32_t, int) const {}
  __device__ void load_k(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_load_3d(stage + j * Tile::kPanel, tm_k, bar, j * Tile::kBoxCols, kTile * t,
                  b * num_heads + h);
  }
  __device__ void load_v(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < Tile::kPanels; ++j)
      tma_load_3d(stage + j * Tile::kPanel, tm_v, bar, h * D + j * Tile::kBoxCols, kTile * t, b);
  }
  __device__ void stage_q(uint32_t my_q, int row_base, int ctid, int w, uint32_t) const {
    rope_rows<D>(q, row_stride, cos_t, sin_t, row_base, seq, my_q, ctid);
    fence_async_shared();
    named_barrier(1 + w, 128);
  }
  // K4-K6's exp2 step, masked on the last tile only
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
      tma_store_3d(tm_o, src + j * Tile::kPanel, h * D + j * Tile::kBoxCols, row_base, b);
  }
};

// K2/K3's operands of the ping-pong schedule (head dim 64): Q and K roped by
// the prologue ([B*H, S, 64] each: tm_q, tm_k), V (tm_v: the [B, S, *] rows)
// and the [B, S, C] output (tm_o), 64 rows a box.
struct RopePingPongOperands {
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const CUtensorMap* tm_o;
  int rows, keys, heads, batch;
  float c;  // scale * log2(e)

  __device__ void load_q(uint32_t dst, uint32_t bar, int b, int h, int row0) const {
    tma_load_3d(dst, tm_q, bar, 0, row0, b * heads + h);
  }
  __device__ void load_k(uint32_t dst, uint32_t bar, int b, int h, int key0) const {
    tma_load_3d(dst, tm_k, bar, 0, key0, b * heads + h);
  }
  __device__ void load_v(uint32_t dst, uint32_t bar, int b, int h, int key0) const {
    tma_load_3d(dst, tm_v, bar, h * kD, key0, b);
  }
  __device__ void store_o(uint32_t src, int b, int h, int row0) const {
    tma_store_3d(tm_o, src, h * kD, row0, b);
  }
};

// The key-tile kernel's block at head dim D: threads, blocks an SM, dynamic
// shared memory.
template <int D>
struct KeyTileBlock {
  using Tiles = key_tiles::Bf16Tiles<D>;
  static constexpr int kThreads = kPingPong<D> ? PingPong::kBlockThreads : Tiles::kBlockThreads;
  static constexpr int kPerSm = kPingPong<D> ? 1 : Tiles::kBlocksPerSm;
  static constexpr int kSmem = kPingPong<D> ? PingPong::kSmem : Tiles::kSmem;
};

// The key tiles over the prologue's roped K (and Q) and V: at head dim 64 a
// persistent grid walking the work items (attend_ping_pong), else a block a
// 128 query rows of one (batch item, head) (attend).
template <int D>
__global__ void __launch_bounds__(KeyTileBlock<D>::kThreads, KeyTileBlock<D>::kPerSm)
rope_attention_key_tile_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_o,
                               const __nv_bfloat16* __restrict__ q, long long row_stride,
                               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                               int seq, int num_heads, int batch, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (kPingPong<D>) {
    const RopePingPongOperands op{&tm_q, &tm_k, &tm_v, &tm_o, seq, seq, num_heads, batch,
                                  scale * kLog2e};
    key_tiles::attend_ping_pong(smem_raw, op);
  } else {
    const int h = blockIdx.y, b = blockIdx.z;
    const RopeKeyTileOperands<D> op{&tm_k, &tm_v, &tm_o,
                                    q + (long long)b * seq * row_stride + (long long)h * D,
                                    row_stride, cos_t, sin_t, seq, num_heads, h, b,
                                    scale * kLog2e};
    key_tiles::attend<key_tiles::Bf16Tiles<D>>(smem_raw, op, seq);
  }
}

// ---- one pass (S <= 256) ----------------------------------------------------


namespace one_pass {
constexpr int kMaxSeq = 256;                 // the longest S an item holds whole
constexpr int kMaxTiles = kMaxSeq / kTile;   // 64-row tiles (query rows, and keys)
constexpr int kBuf = kMaxSeq * kRowBytes;    // 32 KB: Q, K or V of one item
constexpr int kItemBytes = 3 * kBuf + kTileBytes;  // Q, K, V and a 64-row output tile
constexpr int kWgs = 2;                      // warpgroups a block, an item each
constexpr int kBlockThreads = 128 * kWgs;
constexpr int kBarsAt = kWgs * kItemBytes;
constexpr int kSmem = 1024 + kBarsAt + 2 * kWgs * 8;  // + slack to align to 1024
static_assert(kSmem <= 232448, "more shared memory than an H100 block may use");

// One work item: query rows [row0, row0 + 64 * tiles) of head h of batch item b.
struct Item {
  int b, h, row0, tiles;
};

__device__ __forceinline__ Item item_at(int item, int heads, int parts, int part_tiles,
                                        int row_tiles) {
  const int part = item % parts;
  const int bh = item / parts;
  Item it;
  it.b = bh / heads;
  it.h = bh % heads;
  it.row0 = part * part_tiles * kTile;
  it.tiles = min(part_tiles, row_tiles - part * part_tiles);
  return it;
}

// RoPE in place of an item's K (rows [0, seq)) and Q (its rows, Q buffer
// row 0 = query row it.row0) in shared memory, by one warpgroup (tid in
// [0, 128)). A row's cos/sin entries serve its K and Q rows; the loads of
// kRopeBatch tasks are issued before any is roped (they come from L2).
constexpr int kRopeBatch = 2;

__device__ __forceinline__ void rope_item(unsigned char* q, unsigned char* k, const Item& it,
                                          int seq, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int tid) {
  const int q_end = min(seq, it.row0 + kTile * it.tiles);
  const int tasks = 4 * seq;  // rows x 4 chunk pairs
  for (int task0 = tid; task0 < tasks; task0 += 128 * kRopeBatch) {
    PairTables tab[kRopeBatch];
#pragma unroll
    for (int u = 0; u < kRopeBatch; ++u) {
      const int task = task0 + 128 * u;
      const int r = task >> 2;
      if (task < tasks) {
        const int a = 8 * ((task & 1) | ((task & 2) << 1));  // chunks 0, 1, 4, 5
        load_tables(tab[u], cos_t + (size_t)r * kD, sin_t + (size_t)r * kD, a, a + 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kRopeBatch; ++u) {
      const int task = task0 + 128 * u;
      if (task < tasks) {
        const int r = task >> 2;
        const int c = (task & 1) | ((task & 2) << 1);  // 0, 1, 4, 5
        rope_swizzled(k, r, c, tab[u]);
        if (r >= it.row0 && r < q_end) rope_swizzled(q, r - it.row0, c, tab[u]);
      }
    }
  }
}

// d = A B, m64n8k16, A and B (K-major) from shared memory (accumulate: d += A B).
__device__ __forceinline__ void wgmma_ss_n8(float& d0, float& d1, float& d2, float& d3,
                                            uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Key groups of 8 (columns of the score fragment) in tile t: all of them,
// or one in the narrow last tile (TAIL = 8 keys).
template <int KT, int TAIL>
__device__ __forceinline__ constexpr int groups(int t) {
  return t == KT - 1 ? TAIL / 8 : 8;
}

// The scores of one warpgroup's 64 query rows (roped, at q_tile) against
// the keys of the item (roped K at k_buf, rows >= seq zero), the whole row
// at once: S = Q K^T in KT products, m64n64k16 but the last of TAIL keys
// (8 where seq - 64(KT-1) <= 8), keys >= seq masked, one max a row, p =
// exp(s * scale - max) as 2^x on the MUFU unit (x = s*scale*log2 e -
// max*log2 e in one fused step) with its float32 sum, p rounded to bf16 as the A
// operand of PV (p[t][kk]: keys 64t + 16kk .. +16). `live`: some row of
// this warp is < seq (else its softmax is skipped; its rows are never
// stored). l[r] is row g + 8r's sum (fragment layout as in attention_tc.cuh).
template <int KT, int TAIL>
__device__ __forceinline__ void scores_to_p(uint32_t q_tile, uint32_t k_buf, int seq, float scale,
                                            bool live, int lane, uint32_t (&p)[KT][4][4],
                                            float (&l)[2]) {
  const int tq = lane & 3;
  float sc[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 4 * groups<KT, TAIL>(t); ++i) sc[t][i] = 0.0f;
  const uint64_t q_desc = smem_desc(q_tile);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const uint64_t k_desc = smem_desc(k_buf + t * kTileBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (groups<KT, TAIL>(t) == 8) {
        wgmma_ss(sc[t], q_desc + 2 * kk, k_desc + 2 * kk, kk);
      } else {
        wgmma_ss_n8(sc[t][0], sc[t][1], sc[t][2], sc[t][3], q_desc + 2 * kk, k_desc + 2 * kk, kk);
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int t = 0; t < KT; ++t) reg_fence(sc[t]);

  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][kk][e] = 0u;
  if (!live) return;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < KT; ++t) {
#pragma unroll
    for (int i = 0; i < groups<KT, TAIL>(t); ++i) {
      const int key0 = kTile * t + 8 * i;
      if (key0 >= seq) continue;  // 8 keys past seq: never read again
      const bool whole = key0 + 8 <= seq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[t][4 * i + e] * scale;
        sc[t][4 * i + e] = whole || key0 + 2 * tq + (e & 1) < seq ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][4 * i + e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // exp(x - max) = 2^(x log2 e - max log2 e), one fused step; masked: 2^-inf = 0
  const float mx_log2e[2] = {mx[0] * kLog2e, mx[1] * kLog2e};
#pragma unroll
  for (int t = 0; t < KT; ++t) {
#pragma unroll
    for (int i = 0; i < groups<KT, TAIL>(t); ++i) {
      if (kTile * t + 8 * i >= seq) continue;  // p stays 0
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = exp2_approx(fmaf(sc[t][4 * i + e], kLog2e, -mx_log2e[e >> 1]));
        l[e >> 1] += e4[e];
      }
      // columns 16kk + {2t, 2t+1} (i = 2kk) and 16kk + 8 + {2t, 2t+1}
      // (i = 2kk + 1): rows g, g+8 -> a0, a1, then a2, a3
      p[t][i >> 1][2 * (i & 1) + 0] = pack_bf16(e4[0], e4[1]);
      p[t][i >> 1][2 * (i & 1) + 1] = pack_bf16(e4[2], e4[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// O = P V over the k16 steps of the KT key tiles (one for a narrow last
// tile; keys >= seq: p = 0, V rows zero), V at v_buf as the MN-major B
// operand.
template <int KT, int TAIL>
__device__ __forceinline__ void p_times_v(const uint32_t (&p)[KT][4][4], uint32_t v_buf,
                                          float (&o)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  const uint64_t v_desc = smem_desc(v_buf);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int kk = 0; kk < (groups<KT, TAIL>(t) + 1) / 2; ++kk)
      wgmma_rs(o, p[t][kk], v_desc + (uint64_t)(((kTile * t + 16 * kk) * kRowBytes) >> 4));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(o);
}

// o / l rounded to bf16 into a swizzled 64-row tile (the TMA store's
// layout); warp w of the warpgroup holds rows 16w .. 16w + 15. The quotient
// is x * (1/l) corrected once by its residual, x - q*l (both fused), which
// rounds as the division does but for ties of the reciprocal's own error.
__device__ __forceinline__ void stage_rows(const float (&o)[32], const float (&l)[2],
                                           unsigned char* tile, int warp, int lane) {
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const float inv = 1.0f / l[r];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float xy[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = o[4 * i + 2 * r + e];
        const float q0 = x * inv;
        xy[e] = fmaf(fmaf(-q0, l[r], x), inv, q0);
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + swizzle(row, i) + 4 * tq) =
          __floats2bfloat162_rn(xy[0], xy[1]);
    }
  }
}

}  // namespace one_pass


// TMA loads of an item into a warpgroup's buffers at q (Q), q + kBuf (K),
// q + 2 kBuf (V): K with the arrival that expects Q's and K's bytes, then Q
// (possibly later: the phase completes when both landed), and V.
template <int KT>
__device__ __forceinline__ void load_k(const CUtensorMap* tm_k, const one_pass::Item& it,
                                       uint32_t q, uint32_t qk_full) {
  mbar_arrive_expect_tx(qk_full, (it.tiles + KT) * kTileBytes);
  tma_load_3d(q + one_pass::kBuf, tm_k, qk_full, it.h * kD, 0, it.b);
}

__device__ __forceinline__ void load_q(const CUtensorMap* tm_q, const one_pass::Item& it,
                                       uint32_t q, uint32_t qk_full) {
  for (int j = 0; j < it.tiles; ++j)
    tma_load_3d(q + j * kTileBytes, tm_q, qk_full, it.h * kD, it.row0 + kTile * j, it.b);
}

template <int KT>
__device__ __forceinline__ void load_v(const CUtensorMap* tm_v, const one_pass::Item& it,
                                       uint32_t q, uint32_t v_full) {
  mbar_arrive_expect_tx(v_full, KT * kTileBytes);
  tma_load_3d(q + 2 * one_pass::kBuf, tm_v, v_full, it.h * kD, 0, it.b);
}

// Items: B*H*parts, a part = part_tiles 64-row query tiles of one (b, h);
// KT = ceil(seq/64) key tiles, the last TAIL keys wide. Block j's warpgroup
// w takes items j + (w + kWgs*n) * gridDim.x, and loads its next item as its
// buffers free: Q and K once the item's last query tile has its scores, V
// once that tile's PV is done. A part's tiles run last-first when its last
// tile holds few rows (at S = 196, 4 of 64), so that the loads overlap a
// whole tile's softmax, PV and store. tm_q: boxes of 64 rows; tm_k, tm_v:
// boxes of 64*KT rows; tm_o: the [B,S,C] output, boxes of 64 rows.
template <int KT, int TAIL>
__global__ void __launch_bounds__(one_pass::kBlockThreads, 1)
rope_attention_one_pass_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_o,
                               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                               int seq, int heads, int items, int parts, int part_tiles,
                               float scale) {
  using namespace one_pass;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-byte aligned
  const uint32_t sbase = raw + (uint32_t)(base - smem_raw);
  const int tid = threadIdx.x;
  const int w = tid / 128;
  const int ctid = tid - 128 * w;
  const int warp = ctid >> 5;
  const int lane = ctid & 31;
  // warpgroup w's buffers (Q, K, V, the output tile) and barriers (Q and K
  // landed, V landed)
  unsigned char* q = base + w * kItemBytes;
  unsigned char* k = q + kBuf;
  unsigned char* o_tile = q + 3 * kBuf;
  const uint32_t sq = sbase + w * kItemBytes, sk = sq + kBuf, sv = sk + kBuf, so = sv + kBuf;
  const uint32_t qk_full = sbase + kBarsAt + 16 * w;
  const uint32_t v_full = qk_full + 8;
  const int stride = kWgs * gridDim.x;
  int item = blockIdx.x + w * gridDim.x;
  if (ctid == 0) {
    mbar_init(qk_full, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (item < items) {
      const Item first = item_at(item, heads, parts, part_tiles, KT);
      load_k<KT>(&tm_k, first, sq, qk_full);
      load_q(&tm_q, first, sq, qk_full);
      load_v<KT>(&tm_v, first, sq, v_full);
    }
  }
  named_barrier(1 + w, 128);  // the barriers are initialised
  for (int n = 0; item < items; item += stride, ++n) {
    const Item it = item_at(item, heads, parts, part_tiles, KT);
    const bool more = item + stride < items;
    const Item next = item_at(more ? item + stride : item, heads, parts, part_tiles, KT);
    // the last tile first where it holds under half its rows
    const bool last_first = it.tiles > 1 && seq - (it.row0 + kTile * (it.tiles - 1)) < 32;
    mbar_wait_or_trap(qk_full, n & 1);
    rope_item(q, k, it, seq, cos_t, sin_t, ctid);
    fence_async_shared();
    named_barrier(1 + w, 128);
    for (int step = 0; step < it.tiles; ++step) {
      const int j = last_first ? (step == 0 ? it.tiles - 1 : step - 1) : step;
      const int row0 = it.row0 + kTile * j;
      const bool last = step + 1 == it.tiles;
      const bool live = row0 + 16 * warp < seq;
      uint32_t p[KT][4][4];
      float l[2], o[32];
      scores_to_p<KT, TAIL>(sq + j * kTileBytes, sk, seq, scale, live, lane, p, l);
      if (last && more) {  // Q and K are free: every warp has its scores
        named_barrier(1 + w, 128);
        if (ctid == 0) {
          load_k<KT>(&tm_k, next, sq, qk_full);
          load_q(&tm_q, next, sq, qk_full);
        }
      }
      if (step == 0) mbar_wait_or_trap(v_full, n & 1);
      p_times_v<KT, TAIL>(p, sv, o);
      if (ctid == 0) bulk_wait_read();  // the last tile's store has read o_tile
      named_barrier(1 + w, 128);
      if (live) stage_rows(o, l, o_tile, warp, lane);
      fence_async_shared();
      named_barrier(1 + w, 128);
      if (ctid == 0) {
        tma_store_3d(&tm_o, so, it.h * kD, row0, it.b);
        bulk_commit();
        if (last && more) load_v<KT>(&tm_v, next, sq, v_full);  // V is free: PV is done
      }
    }
  }
  if (ctid == 0) bulk_wait();
}

// ---- host ---------------------------------------------------------------------

constexpr int kMaxDevices = 64;

int sm_count(int device) {
  static int counts[kMaxDevices];  // 0 until read; a benign race writes the same value
  if (device < 0 || device >= kMaxDevices) return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device];
}

// A launch of the one-pass kernel: its tensor maps (q, k, v, out) and
// arguments.
struct OnePassLaunch {
  CUtensorMap maps[4];
  const float* cos_t;
  const float* sin_t;
  int seq, heads, items, parts, part_tiles, grid, device;
  float scale;
  cudaStream_t stream;
};

// The one-pass kernel of KT key tiles (the last TAIL keys wide), its
// dynamic shared memory set once a device.
template <int KT, int TAIL>
cudaError_t launch_one_pass(const OnePassLaunch& a) {
  static bool ready[kMaxDevices];
  if (a.device < 0 || a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[a.device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(rope_attention_one_pass_kernel<KT, TAIL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, one_pass::kSmem);
    if (err != cudaSuccess) return err;
    ready[a.device] = true;
  }
  rope_attention_one_pass_kernel<KT, TAIL>
      <<<a.grid, one_pass::kBlockThreads, one_pass::kSmem, a.stream>>>(
          a.maps[0], a.maps[1], a.maps[2], a.maps[3], a.cos_t, a.sin_t, a.seq, a.heads, a.items,
          a.parts, a.part_tiles, a.scale);
  return cudaGetLastError();
}

// The last key tile 8 keys wide where it holds at most 8 (4 at S = 196).
template <int KT>
cudaError_t launch_one_pass(const OnePassLaunch& a) {
  return a.seq - kTile * (KT - 1) <= 8 ? launch_one_pass<KT, 8>(a) : launch_one_pass<KT, 64>(a);
}

// The RoPE prologue and the key-tile kernel at head dim D over the
// prologue's scratch (roped K, then roped Q at head dim 64) and V, the
// kernel's dynamic shared memory set once a device.
template <int D>
cudaError_t launch_key_tiles(const void* q, const void* k, const void* v, long long row_stride,
                             const float* cos_t, const float* sin_t, void* scratch, void* out,
                             int batch, int seq, int num_heads, float scale, cudaStream_t st,
                             int device) {
  using Block = KeyTileBlock<D>;
  using Tile = typename Block::Tiles::Tile;
  static bool ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(rope_attention_key_tile_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Block::kSmem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const uint64_t rows = (uint64_t)batch * num_heads * seq;
  __nv_bfloat16* k_roped = static_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* q_roped = kPingPong<D> ? k_roped + rows * D : nullptr;
  const dim3 rope_grid((seq + 63) / 64, batch, (num_heads + kPrologueHeads - 1) / kPrologueHeads);
  rope_attention_tc_rope_kernel<D><<<rope_grid, 64 * RopePairs<D>::kPairs, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(q), row_stride,
      cos_t, sin_t, k_roped, q_roped, seq, num_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t c = (uint64_t)num_heads * D;
  CUtensorMap tm_q{}, tm_k, tm_v, tm_o;
  err = encode_bf16_rows(&tm_k, k_roped, D, seq, (uint64_t)batch * num_heads, D, kTile,
                         Tile::kBoxCols);
  if (err == cudaSuccess && kPingPong<D>)
    err = encode_bf16_rows(&tm_q, q_roped, D, seq, (uint64_t)batch * num_heads, D, kTile,
                           Tile::kBoxCols);
  if (err == cudaSuccess)
    err = encode_bf16_rows(&tm_v, v, c, seq, batch, row_stride, kTile, Tile::kBoxCols);
  if (err == cudaSuccess)
    err = encode_bf16_rows(&tm_o, out, c, seq, batch, c, kTile, Tile::kBoxCols);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if constexpr (kPingPong<D>) {
    const int items = (seq + PingPong::kBlockRows - 1) / PingPong::kBlockRows * num_heads * batch;
    const int sms = sm_count(device);
    grid = dim3(items < sms ? items : sms);
  } else {
    grid = dim3((seq + Block::Tiles::kBlockRows - 1) / Block::Tiles::kBlockRows, num_heads, batch);
  }
  rope_attention_key_tile_kernel<D><<<grid, Block::kThreads, Block::kSmem, st>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<const __nv_bfloat16*>(q), row_stride, cos_t, sin_t, seq,
      num_heads, batch, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The schedule of a call on a card of `sms` SMs: 0 for the key-tile kernel
// (head_dim other than 64, or seq > 256), else the parts each head's query
// rows are cut into for the one-pass kernel: 1 (all rows an item) where
// B*H items fill every SM, else parts of two 64-row tiles, else of one.
// Mirrored by flash_attention.py::tc_schedule.
int t3d_rope_attention_tc_schedule(int batch, int seq, int num_heads, int head_dim, int sms) {
  if (head_dim != kD || seq > one_pass::kMaxSeq) return 0;
  const int row_tiles = (seq + kTile - 1) / kTile;
  for (int tiles = one_pass::kMaxTiles; tiles > 1; tiles /= 2) {
    const int parts = (row_tiles + tiles - 1) / tiles;
    if ((long long)batch * num_heads * parts >= sms) return parts;
  }
  return row_tiles;
}

// Bytes of the roped scratch t3d_rope_attention_tc needs for a call: for the
// key-tile kernel a bf16 [batch, num_heads, seq, head_dim] of roped K, and
// at head_dim 64 (the ping-pong schedule) one of roped Q after it; 0 for the
// one-pass kernel (which ropes Q and K in shared memory).
unsigned long long t3d_rope_attention_tc_scratch_bytes(int batch, int seq, int num_heads,
                                                       int head_dim) {
  if (head_dim == kD && seq <= one_pass::kMaxSeq) return 0;
  const int operands = head_dim == kD && kPingPong<kD> ? 2 : 1;
  return (unsigned long long)operands * batch * num_heads * seq * head_dim * 2;
}

// q/k/v: bf16 base pointers of [batch, seq, *] rows `row_stride` elements
// apart (head h at column h*head_dim), 16-byte aligned, row_stride % 8 == 0;
// cos/sin: float32 [seq, head_dim], 16-byte aligned; scratch: the bf16
// scratch of t3d_rope_attention_tc_scratch_bytes, 16-byte aligned, written
// here (unused, may be null, where that is 0); out: bf16 [batch, seq,
// num_heads*head_dim] contiguous, 16-byte aligned. head_dim 16, 32, 64 or
// 128. Launches on `stream`, on the current device: at head_dim 64 and seq
// <= 256 the one-pass kernel, else the RoPE prologue and the key-tile
// kernel. Returns a cudaError_t code.
int t3d_rope_attention_tc(const void* q, const void* k, const void* v, long long row_stride,
                          const float* cos_t, const float* sin_t, void* scratch, void* out,
                          int batch, int seq, int num_heads, int head_dim, float scale,
                          void* stream) {
  if (!serves_head_dim(head_dim) || seq <= 0 || row_stride % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (head_dim == kD && seq <= one_pass::kMaxSeq) {
    OnePassLaunch a;
    const int sms = sm_count(device);
    a.parts = t3d_rope_attention_tc_schedule(batch, seq, num_heads, head_dim, sms);
    const int row_tiles = (seq + kTile - 1) / kTile;
    a.part_tiles = (row_tiles + a.parts - 1) / a.parts;
    const uint64_t c = (uint64_t)num_heads * kD;
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      err = encode_bf16_rows(&a.maps[i], bases[i], c, seq, batch, row_stride,
                             i == 0 ? kTile : kTile * row_tiles);
      if (err != cudaSuccess) return (int)err;
    }
    err = encode_bf16_rows(&a.maps[3], out, c, seq, batch, c, kTile);
    if (err != cudaSuccess) return (int)err;
    a.cos_t = cos_t;
    a.sin_t = sin_t;
    a.seq = seq;
    a.heads = num_heads;
    a.items = batch * num_heads * a.parts;
    a.grid = a.items < sms ? a.items : sms;
    a.device = device;
    a.scale = scale;
    a.stream = st;
    switch (row_tiles) {
      case 1: return (int)launch_one_pass<1>(a);
      case 2: return (int)launch_one_pass<2>(a);
      case 3: return (int)launch_one_pass<3>(a);
      default: return (int)launch_one_pass<4>(a);
    }
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return (int)launch_key_tiles<16>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch,
                                       seq, num_heads, scale, st, device);
    case 32:
      return (int)launch_key_tiles<32>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch,
                                       seq, num_heads, scale, st, device);
    case 64:
      return (int)launch_key_tiles<64>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch,
                                       seq, num_heads, scale, st, device);
    default:
      return (int)launch_key_tiles<128>(q, k, v, row_stride, cos_t, sin_t, scratch, out, batch,
                                        seq, num_heads, scale, st, device);
  }
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }


}  // extern "C"
