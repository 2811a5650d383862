// The key-tile core of the tensor-core attention kernels, CUDA C++ for
// sm_90a: one loop over 64-key tiles that rope_attention_tc.cu (K2/K3 at
// S > 256, and at every S for head dims other than 64; K roped by a
// prologue) and attention_tc.cu (K4-K6, q/k already roped) instantiate in
// bf16 (Bf16Tiles<D>), and attention_3xtf32.cu (K2-K6 in float32, K and V
// split by a prologue) in 3xTF32 (Tf32x3Tiles<D>). Widths D = 16, 32, 64,
// 128 and (bf16) 256, each a compile-time instantiation; the packed entries
// run every other head dim at one of them, zero-padded, their output stored
// by the threads (store_rows); 3xTF32 at 256 runs its own schedule
// (attend_wide, below), and so does K2/K3's bf16 at 64 (attend_ping_pong,
// below: a producer warpgroup and three consumers in ping-pong). The rest of
// this comment is attend's.
//
// Block: 128 query rows of one (batch item, head), two warpgroups of 64
// rows, no producer warp; bf16 two blocks an SM up to D = 64 (128 registers
// a thread; a ninth warp would cap every thread at 168 and leave one block
// an SM), one at D = 128 (O alone is 64 registers a thread), one warpgroup
// of 64 rows at D = 256 (O alone is 128 registers; Bf16Tiles); 3xTF32 one
// (its Q and stages take 96-192 KB of shared memory). 3xTF32 at D = 128 is
// one warpgroup of 64 rows: Q hi and lo of 128 rows would take 128 KB and
// leave no room for a K and a V stage (64 KB each); its one K stage is
// released as soon as its QK^T is done (one warpgroup waits for no other),
// and its PV runs in two halves of 64 columns into one 32-register tile
// accumulator (64 more would not fit beside O, the scores and P).
//   * K and V tiles stream by TMA through rings of stages, each stage with a
//     "full" mbarrier (the TMA's bytes landed) and an "empty" one (every
//     thread of the block is done with it). Thread 0 fills the first
//     stages; of the two warpgroups' thread 0, the one that releases a stage
//     second (the `claims` count) refills it with the tile a ring's length
//     on. bf16 keeps a tile's K and V in one stage of one 4-stage ring,
//     released at the end of iteration t+1 (after PV(t)). 3xTF32 has room
//     for two stages only, and there one ring left no slack: the load of
//     tile t+2 was issued just before it was needed. So it streams K and V
//     through rings of their own (kRingV > 0), iteration t releasing K(t)
//     and V(t-1): each load is issued an iteration ahead. (The split rings
//     measured 7-11% slower for bf16 at S=1024 on an H100; releasing K(t)
//     as soon as its QK^T is done stalls a warpgroup, whose refilling thread
//     waits there for the other warpgroup's QK^T.)
//   * Each warpgroup issues tile t's QK^T (Q and K from shared memory,
//     swizzled rows) together with tile t-1's PV (P from registers, V from
//     shared memory), and runs tile t's online softmax in place on the
//     float32 scores while that PV runs. Only after the PV's wait does it
//     turn p into P's registers (bf16, or tf32 hi and lo) and rescale O by
//     the step's alpha: a write to a register that an issued wgmma still
//     reads (P packed during the PV, into registers ptxas shares between the
//     two tiles' P) makes ptxas serialize every wgmma of the kernel (its
//     C7513 warning), which undoes the overlap.
//   * O / l goes through the warpgroup's Q rows in shared memory and out by
//     TMA stores that drop rows past the query count.
//
// Operand layout at head dim D (attention_tc.cuh's Rows): a 64-row tile of
// Q, K (and bf16 V) is ceil(D * size / 128) panels of 64 rows of
// min(128, D * size) bytes, each panel one TMA box and swizzled as wide as
// its rows; QK^T walks D/16 (bf16) or D/8 (tf32) k-steps of 32 bytes across
// the panels; PV is m64nDk16 (bf16, V MN-major, panels one 64-column atom
// apart) or m64nDk8 (tf32, V^T K-major: D rows of 64 keys in two panels of
// 32 keys).
//
// The tile policy (Tiles) supplies the arithmetic of a precision at a head
// dim: the block's shape, the sizes of a warpgroup's Q rows and of a stage,
// QK^T and PV of a stage, P from the float32 p, and the output's staging.
// The kernel's operands (an Op) supply what differs between kernels:
//   * Op::kQBytes, load_q: Q rows that arrive by TMA on the first stage's
//     full barrier (K4-K6), or none (0; K2/K3);
//   * stage_q: Q rows staged by the warpgroup's threads before the first
//     tile (K2/K3's RoPE; the 3xTF32 split of Q, after it landed), or nothing;
//   * load_k, load_v: tile t's K boxes, V boxes, into a stage of their ring;
//   * softmax: the online-softmax step of a tile, in place (scores scaled,
//     masked past `valid` keys, the running max and float32 sum moved, p in
//     float32 where the score was, alpha for the rescale of O);
//   * store_o: the warpgroup's output boxes.
// Fragment layout of a warpgroup's 64 x N tile (N = 64 keys for the scores,
// D columns for O): the thread owns rows g and g + 8 of its warp's 16 (g =
// lane / 4), columns 8i + 2t + {0, 1} (t = lane % 4); o[4i + e] is row g +
// 8*(e >> 1), column 8i + 2t + (e & 1); l[r] and m[r] belong to row g + 8r.
#pragma once

#include <type_traits>

#include "attention_tc.cuh"
#include "hopper_tma.cuh"

namespace {
namespace key_tiles {

// The shared-memory plan of a tile policy: the warpgroups' Q rows (then
// their output), the K ring (each stage a tile's K, and its V where RingV is
// 0), the V ring, then the barriers (full and empty of each K stage, then of
// each V stage) and the claim counts.
template <int Wgs, int RingK, int RingV, int BlocksPerSm, int WgQBytes, int KBytes, int VBytes>
struct TileShape {
  static constexpr int kWgs = Wgs;                  // warpgroups, 64 query rows each
  static constexpr int kBlockThreads = 128 * Wgs;
  static constexpr int kBlockRows = Wgs * kTile;    // query rows a block
  static constexpr int kRingK = RingK, kRingV = RingV;  // K stages, V stages (0: in K's)
  static constexpr int kBlocksPerSm = BlocksPerSm;
  static constexpr int kWgQBytes = WgQBytes;        // a warpgroup's Q rows
  static constexpr int kQArea = Wgs * WgQBytes;     // the block's Q rows, then its output
  static constexpr int kKBytes = KBytes, kVBytes = VBytes;  // one tile's K, V
  static constexpr int kKStage = RingV ? KBytes : KBytes + VBytes;
  static constexpr int kVRingAt = kQArea + RingK * kKStage;
  static constexpr int kBarsAt = kVRingAt + RingV * VBytes;
  static constexpr int kSmem = 1024 + kBarsAt + 16 * (RingK + RingV) + 4 * (RingK + RingV);
  static_assert(kSmem * BlocksPerSm <= 232448, "more shared memory than an H100 SM has");
};

// A 64-row operand tile of D elements of `Size` bytes a row, K-major: panels
// of 64 rows of kRowBytes = min(128, D * Size) bytes (attention_tc.cuh's
// Rows), one after the other.
template <int D, int Size>
struct RowTile {
  static constexpr int kRowBytes = D * Size < 128 ? D * Size : 128;
  static constexpr int kPanels = D * Size / kRowBytes;
  static constexpr int kPanel = kTile * kRowBytes;      // bytes of a panel
  static constexpr int kBytes = kPanels * kPanel;       // of the tile
  static constexpr int kBoxCols = kRowBytes / Size;     // elements of a panel row (a TMA box)
  using R = Rows<kRowBytes>;

  // the byte offset of element `col` of row `row` (col * Size a multiple of 8)
  static __device__ __forceinline__ uint32_t at(int row, int col) {
    const int byte = col * Size;
    return (uint32_t)((byte / kRowBytes) * kPanel) + R::at(row, (byte % kRowBytes) >> 4) +
           (byte & 15);
  }
  // descriptor offset (16-byte units) of the 32-byte k-step kk of a K-major use
  static __device__ __forceinline__ constexpr uint64_t k_step(int kk) {
    return (uint64_t)((((32 * kk) / kRowBytes) * kPanel + (32 * kk) % kRowBytes) >> 4);
  }
};

// bf16 at head dim D: Q, K and V tiles of 64 rows (RowTile<D, 2>), QK^T D/16
// k-steps of m64n64k16, PV m64nDk16 into O, P rounded to bf16, the output
// rounded to bf16. Up to D = 128 two warpgroups and one 4-stage ring of K
// and V; at D = 256 (O alone is 128 registers a thread) one warpgroup of 64
// rows under the 255-register cap, with K and V in 2-stage rings of their
// own and K(t) released after its QK^T (kEarlyK): each load is issued an
// iteration ahead (Q 32 KB, each stage 32 KB: 160 KB).
template <int D>
struct Bf16Tiles : TileShape<D <= 128 ? 2 : 1, D <= 128 ? 4 : 2, D <= 128 ? 0 : 2,
                             D <= 64 ? 2 : 1, 2 * kTile * D, 2 * kTile * D, 2 * kTile * D> {
  using Tile = RowTile<D, 2>;
  using P = uint32_t[4][4];  // P of a tile, PV's A operand
  static constexpr int kO = D / 2;        // O's accumulators a thread
  static constexpr int kPv = 1;           // no tile accumulator
  static constexpr bool kTilePv = false;  // PV accumulates into O itself
  static constexpr bool kSplitPv = false, kEarlyK = D > 128;

  static __device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q, uint32_t k) {
    const uint64_t q_desc = Tile::R::desc(q), k_desc = Tile::R::desc(k);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, q_desc + Tile::k_step(kk), k_desc + Tile::k_step(kk), kk);
  }
  // O += P V, into O itself (pv unused); V MN-major, its panels the 64-column
  // atoms along N
  static __device__ __forceinline__ void issue_pv(float (&o)[kO], float (&)[kPv], const P& p,
                                                  uint32_t v) {
    const uint64_t v_desc =
        Tile::R::desc(v, Tile::kPanels > 1 ? Tile::kPanel : 8 * Tile::kRowBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n<D>(o, p[kk], v_desc + (uint64_t)((16 * Tile::kRowBytes * kk) >> 4));
  }
  // after the PV's wait: O *= alpha (the next tile's rescale); at the end, nothing
  static __device__ __forceinline__ void rescale(float (&o)[kO], const float (&)[kPv],
                                                 const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + e] *= alpha[e >> 1];
  }
  static __device__ __forceinline__ void add_last(float (&)[kO], const float (&)[kPv]) {}
  // P, bf16, from the float32 p in sc: columns 16kk + {2t, 2t+1} (i = 2kk)
  // and 16kk + 8 + {2t, 2t+1} (i = 2kk + 1), rows g, g+8 -> a0, a1, then
  // a2, a3
  static __device__ __forceinline__ void pack(P& p, const float (&sc)[32]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p[i >> 1][2 * (i & 1) + 0] = pack_bf16(sc[4 * i], sc[4 * i + 1]);
      p[i >> 1][2 * (i & 1) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
    }
  }
  // o / l rounded to bf16 into the warpgroup's Q rows (one 64-row tile)
  static __device__ __forceinline__ void stage_out(unsigned char* tile, const float (&o)[kO],
                                                   const float (&l)[2], int ctid) {
    const int warp = ctid >> 5, g = (ctid & 31) >> 2, tq = ctid & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float x = o[4 * i + 2 * r] / l[r];
        const float y = o[4 * i + 2 * r + 1] / l[r];
        *reinterpret_cast<__nv_bfloat162*>(tile + Tile::at(row, 8 * i) + 4 * tq) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
};

// 3xTF32 (float32 operands) at head dim D: Q and K are RowTile<D, 4> (a
// warpgroup's Q is its hi tile then its lo tile; a K stage holds K hi and K
// lo); a V stage holds V^T hi and V^T lo, split by the prologue
// (attention_3xtf32.cu), each D rows of 64 keys in two panels of 32 keys
// (128-byte rows, D * 128 bytes a panel), K-major. Every product is hi*lo +
// lo*hi, then hi*hi. P = p split into tf32 hi and lo; the output o / l in
// float32. D = 128 runs one warpgroup a block, its K stage released early
// and its PV in two halves (the header).
template <int D>
struct Tf32x3Tiles
    : TileShape<D <= 64 ? 2 : 1, D <= 64 ? 2 : 1, D <= 64 ? 2 : 1, 1, 2 * RowTile<D, 4>::kBytes,
                2 * RowTile<D, 4>::kBytes, 2 * 2 * D * 128> {
  using Tile = RowTile<D, 4>;
  static constexpr int kVtPanel = D * 128;      // 32 keys of V^T
  static constexpr int kVtTile = 2 * kVtPanel;  // 64 keys of V^T (hi or lo)
  struct P {
    uint32_t hi[8][4], lo[8][4];  // k-step kk: keys 8kk + 2t (a0, a1), 8kk + 2t + 1 (a2, a3)
  };
  static constexpr bool kTilePv = true;   // a tile's PV into pv, added to O (issue_pv)
  static constexpr bool kSplitPv = D > 64;  // PV in two halves of 64 columns
  static constexpr bool kEarlyK = D > 64;   // one warpgroup: K(t) free after its QK^T
  static constexpr int kPvCols = kSplitPv ? 64 : D;  // columns of one PV product
  static constexpr int kO = D / 2, kPv = kPvCols / 2;

  // descriptor offset of k-step kk (8 keys) in a V^T operand
  static __device__ __forceinline__ constexpr uint64_t vt_step(int kk) {
    return (uint64_t)(((kk >> 2) * kVtPanel + (kk & 3) * 32) >> 4);
  }
  // (The ragged last tile's products run whole: skipping its empty k-steps
  // behind a branch made ptxas insert warpgroup.arrive around the wgmma
  // (C7519) and measured 1.1-1.3x slower on an H100.)
  static __device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q, uint32_t k) {
    const uint64_t qh = Tile::R::desc(q), ql = Tile::R::desc(q + Tile::kBytes);
    const uint64_t kh = Tile::R::desc(k), kl = Tile::R::desc(k + Tile::kBytes);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss(sc, qh + Tile::k_step(kk), kl + Tile::k_step(kk), kk);
      wgmma_tf32_ss(sc, ql + Tile::k_step(kk), kh + Tile::k_step(kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_tf32_ss(sc, qh + Tile::k_step(kk), kh + Tile::k_step(kk), 1);
  }
  // One tile's P V (columns 64 * half on, kPvCols of them) into pv, a fresh
  // accumulator (O is not a wgmma operand): the tensor cores round a float32
  // accumulator toward zero at each step, so O's 24 steps a tile over every
  // tile biased it by hundreds of ulps at S = 1024; a tile's 24 steps into
  // pv, added to O by round-to-nearest (rescale, add_last), keep that to a
  // tile's few.
  static __device__ __forceinline__ void issue_pv_cols(float (&pv)[kPv], const P& p, uint32_t v,
                                                       int half) {
    const uint32_t rows = v + half * 64 * 128;  // V^T rows 64 * half on
    const uint64_t vh = Rows<128>::desc(rows), vl = Rows<128>::desc(rows + kVtTile);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_tf32_rs_n<kPvCols>(pv, p.hi[kk], vl + vt_step(kk), kk);
      wgmma_tf32_rs_n<kPvCols>(pv, p.lo[kk], vh + vt_step(kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_tf32_rs_n<kPvCols>(pv, p.hi[kk], vh + vt_step(kk), 1);
  }
  // the PV the loop issues with the next tile's QK^T: all columns, or the
  // first half (finish_split issues the second)
  static __device__ __forceinline__ void issue_pv(float (&)[kO], float (&pv)[kPv], const P& p,
                                                  uint32_t v) {
    issue_pv_cols(pv, p, v, 0);
  }
  // after the PV's wait: O = (O + pv) * alpha (pv the last tile's, 0 before
  // the first); at the end O += pv
  static __device__ __forceinline__ void rescale(float (&o)[kO], const float (&pv)[kPv],
                                                 const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < kPv; ++i) o[i] = (o[i] + pv[i]) * alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = kPv; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];  // split PV: before the first
  }
  static __device__ __forceinline__ void add_last(float (&o)[kO], const float (&pv)[kPv]) {
#pragma unroll
    for (int i = 0; i < kPv; ++i) o[i] += pv[i];
  }
  // split PV, after the first half's wait (pv: columns 0-63): those columns
  // moved into O, then the second half's PV (P and V of the same tile) run
  // and waited for, and moved in; alpha = 1 at the end (add_last)
  static __device__ __forceinline__ void finish_split(float (&o)[kO], float (&pv)[kPv],
                                                      const float (&alpha)[2], const P& p,
                                                      uint32_t v) {
#pragma unroll
    for (int i = 0; i < kPv; ++i) o[i] = (o[i] + pv[i]) * alpha[(i >> 1) & 1];
    wgmma_fence();
    issue_pv_cols(pv, p, v, 1);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(pv);
#pragma unroll
    for (int i = 0; i < kPv; ++i) o[kPv + i] = (o[kPv + i] + pv[i]) * alpha[(i >> 1) & 1];
  }
  // The A fragment of k-step kk from the scores' 8-column group kk. A tf32
  // A fragment holds columns t and t + 4 (rows g, g+8, g, g+8: a0-a3), the
  // scores columns 2t and 2t + 1, so within each 8-key group P's columns
  // are taken in the key order 0, 2, 4, 6, 1, 3, 5, 7, the order in which the
  // prologue lays out V^T's keys (attention_3xtf32.cu).
  static __device__ __forceinline__ void pack(P& p, const float (&sc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i & 3) == 1 ? 2 : (i & 3) == 2 ? 1 : (i & 3);
      split_tf32(sc[i], p.hi[i >> 2][e], p.lo[i >> 2][e]);
    }
  }
  // o / l in float32 into the warpgroup's Q hi tile
  static __device__ __forceinline__ void stage_out(unsigned char* tile, const float (&o)[kO],
                                                   const float (&l)[2], int ctid) {
    const int warp = ctid >> 5, g = (ctid & 31) >> 2, tq = ctid & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float2 xy = make_float2(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
        *reinterpret_cast<float2*>(tile + Tile::at(row, 8 * i + 2 * tq)) = xy;
      }
    }
  }
};

// The 3xTF32 kernels' online softmax of one 64-key tile (expf, every tile
// masked): scores scaled and masked past `valid` keys, the running max and
// sum moved, p = exp(s - m) in place of the scores. Its split into tf32 hi
// and lo as PV's A operand and the output's rescale by alpha are left to the
// caller (after the previous tile's PV).
__device__ __forceinline__ void online_softmax_tile(float (&sc)[32], int valid, float scale,
                                                    int tq, float (&m)[2], float (&l)[2],
                                                    float (&alpha)[2]) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * tq + (e & 1);
      const float x = col < valid ? sc[4 * i + e] * scale : -INFINITY;
      sc[4 * i + e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);  // finite: every tile has a key
    alpha[r] = expf(m[r] - m_new);             // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = expf(sc[i] - m[(i >> 1) & 1]);  // masked: exp(-inf) = 0
    l[(i >> 1) & 1] += sc[i];
  }
}

// The online softmax of one 64-key tile on raw scores s (QK^T, unscaled),
// in place: with c = scale * log2(e), the running max m of s, p = 2^(s*c -
// m*c) in one FFMA and a MUFU op (exp(s*scale - max) up to rounding), alpha
// = 2^((m_old - m_new)*c), 0 on the first tile; keys past `valid` masked
// where kMask (the last tile only), p = 0 there. The float32 sum l moves
// with alpha; p's rounding to bf16 and O's rescale are the caller's. K2-K6
// in bf16 take it at every head dim.
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

// One block's attention over `seq` keys (see the header comment): smem_raw
// is the kernel's dynamic shared memory (Tiles::kSmem bytes), op its operands.
template <class Tiles, class Op>
__device__ __forceinline__ void attend(unsigned char* smem_raw, const Op& op, int seq) {
  constexpr int RK = Tiles::kRingK, RV = Tiles::kRingV;
  constexpr int RV1 = RV > 0 ? RV : 1;  // V's stage arithmetic, never taken where RV is 0
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-byte aligned
  const uint32_t sbase = raw + (uint32_t)(base - smem_raw);
  const uint32_t k_ring = sbase + Tiles::kQArea;
  const uint32_t v_ring = sbase + Tiles::kVRingAt;
  const uint32_t full_k = sbase + Tiles::kBarsAt;  // K stage s: TMA landed
  const uint32_t empty_k = full_k + 8 * RK;        // K stage s: every thread done with it
  const uint32_t full_v = empty_k + 8 * RK;
  const uint32_t empty_v = full_v + 8 * RV;
  unsigned int* claims_k =
      reinterpret_cast<unsigned int*>(base + Tiles::kBarsAt + 16 * (RK + RV));
  unsigned int* claims_v = claims_k + RK;
  const int tid = threadIdx.x;
  const int w = tid / 128;
  const int ctid = tid - 128 * w;
  const int tq = ctid & 3;
  const int block_row0 = blockIdx.x * Tiles::kBlockRows;
  const int ntiles = (seq + kTile - 1) / kTile;
  auto k_stage = [&](int t) { return k_ring + (t % RK) * Tiles::kKStage; };
  auto v_stage = [&](int t) {
    return RV ? v_ring + (t % RV1) * Tiles::kVBytes : k_stage(t) + Tiles::kKBytes;
  };
  auto load_k = [&](int t) {  // and V, where it shares K's stage
    const uint32_t bar = full_k + 8 * (t % RK);
    mbar_arrive_expect_tx(bar, Tiles::kKStage + (t == 0 ? Op::kQBytes : 0));
    if (t == 0) op.load_q(sbase, bar, block_row0);
    op.load_k(k_stage(t), bar, t);
    if constexpr (RV == 0) op.load_v(v_stage(t), bar, t);
  };
  auto load_v = [&](int t) {
    const uint32_t bar = full_v + 8 * (t % RV1);
    mbar_arrive_expect_tx(bar, Tiles::kVBytes);
    op.load_v(v_stage(t), bar, t);
  };
  if (tid == 0) {
    for (int st = 0; st < RK + RV; ++st) {  // the K stages' barriers, then the V stages'
      const uint32_t full = st < RK ? full_k + 8 * st : full_v + 8 * (st - RK);
      mbar_init(full, 1);
      mbar_init(full + 8 * (st < RK ? RK : RV), Tiles::kBlockThreads);
      claims_k[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < RK && t < ntiles; ++t) load_k(t);
    for (int t = 0; t < RV && t < ntiles; ++t) load_v(t);
  }
  __syncthreads();
  // every thread is done with tile t's stage of a ring (empty, claims, its
  // length R); of the two warpgroups' thread 0, the second to get here
  // (with one warpgroup, its thread 0) refills it with tile t + R
  auto release = [&](uint32_t empty, unsigned int* claims, int R, int t, auto&& refill) {
    const int st = t % R;
    mbar_arrive(empty + 8 * st);
    if constexpr (Tiles::kWgs == 1) {
      if (ctid == 0) {
        mbar_wait_or_trap(empty + 8 * st, (t / R) & 1);
        if (t + R < ntiles) refill(t + R);
      }
    } else {
      if (ctid == 0 && (atomicAdd(&claims[st], 1u) & 1u)) {
        mbar_wait_or_trap(empty + 8 * st, (t / R) & 1);
        if (t + R < ntiles) refill(t + R);
      }
    }
  };
  auto release_k = [&](int t) { release(empty_k, claims_k, RK, t, load_k); };
  auto release_v = [&](int t) { release(empty_v, claims_v, RV1, t, load_v); };
  // the end of iteration t: K(t) (unless released after its QK^T, kEarlyK)
  // and V(t-1) with rings of their own, else the stage of tile t-1
  auto release_tiles = [&](int t) {
    if constexpr (RV > 0) {
      if constexpr (!Tiles::kEarlyK) release_k(t);
      release_v(t - 1);
    } else {
      release_k(t - 1);
    }
  };

  const uint32_t my_q = sbase + w * Tiles::kWgQBytes;
  const int row_base = block_row0 + w * kTile;
  op.stage_q(my_q, row_base, ctid, w, full_k);

  float sc[32], o[Tiles::kO], pv[Tiles::kPv];  // pv: a tile's P V where the policy keeps one
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < Tiles::kO; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < Tiles::kPv; ++i) pv[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  typename Tiles::P p;  // P of the last tile, PV's A operand

  mbar_wait_or_trap(full_k, 0);
  wgmma_fence();
  Tiles::issue_qk(sc, my_q, k_stage(0));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(sc);
  if constexpr (Tiles::kEarlyK) release_k(0);
  op.softmax(sc, seq, tq, m, l, alpha);
  Tiles::pack(p, sc);
  Tiles::rescale(o, pv, alpha);
  if constexpr (RV > 0 && !Tiles::kEarlyK) release_k(0);
  for (int t = 1; t < ntiles; ++t) {
    mbar_wait_or_trap(full_k + 8 * (t % RK), (t / RK) & 1);
    if constexpr (RV > 0) mbar_wait_or_trap(full_v + 8 * ((t - 1) % RV1), ((t - 1) / RV1) & 1);
    wgmma_fence();
    Tiles::issue_qk(sc, my_q, k_stage(t));
    wgmma_commit();
    Tiles::issue_pv(o, pv, p, v_stage(t - 1));
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // QK^T of tile t
    reg_fence(sc);
    if constexpr (Tiles::kEarlyK) release_k(t);
    op.softmax(sc, seq - kTile * t, tq, m, l, alpha);  // in sc: PV reads p
    wgmma_wait_all();  // PV of tile t - 1
    reg_fence(o);
    if constexpr (Tiles::kTilePv) reg_fence(pv);
    if constexpr (Tiles::kSplitPv) {
      Tiles::finish_split(o, pv, alpha, p, v_stage(t - 1));  // reads P(t - 1): pack after
      Tiles::pack(p, sc);
    } else {
      Tiles::pack(p, sc);
      Tiles::rescale(o, pv, alpha);
    }
    release_tiles(t);
  }
  if constexpr (RV > 0)
    mbar_wait_or_trap(full_v + 8 * ((ntiles - 1) % RV1), ((ntiles - 1) / RV1) & 1);
  wgmma_fence();
  Tiles::issue_pv(o, pv, p, v_stage(ntiles - 1));
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(o);
  if constexpr (Tiles::kTilePv) reg_fence(pv);
  if constexpr (Tiles::kSplitPv) {
    const float one[2] = {1.0f, 1.0f};
    Tiles::finish_split(o, pv, one, p, v_stage(ntiles - 1));
  } else {
    Tiles::add_last(o, pv);
  }
  if constexpr (RV > 0) {
    release_v(ntiles - 1);
  } else {
    release_k(ntiles - 1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // o / l into the warpgroup's Q rows, out by TMA stores (or by the
  // threads, Op::kThreadStore); rows past the query count are dropped
  Tiles::stage_out(base + w * Tiles::kWgQBytes, o, l, ctid);
  fence_async_shared();
  named_barrier(1 + w, 128);
  if constexpr (Op::kThreadStore) {
    op.store_rows(base + w * Tiles::kWgQBytes, row_base, ctid);
  } else if (ctid == 0) {
    op.store_o(my_q, row_base);
    bulk_commit();
    bulk_wait();
  }
}

// ---- bf16 at head dim 64: a producer and three consumers in ping-pong -------
//
// At head dim 64 a 64 x 64 tile's two products take about as long on an SM's
// tensor cores (~256 clocks) as its 4,096 exponentials on the MUFU units, and
// each product is a chain of four dependent wgmma, so attend's pace there is
// set by how many warpgroups have a product or a softmax ready. This
// schedule, after FlashAttention-3 (Shah et al., 2024, §3.1-3.2), keeps the
// softmax off the tensor cores' critical path:
//   * One block an SM, persistent: it walks work items (kBlockRows = 192
//     query rows of one (batch item, head)) with a static stride, items of
//     one head on neighbouring SMs at once, so K and V come from L2.
//   * Warpgroup 0 is the producer: it gives registers back (regs_down), and
//     one thread keeps a ring of kStages 64-key tiles full by TMA (a tile's K,
//     then its V; "full" and "empty" mbarriers a stage) and each item's Q
//     rows in one of two slots, loaded once the item two back has released
//     its slot.
//   * Warpgroups 1-3 are the consumers, 64 query rows each (regs_up). Named
//     barriers pass the tensor cores from one to the next in turn (FA3's
//     ping-pong, over three): a consumer issues tile t's QK^T with tile
//     t-1's PV, hands the turn on, and runs tile t's softmax while the others'
//     products run; P(t) is packed and O rescaled after PV(t-1)'s wait, so no
//     issued wgmma reads a register being written (ptxas' C7513).
//   * Each consumer's O / l goes out through a tile of its own by a TMA store
//     that drops rows past the query count (a head's ragged last item
//     computes them all the same); the next item's store waits only for this
//     one to have read its tile.
// Measured on an H100 at head dim 64 against attend's two blocks an SM (4
// warpgroups): 0.86x at S = 32,976 (1.16x its rate), 1.00x at [24, 1374]
// and [16, 1024] x 16 heads, 1.07-1.12x at 12 heads of S = 1024 (a ragged
// sixth item a head, and a last wave a third full). Slower variants: two
// consumers (8 math warps an SM) read 0.73-0.93x attend's rate whether their
// products took turns or not; two score buffers (tile t+1's QK^T issued
// before tile t's softmax) were no faster with two consumers and do not fit
// three (128 registers a thread: ptxas does not raise its cap past
// setmaxnreg.inc, and 128-key tiles spilled at two consumers' 168); turns
// skipped by the consumers of a ragged item's rows past the query count
// slowed every shape (1.06-1.08x). The operands (an Op): rows, keys, heads,
// batch, c (scale * log2(e)), and load_q, load_k, load_v (64 rows each, onto
// a full barrier) and store_o (64 rows), by (b, h, first row).
struct PingPongTiles {
  using Tile = RowTile<64, 2>;                   // 64 rows of 64 bf16, 8 KB
  static constexpr int kStages = 8;              // the ring's 64-key tiles
  static constexpr int kConsumers = 3;           // warpgroups of 64 query rows
  static constexpr int kBlockThreads = 128 * (1 + kConsumers);
  static constexpr int kBlockRows = kConsumers * kTile;
  // setmaxnreg: 24 for the producer, the rest for the consumers, of the 128 a
  // thread a block of 512 threads starts with
  static constexpr int kProducerRegs = 24, kConsumerRegs = 160;
  static_assert(kProducerRegs + kConsumers * kConsumerRegs <= 128 * (1 + kConsumers),
                "more registers than the block holds");
  static constexpr int kQSlot = kConsumers * Tile::kBytes;  // an item's Q rows
  static constexpr int kStage = 2 * Tile::kBytes;           // a tile's K, then its V
  static constexpr int kOAt = 2 * kQSlot;                   // two Q slots, then O tiles
  static constexpr int kRingAt = kOAt + kConsumers * Tile::kBytes;
  static constexpr int kBarsAt = kRingAt + kStages * kStage;
  static constexpr int kSmem = 1024 + kBarsAt + 8 * (2 * kStages + 4);
  static_assert(kSmem <= 232448, "more shared memory than an H100 block may use");
};

template <class Op>
__device__ __forceinline__ void attend_ping_pong(unsigned char* smem_raw, const Op& op) {
  using T = PingPongTiles;
  using Tiles = Bf16Tiles<64>;  // a 64 x 64 tile's products, P and output staging
  using Tile = T::Tile;
  constexpr int S = T::kStages, C = T::kConsumers;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-byte aligned
  const uint32_t sbase = raw + (uint32_t)(base - smem_raw);
  const uint32_t ring = sbase + T::kRingAt;
  const uint32_t full = sbase + T::kBarsAt;  // stage s: its K and V landed
  const uint32_t empty = full + 8 * S;       // stage s: every consumer is done with it
  const uint32_t q_full = empty + 8 * S;     // Q slot j: the item's rows landed
  const uint32_t q_empty = q_full + 16;      // Q slot j: every QK^T of its item is done
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int ctid = tid - 128 * wg;
  const int row_blocks = (op.rows + T::kBlockRows - 1) / T::kBlockRows;
  const int items = row_blocks * op.heads * op.batch;
  const int ntiles = (op.keys + kTile - 1) / kTile;
  auto decode = [&](int item, int& b, int& h, int& row0) {
    const int bh = item / row_blocks;
    row0 = (item - bh * row_blocks) * T::kBlockRows;
    b = bh / op.heads;
    h = bh - b * op.heads;
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * C);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full + 8 * j, 1);
      mbar_init(q_empty + 8 * j, 128 * C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_down<T::kProducerRegs>();
    if (ctid == 0) {
      int it = 0;  // key tiles loaded so far
      for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
        int b, h, row0;
        decode(item, b, h, row0);
        const int slot = n & 1;
        if (n >= 2) mbar_wait_or_trap(q_empty + 8 * slot, ((n >> 1) - 1) & 1);
        mbar_arrive_expect_tx(q_full + 8 * slot, T::kQSlot);
#pragma unroll
        for (int w = 0; w < C; ++w)
          op.load_q(sbase + slot * T::kQSlot + w * Tile::kBytes, q_full + 8 * slot, b, h,
                    row0 + w * kTile);
        for (int t = 0; t < ntiles; ++t, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait_or_trap(empty + 8 * s, ((it / S) - 1) & 1);
          const uint32_t stage = ring + s * T::kStage, bar = full + 8 * s;
          mbar_arrive_expect_tx(bar, T::kStage);
          op.load_k(stage, bar, b, h, kTile * t);
          op.load_v(stage + Tile::kBytes, bar, b, h, kTile * t);
        }
      }
    }
    return;
  }

  // a consumer: query rows 64 w .. 64 w + 63 of each item
  regs_up<T::kConsumerRegs>();
  const int w = wg - 1;
  const int tq = ctid & 3;
  const uint32_t my_o = sbase + T::kOAt + w * Tile::kBytes;
  // named barrier kTurn + w: consumer w's turn at the tensor cores, handed on
  // by consumer w - 1 (consumer 0's by the last); consumer 0 goes first
  constexpr int kTurn = 1 + C;
  const int my_turn = kTurn + w, next_turn = kTurn + (w + 1) % C;
  if (w == C - 1) named_barrier_arrive(kTurn, 256);
  float sc[32], o[32], pv[Tiles::kPv];  // pv: unused (PV accumulates into O)
  float m[2], l[2], alpha[2];
  Tiles::P p;  // P of the last softmax, PV's A operand
  int it = 0;  // key tiles consumed so far
  for (int item = blockIdx.x, n = 0; item < items; item += gridDim.x, ++n) {
    int b, h, row0;
    decode(item, b, h, row0);
    const int slot = n & 1;
    const uint32_t my_q = sbase + slot * T::kQSlot + w * Tile::kBytes;
    // the last turn of the block's last item hands nothing on: the last
    // consumer started with one hand-over, so each barrier gets as many as
    // it waits for
    const bool hand_on_last = !(w == C - 1 && item + (int)gridDim.x >= items);
    auto stage = [&](int t) { return ring + ((it + t) % S) * T::kStage; };
    auto wait_tile = [&](int t) {
      mbar_wait_or_trap(full + 8 * ((it + t) % S), ((it + t) / S) & 1);
    };
    auto release = [&](int t) { mbar_arrive(empty + 8 * ((it + t) % S)); };
    auto take_turn = [&] {
      named_barrier(my_turn, 256);
      wgmma_fence();
    };
    auto hand_on = [&] { named_barrier_arrive(next_turn, 256); };
    auto softmax = [&](int t) {
      const int valid = op.keys - kTile * t;
      if (valid < kTile) {
        exp2_softmax_tile<true>(sc, valid, op.c, tq, m, l, alpha);
      } else {
        exp2_softmax_tile<false>(sc, valid, op.c, tq, m, l, alpha);
      }
    };
    mbar_wait_or_trap(q_full + 8 * slot, (n >> 1) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
    wait_tile(0);
    take_turn();
    Tiles::issue_qk(sc, my_q, stage(0));
    wgmma_commit();
    hand_on();
    wgmma_wait<0>();
    reg_fence(sc);
    if (ntiles == 1) mbar_arrive(q_empty + 8 * slot);
    softmax(0);
    Tiles::pack(p, sc);  // O is 0: nothing to rescale
    for (int t = 1; t < ntiles; ++t) {
      wait_tile(t);
      take_turn();
      Tiles::issue_qk(sc, my_q, stage(t));
      wgmma_commit();
      Tiles::issue_pv(o, pv, p, stage(t - 1) + Tile::kBytes);
      wgmma_commit();
      hand_on();
      wgmma_wait<1>();  // QK^T(t)
      reg_fence(sc);
      if (t == ntiles - 1) mbar_arrive(q_empty + 8 * slot);  // Q read by every QK^T
      softmax(t);
      wgmma_wait<0>();  // PV(t-1)
      reg_fence(o);
      release(t - 1);
      Tiles::pack(p, sc);
      Tiles::rescale(o, pv, alpha);
    }
    take_turn();
    Tiles::issue_pv(o, pv, p, stage(ntiles - 1) + Tile::kBytes);
    wgmma_commit();
    if (hand_on_last) hand_on();
    wgmma_wait<0>();
    reg_fence(o);
    release(ntiles - 1);
    it += ntiles;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // o / l into this consumer's output tile, once its last store has read
    // it, then out by TMA (rows past the query count dropped)
    if (ctid == 0) bulk_wait_read();
    named_barrier(1 + w, 128);
    Tiles::stage_out(base + T::kOAt + w * Tile::kBytes, o, l, ctid);
    fence_async_shared();
    named_barrier(1 + w, 128);
    if (ctid == 0) {
      op.store_o(my_o, b, h, row0 + w * kTile);
      bulk_commit();
    }
  }
  if (ctid == 0) bulk_wait();
}

// The warpgroup's output tile staged at `tile` (a RowTile of the output's
// element type T, bf16 or float32) out by its 128 threads: the first d
// columns (d a multiple of 4) of each of its 64 rows below `rows`, 4
// elements a store (8 or 16 bytes), to out (the head's row 0) rows
// `row_stride` elements apart. Where a head's row is not a whole number of
// 16-byte chunks (bf16 d = 4 mod 8), or narrower than the staged row, a TMA
// store of the tile's boxes would write past it into the next head.
template <class Tile, class T>
__device__ __forceinline__ void store_rows(const unsigned char* tile, T* out,
                                           long long row_stride, int d, int row_base,
                                           int rows, int ctid) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or float32");
  using V = typename std::conditional<sizeof(T) == 2, uint2, uint4>::type;
  const int chunks = d / 4;
  for (int task = ctid; task < kTile * chunks; task += 128) {
    const int r = task / chunks;
    const int c = 4 * (task - r * chunks);
    if (row_base + r >= rows) break;  // tasks run row by row
    *reinterpret_cast<V*>(out + (long long)(row_base + r) * row_stride + c) =
        *reinterpret_cast<const V*>(tile + Tile::at(r, c));
  }
}

// ---- the packed route's prologues ------------------------------------------

// (batch, head, row) strides of an operand in elements; head_dim contiguous
struct HeadStrides {
  long long batch, head, row;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements of p in float32: one 8-byte (bf16) or 16-byte
// (float32) load where p is aligned to it, else four scalar loads.
__device__ __forceinline__ void load_quad(const __nv_bfloat16* __restrict__ p, float (&x)[4]) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
    x[0] = __low2float(lo);
    x[1] = __high2float(lo);
    x[2] = __low2float(hi);
    x[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ void load_quad(const float* __restrict__ p, float (&x)[4]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[i];
  }
}

// Elements e .. e + 3 (e a multiple of 4, d too, so the four lie all below
// d or all at or past it) of a packed row: 0 past d, else the source row's,
// roped where cos_row is not null: t[c] cos[c] + rot(t)[c] sin[c], rot(t)[c]
// = -t[c + d/4] on the even quarters and t[c - d/4] on the odd
// (flash_attention.py::rot_lanes), each product and the sum rounded
// separately, as in the direct kernels. The row may start at any element
// (load_quad); where d/4 is a multiple of 4 the four lie in one quarter and
// their partners are four consecutive elements too.
template <class T>
__device__ __forceinline__ void packed_quad(const T* __restrict__ row, int e, int d,
                                            const float* __restrict__ cos_row,
                                            const float* __restrict__ sin_row, float (&x)[4]) {
  if (e >= d) {
    x[0] = x[1] = x[2] = x[3] = 0.0f;
    return;
  }
  load_quad(row + e, x);
  if (cos_row == nullptr) return;
  const int quarter = d >> 2;
  float c[4], s[4], y[4];
  load_quad(cos_row + e, c);
  load_quad(sin_row + e, s);
  bool odd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    odd[i] = ((e + i >= quarter) + (e + i >= 2 * quarter) + (e + i >= 3 * quarter)) & 1;
  if ((quarter & 3) == 0) {
    load_quad(row + (odd[0] ? e - quarter : e + quarter), y);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = to_float(row[odd[i] ? e + i - quarter : e + i + quarter]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(odd[i] ? y[i] : -y[i], s[i]));
}

// The byte strides of a 4-D map of operand i (0 q, 1 k, 2 v, 3 out) of a
// packed call, from its element strides (0 for an axis of size 1, which the
// kernel never steps along and a map takes as one row's bytes) and the
// element size. Host code.
inline void operand_bytes(const long long* strides, int i, int d, int es, uint64_t (&bytes)[3]) {
  for (int j = 0; j < 3; ++j)
    bytes[j] = strides[3 * i + j] ? (uint64_t)strides[3 * i + j] * es : (uint64_t)d * es;
}

// Whether TMA can read operand i of a packed call in place: a 16-byte
// aligned base, rows of d elements a whole number of 16-byte chunks, every
// stride a multiple of 16 bytes. Its map's innermost extent is then d, so
// the boxes of a padded width read zeros past d and never a lane of the
// next head. Host code.
inline bool in_place(const void* base, const long long* strides, int i, int d, int es) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || (d * es) % 16) return false;
  for (int j = 0; j < 3; ++j)
    if ((strides[3 * i + j] * es) % 16) return false;
  return true;
}

// ---- 3xTF32 at width 256 ----------------------------------------------------
//
// attend's Tf32x3Tiles cannot reach D = 256: Q hi and lo of 64 rows take 128
// KB, and one 64-key stage of K hi and lo another 128 KB. So this schedule
// keeps Q hi and lo resident in one warpgroup's block (64 query rows), P hi
// and lo in shared memory (32 KB: PV an SS product, P's keys in their
// natural order, and no P registers beside O's 128), and streams each key
// tile through one 64 KB buffer in four loads, each waited for and used
// before the next is issued:
//   1-2. K hi and lo, columns 0-127, then 128-255: QK^T in two halves over D
//        into one score tile;
//   then the online softmax (Op::softmax), O rescaled, P split into hi and lo
//   and stored;
//   3-4. V^T hi and lo, rows (output columns) 0-127, then 128-255: PV in
//        four parts of 64 columns, each into a fresh accumulator added to O
//        (as Tf32x3Tiles does a tile at a time).
// Nothing overlaps: the tensor cores wait for each load. The operands (an
// Op): load_q (Q's hi tile by TMA), load_k_half, load_vt_half, softmax and
// store_rows.
struct WideTf32 {
  static constexpr int kD = 256;
  using QTile = RowTile<256, 4>;  // 64 rows: 8 panels of 32 columns, 64 KB
  using KHalf = RowTile<128, 4>;  // 64 keys x 128 columns: 4 panels, 32 KB
  using PTile = RowTile<64, 4>;   // P: 64 rows x 64 keys, 2 panels, 16 KB
  static constexpr int kVtPanel = 128 * 128;  // V^T: 128 rows of 32 keys
  static constexpr int kBuf = 2 * KHalf::kBytes;  // 64 KB: hi, then lo
  static_assert(kBuf == 2 * 2 * kVtPanel, "a K half and a V^T half fill the buffer");
  static constexpr int kBlockThreads = 128, kBlockRows = kTile;
  static constexpr int kPAt = 2 * QTile::kBytes;
  static constexpr int kBufAt = kPAt + 2 * PTile::kBytes;
  static constexpr int kBarAt = kBufAt + kBuf;
  static constexpr int kSmem = 1024 + kBarAt + 8;
  static_assert(kSmem <= 232448, "more shared memory than an H100 block may use");

  // descriptor offset of the 8-key k-step kk in a V^T half (two panels of 32
  // keys)
  static __device__ __forceinline__ constexpr uint64_t vt_step(int kk) {
    return (uint64_t)(((kk >> 2) * kVtPanel + (kk & 3) * 32) >> 4);
  }
};

template <class Op>
__device__ __forceinline__ void attend_wide(unsigned char* smem_raw, const Op& op, int seq) {
  using W = WideTf32;
  using QTile = W::QTile;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-byte aligned
  const uint32_t sbase = raw + (uint32_t)(base - smem_raw);
  const uint32_t q_hi = sbase, q_lo = sbase + QTile::kBytes;
  const uint32_t p_hi = sbase + W::kPAt, p_lo = p_hi + W::PTile::kBytes;
  const uint32_t buf = sbase + W::kBufAt;
  const uint32_t bar = sbase + W::kBarAt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int row_base = blockIdx.x * kTile;
  const int ntiles = (seq + kTile - 1) / kTile;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect_tx(bar, QTile::kBytes + W::kBuf);
    op.load_q(q_hi, bar, row_base);
    op.load_k_half(buf, bar, 0, 0);
  }
  __syncthreads();
  uint32_t parity = 0;
  // the buffer's next load, once every thread is done with it (the wgmma
  // that read it waited for)
  auto refill = [&](auto&& load) {
    named_barrier(1, 128);
    if (tid == 0) {
      mbar_arrive_expect_tx(bar, W::kBuf);
      load();
    }
  };
  mbar_wait_or_trap(bar, parity);
  parity ^= 1;
  // Q's hi tile split in place into hi and lo (element by element: the two
  // tiles share a layout)
#pragma unroll 4
  for (int it = 0; it < QTile::kBytes / 16 / 128; ++it) {
    const uint32_t at = q_hi + 16 * (tid + 128 * it);
    uint4 x;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                 : "r"(at)
                 : "memory");
    uint4 hi, lo;
    split_tf32(__uint_as_float(x.x), hi.x, lo.x);
    split_tf32(__uint_as_float(x.y), hi.y, lo.y);
    split_tf32(__uint_as_float(x.z), hi.z, lo.z);
    split_tf32(__uint_as_float(x.w), hi.w, lo.w);
    st_shared16(at, hi);
    st_shared16(at + QTile::kBytes, lo);
  }
  fence_async_shared();
  named_barrier(1, 128);

  float sc[32], o[128], pv[32];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  const uint64_t qh = QTile::R::desc(q_hi), ql = QTile::R::desc(q_lo);
  for (int t = 0; t < ntiles; ++t) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // QK^T over columns 128j .. 128j + 127
      if (t > 0 || j > 0) {
        refill([&] { op.load_k_half(buf, bar, t, j); });
        mbar_wait_or_trap(bar, parity);
        parity ^= 1;
      }
      const uint64_t kh = W::KHalf::R::desc(buf), kl = W::KHalf::R::desc(buf + W::KHalf::kBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const uint64_t qs = QTile::k_step(16 * j + kk), ks = W::KHalf::k_step(kk);
        wgmma_tf32_ss(sc, qh + qs, kl + ks, j > 0 || kk > 0);
        wgmma_tf32_ss(sc, ql + qs, kh + ks, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        wgmma_tf32_ss(sc, qh + QTile::k_step(16 * j + kk), kh + W::KHalf::k_step(kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
    }
    op.softmax(sc, seq - kTile * t, tq, m, l, alpha);
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P hi and lo (K-major rows of 64 keys) for PV's A operand; the last PV
    // read the previous tile's P before its wait
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint2 hi, lo;
        split_tf32(sc[4 * i + 2 * r], hi.x, lo.x);
        split_tf32(sc[4 * i + 2 * r + 1], hi.y, lo.y);
        const uint32_t at = W::PTile::at(row, 8 * i + 2 * tq);
        st_shared8(p_hi + at, hi);
        st_shared8(p_lo + at, lo);
      }
    }
    fence_async_shared();
    const uint64_t ph = W::PTile::R::desc(p_hi), pl = W::PTile::R::desc(p_lo);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // PV for output columns 128j .. 128j + 127
      refill([&] { op.load_vt_half(buf, bar, t, j); });  // its barrier also orders P's stores
      mbar_wait_or_trap(bar, parity);
      parity ^= 1;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const uint32_t rows = buf + part * 64 * 128;  // V^T rows 64 * part on
        const uint64_t vh = Rows<128>::desc(rows), vl = Rows<128>::desc(rows + 2 * W::kVtPanel);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_tf32_ss(pv, ph + W::PTile::k_step(kk), vl + W::vt_step(kk), kk);
          wgmma_tf32_ss(pv, pl + W::PTile::k_step(kk), vh + W::vt_step(kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_tf32_ss(pv, ph + W::PTile::k_step(kk), vh + W::vt_step(kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(pv);
        const int at = 32 * (2 * j + part);  // O's accumulators of those 64 columns
#pragma unroll
        for (int i = 0; i < 32; ++i) o[at + i] += pv[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // o / l in float32 into Q's hi tile (every wgmma that read it is done),
  // out by the threads
  named_barrier(1, 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 xy = make_float2(o[4 * i + 2 * r] / l[r], o[4 * i + 2 * r + 1] / l[r]);
      *reinterpret_cast<float2*>(base + QTile::at(row, 8 * i + 2 * tq)) = xy;
    }
  }
  named_barrier(1, 128);
  op.store_rows(base, row_base, tid);
}

}  // namespace key_tiles
}  // namespace
