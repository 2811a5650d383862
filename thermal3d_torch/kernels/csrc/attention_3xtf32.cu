// K2-K6 in float32 on Hopper tensor cores, 3xTF32, head_dim 64, CUDA C++
// for sm_90a (wgmma, TMA, mbarriers).
//
// Replaces, for float32 operands with head_dim 64 (every call of a model at
// its default compute_dtype), the Pallas TPU kernels of
// thermal3d/kernels/flash_attention.py: _fused_rope_kernel (K2 through
// _fused_rope_attention_fwd on the packed [B,S,3C] projection, K3 through
// _fused_rope_xattn_fwd on separate [B,S,C] ones) and the softmax attention
// on q/k that are already roped, tiled three ways for the TPU: K4
// _attention_kernel, K5 _grouped_kernel, K6 _multihead_kernel. Other head
// dims run the CUDA-core kernels of rope_attention.cu and attention.cu
// (flash_attention.py::attention_route).
//
// Arithmetic. The products run on tensor cores as 3xTF32 (attention_tc.cuh:
// x = hi + lo, each product hi*hi + hi*lo + lo*hi in float32, about 2^-21
// relative a product); everything else is the CUDA-core kernels' float32
// arithmetic: RoPE from the cos/sin tables [S,64] with each product and the
// sum rounded separately (no FMA), scores times scale, the online softmax
// of attention_common.cuh's key-tile loop (expf, running max and float32
// sum, O rescaled when the max moves, every tile masked), p kept in float32
// (split into hi and lo as PV's A operand), and the division after PV.
//
// What bounds it on an H100: the operations, 4*Sq*Sk*64 flops a head at the
// 3xTF32 rate of 495/3 = 165 TFLOP/s (at S = 196 and S = 1024 above the
// bytes' time at 3.35 TB/s); on CUDA cores the float32 peak is 67 TFLOP/s.
// Design:
//   * A prologue (attention_3xtf32_split_kernel) reads each head's K and V
//     once, ropes K for K2/K3, and writes K's tf32 hi and lo ([B*H, S, 64]
//     each) and V's, transposed ([B*H, 64, S8], S8 = S rounded up to 8, the
//     keys of each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 that P's
//     A fragment takes, the padding zero), to a scratch the caller allocates
//     (t3d_attention_3xtf32_scratch_bytes). wgmma takes tf32 operands
//     K-major only, and V enters PV as the B operand [key][d], which is
//     MN-major: V^T is. Splitting once a head,
//     rather than in every block that reads a tile (8 blocks a head at S =
//     1024), keeps the loop's CUDA-core work to the softmax and P's split.
//   * The key-tile loop of key_tile_attention.cuh in its Tf32x3Tiles
//     policy: one block per 128 query rows of a (batch item, head), two
//     warpgroups of 64 rows, one block an SM (Q hi/lo 64 KB; by TMA, two
//     stages of K hi and lo and two of V^T hi and lo, 32 KB each, a K stage
//     free once its QK^T is done, a V stage once its PV is); tile t's QK^T (24
//     wgmma m64n64k8) is issued with tile t-1's PV (24 more, P from
//     registers), and tile t's softmax runs while that PV does. Each
//     tile's PV goes into a fresh accumulator that the CUDA cores add to O
//     (the tensor cores round an accumulator toward zero at every step, and
//     O over all 16 tiles at S=1024 drifted ~6e-6 from the plain version;
//     a tile at a time, ~9e-7 on an H100).
//   * Q: K2/K3's warpgroups rope and split their 64 rows from device memory
//     (stage_q); K4-K6's arrive by TMA (4-D maps of q's strides, so the
//     [B,S,H,D] views attention_bshd hands over need no copy) with the first
//     stage and are split in place. The prologue reads K4-K6's K and V by
//     their strides the same way.
//   * O / l in float32 out of the warpgroup's Q hi tile by two TMA stores
//     (64-float rows are two 128-byte boxes), rows past the query count
//     dropped.
#include "key_tile_attention.cuh"

namespace {

using key_tiles::kF32Half;
using key_tiles::kF32Tile;
using key_tiles::Tf32x3Tiles;

// (batch, head, row) strides of an operand in elements; head_dim contiguous
struct HeadStrides {
  long long batch, head, row;
};

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

// The chunk pairs of a row: elements d .. d+3 of an even quarter of the head
// and d+16 .. d+19 of the odd quarter that follows, d in {0, 4, 8, 12, 32,
// 36, 40, 44} for pair 0-7.
__device__ __forceinline__ int pair_col(int pair) { return (pair & 3) * 4 + (pair >> 2) * 32; }

// RoPE in place of a row's chunk pair (a: d .. d+3, b: d+16 .. d+19) from
// the row's cos/sin entries: t*cos + rot(t)*sin with rot(t) = -t[d+16] on
// the even quarter and t[d-16] on the odd, each product and the sum rounded
// separately (rope_at in attention_common.cuh).
__device__ __forceinline__ void rope_pair4(float (&a)[4], float (&b)[4],
                                           const float* __restrict__ cos_row,
                                           const float* __restrict__ sin_row, int d) {
  float ca[4], sa[4], cb[4], sb[4];
  load4(ca, cos_row + d);
  load4(sa, sin_row + d);
  load4(cb, cos_row + d + 16);
  load4(sb, sin_row + d + 16);
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
// cos_t is not null) -> kh, kl [B*H, S, 64]; V rows -> through shared memory
// -> vth, vtl [B*H, 64, seq8], keys past S written as zeros.
__global__ void __launch_bounds__(256)
attention_3xtf32_split_kernel(const float* __restrict__ k, HeadStrides ks,
                              const float* __restrict__ v, HeadStrides vs,
                              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                              uint32_t* __restrict__ kh, uint32_t* __restrict__ kl,
                              uint32_t* __restrict__ vth, uint32_t* __restrict__ vtl, int seq,
                              int seq8, int heads) {
  __shared__ float vt[kSplitRows][kD + 1];
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * kSplitRows;
  const long long bh = (long long)b * heads + h;
  const float* kb = k + b * ks.batch + h * ks.head;
  const float* vb = v + b * vs.batch + h * vs.head;
  for (int task = threadIdx.x; task < kSplitRows * 8; task += blockDim.x) {
    const int row = row0 + (task >> 3);
    if (row >= seq) break;  // tasks run row by row
    const int d = pair_col(task & 7);
    float a[4], c[4];
    load4(a, kb + row * ks.row + d);
    load4(c, kb + row * ks.row + d + 16);
    if (cos_t != nullptr) rope_pair4(a, c, cos_t + (size_t)row * kD, sin_t + (size_t)row * kD, d);
    uint4 ah, al, ch, cl;
    split4(a, ah, al);
    split4(c, ch, cl);
    const long long at = (bh * seq + row) * kD + d;
    *reinterpret_cast<uint4*>(kh + at) = ah;
    *reinterpret_cast<uint4*>(kh + at + 16) = ch;
    *reinterpret_cast<uint4*>(kl + at) = al;
    *reinterpret_cast<uint4*>(kl + at + 16) = cl;
  }
  for (int task = threadIdx.x; task < kSplitRows * 16; task += blockDim.x) {
    const int r = task >> 4, d = (task & 15) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (row0 + r < seq) load4(x, vb + (row0 + r) * vs.row + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) vt[r][d + i] = x[i];
  }
  __syncthreads();
  for (int task = threadIdx.x; task < kD * 16; task += blockDim.x) {
    const int d = task >> 4, kq = (task & 15) * 4;
    if (row0 + kq >= seq8) continue;
    // positions kq .. kq+3 of an 8-key group hold its keys 0, 2, 4, 6 (kq % 8
    // == 0) or 1, 3, 5, 7: the order of P's columns in PV's A fragment
    const int k0 = (kq & ~7) + ((kq >> 2) & 1);
    const float x[4] = {vt[k0][d], vt[k0 + 2][d], vt[k0 + 4][d], vt[k0 + 6][d]};
    uint4 hi, lo;
    split4(x, hi, lo);
    const long long at = (bh * kD + d) * seq8 + row0 + kq;
    *reinterpret_cast<uint4*>(vth + at) = hi;
    *reinterpret_cast<uint4*>(vtl + at) = lo;
  }
}

// ---- the key-tile kernels ---------------------------------------------------

// What K2/K3 and K4-K6 share: the prologue's K hi/lo and V^T hi/lo tiles of
// head bh by TMA (3-D maps, boxes of 32 floats x 64 rows; keys past S read
// as zeros; V^T is S8 keys wide, zero past S), and the expf online softmax.
struct SplitKvOperands {
  const CUtensorMap* tm_kh;
  const CUtensorMap* tm_kl;
  const CUtensorMap* tm_vh;
  const CUtensorMap* tm_vl;
  int bh;
  float scale;

  __device__ void load_k(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_3d(stage + j * kF32Half, tm_kh, bar, 32 * j, kTile * t, bh);
      tma_load_3d(stage + kF32Tile + j * kF32Half, tm_kl, bar, 32 * j, kTile * t, bh);
    }
  }
  __device__ void load_v(uint32_t stage, uint32_t bar, int t) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tma_load_3d(stage + j * kF32Half, tm_vh, bar, kTile * t + 32 * j, 0, bh);
      tma_load_3d(stage + kF32Tile + j * kF32Half, tm_vl, bar, kTile * t + 32 * j, 0, bh);
    }
  }
  __device__ void softmax(float (&sc)[32], int valid, int tq, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) const {
    key_tiles::online_softmax_tile(sc, valid, scale, tq, m, l, alpha);
  }
};

// Byte offset of element d of row r in a two-half float32 operand tile
// (d a multiple of 4: the start of a 16-byte chunk).
__device__ __forceinline__ uint32_t f32_at(int r, int d) {
  return (uint32_t)((d >> 5) * kF32Half) + swizzle(r, (d & 31) >> 2);
}

// K2/K3: Q roped and split by the warpgroup from the [B, S, *] rows (q: the
// head's column 0 of batch item b), the output [B, S, C] (tm_o).
struct RopeF32Operands : SplitKvOperands {
  const CUtensorMap* tm_o;
  const float* q;
  long long row_stride;
  const float* cos_t;
  const float* sin_t;
  int seq, h, b;

  static constexpr uint32_t kQBytes = 0;  // Q does not come by TMA
  __device__ void load_q(uint32_t, uint32_t, int) const {}
  // rows [row_base, row_base + 64) roped, split into the hi and lo tiles at
  // my_q; rows >= seq zero. 64 rows x 8 chunk pairs, 4 a thread.
  __device__ void stage_q(uint32_t my_q, int row_base, int ctid, int w, uint32_t) const {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int task = ctid + 128 * it;
      const int r = task >> 3;
      const int d = pair_col(task & 7);
      const int row = row_base + r;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < seq) {
        load4(a, q + row * row_stride + d);
        load4(c, q + row * row_stride + d + 16);
        rope_pair4(a, c, cos_t + (size_t)row * kD, sin_t + (size_t)row * kD, d);
      }
      uint4 ah, al, ch, cl;
      split4(a, ah, al);
      split4(c, ch, cl);
      st_shared16(my_q + f32_at(r, d), ah);
      st_shared16(my_q + f32_at(r, d + 16), ch);
      st_shared16(my_q + kF32Tile + f32_at(r, d), al);
      st_shared16(my_q + kF32Tile + f32_at(r, d + 16), cl);
    }
    fence_async_shared();
    named_barrier(1 + w, 128);
  }
  __device__ void store_o(uint32_t src, int row_base) const {
    tma_store_3d(tm_o, src, h * kD, row_base, b);
    tma_store_3d(tm_o, src + kF32Half, h * kD + 32, row_base, b);
  }
};

// K4-K6: Q by TMA (4-D map of q's strides) on the first stage, split in
// place once it landed; the output by the 4-D map of out's strides.
struct SoftmaxF32Operands : SplitKvOperands {
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_o;
  int h, b;

  static constexpr uint32_t kQBytes = key_tiles::kWgs * kF32Tile;  // both warpgroups' hi tiles
  __device__ void load_q(uint32_t q_area, uint32_t bar, int block_row0) const {
#pragma unroll
    for (int w = 0; w < key_tiles::kWgs; ++w)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_4d(q_area + w * Tf32x3Tiles::kWgQBytes + j * kF32Half, tm_q, bar, 32 * j,
                    block_row0 + w * kTile, h, b);
  }
  // the warpgroup's hi tile, once stage 0 landed: hi in place, lo beside it
  // (the two tiles share a layout, so the split is element by element)
  __device__ void stage_q(uint32_t my_q, int, int ctid, int w, uint32_t full0) const {
    mbar_wait_or_trap(full0, 0);
#pragma unroll
    for (int it = 0; it < kF32Tile / 16 / 128; ++it) {
      const uint32_t at = my_q + 16 * (ctid + 128 * it);
      const uint4 x = ld_shared16(at);
      const float f[4] = {__uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
                          __uint_as_float(x.w)};
      uint4 hi, lo;
      split4(f, hi, lo);
      st_shared16(at, hi);
      st_shared16(at + kF32Tile, lo);
    }
    fence_async_shared();
    named_barrier(1 + w, 128);
  }
  __device__ void store_o(uint32_t src, int row_base) const {
    tma_store_4d(tm_o, src, 0, row_base, h, b);
    tma_store_4d(tm_o, src + kF32Half, 32, row_base, h, b);
  }
};

__global__ void __launch_bounds__(key_tiles::kBlockThreads, Tf32x3Tiles::kBlocksPerSm)
rope_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_kh,
                             const __grid_constant__ CUtensorMap tm_kl,
                             const __grid_constant__ CUtensorMap tm_vh,
                             const __grid_constant__ CUtensorMap tm_vl,
                             const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ q,
                             long long row_stride, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t, int seq, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const RopeF32Operands op{{&tm_kh, &tm_kl, &tm_vh, &tm_vl, b * heads + h, scale},
                           &tm_o,
                           q + (long long)b * seq * row_stride + (long long)h * kD,
                           row_stride,
                           cos_t,
                           sin_t,
                           seq,
                           h,
                           b};
  key_tiles::attend<Tf32x3Tiles>(smem_raw, op, seq);
}

__global__ void __launch_bounds__(key_tiles::kBlockThreads, Tf32x3Tiles::kBlocksPerSm)
softmax_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap tm_kh,
                                const __grid_constant__ CUtensorMap tm_kl,
                                const __grid_constant__ CUtensorMap tm_vh,
                                const __grid_constant__ CUtensorMap tm_vl,
                                const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_o, int sk, int heads,
                                float scale) {
  extern __shared__ unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z;
  const SoftmaxF32Operands op{{&tm_kh, &tm_kl, &tm_vh, &tm_vl, b * heads + h, scale},
                              &tm_q,
                              &tm_o,
                              h,
                              b};
  key_tiles::attend<Tf32x3Tiles>(smem_raw, op, sk);
}

// ---- host -------------------------------------------------------------------

constexpr int kMaxDevices = 64;
// the byte stride a tensor map takes for an axis of size 1, which the
// kernel never steps along (the wrapper passes 0 there): one row
constexpr long long kSizeOneStrideBytes = kD * 4;

int seq8_of(int seq) { return (seq + 7) & ~7; }

// The four parts of the scratch, in order: K hi, K lo, V^T hi, V^T lo.
struct Scratch {
  uint32_t *kh, *kl, *vth, *vtl;
};

Scratch scratch_parts(void* scratch, int batch, int heads, int seq) {
  const long long bh = (long long)batch * heads;
  uint32_t* base = static_cast<uint32_t*>(scratch);
  const long long k_elems = bh * seq * kD, vt_elems = bh * kD * seq8_of(seq);
  return Scratch{base, base + k_elems, base + 2 * k_elems, base + 2 * k_elems + vt_elems};
}

// Set a kernel's dynamic shared memory once a device.
template <class Kernel>
cudaError_t prepare(Kernel kernel, bool (&ready)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tf32x3Tiles::kSmem);
  if (err == cudaSuccess) ready[device] = true;
  return err;
}

// The prologue on (k, ks) and (v, vs), then the maps of its four outputs.
cudaError_t split_kv(const void* k, HeadStrides ks, const void* v, HeadStrides vs,
                     const float* cos_t, const float* sin_t, const Scratch& s, int batch,
                     int heads, int seq, cudaStream_t st, CUtensorMap (&maps)[4]) {
  const int seq8 = seq8_of(seq);
  const dim3 grid((seq + kSplitRows - 1) / kSplitRows, heads, batch);
  attention_3xtf32_split_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(k), ks, static_cast<const float*>(v), vs, cos_t, sin_t, s.kh,
      s.kl, s.vth, s.vtl, seq, seq8, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint64_t bh = (uint64_t)batch * heads;
  err = encode_f32_rows(&maps[0], s.kh, kD, seq, bh, kD, (uint64_t)seq * kD);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[1], s.kl, kD, seq, bh, kD, (uint64_t)seq * kD);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[2], s.vth, seq8, kD, bh, seq8, (uint64_t)kD * seq8);
  if (err == cudaSuccess)
    err = encode_f32_rows(&maps[3], s.vtl, seq8, kD, bh, seq8, (uint64_t)kD * seq8);
  return err;
}

}  // namespace

extern "C" {

// Bytes of the scratch a call takes: K hi and lo, [batch*heads, seq, 64]
// each, then V^T hi and lo, [batch*heads, 64, seq rounded up to 8] each,
// all 4-byte words. For K4-K6, seq is Sk.
unsigned long long t3d_attention_3xtf32_scratch_bytes(int batch, int heads, int seq) {
  const unsigned long long bh = (unsigned long long)batch * heads;
  return 4ull * (2 * bh * seq * kD + 2 * bh * kD * seq8_of(seq));
}

// K2/K3: q/k/v float32 base pointers of [batch, seq, *] rows `row_stride`
// elements apart (head h at column h*64), 16-byte aligned, row_stride % 4 ==
// 0; cos/sin float32 [seq, 64]; scratch of t3d_attention_3xtf32_scratch_
// bytes, 16-byte aligned; out float32 [batch, seq, heads*64] contiguous.
// head_dim must be 64. Launches, on `stream` and the current device, the
// prologue and the key-tile kernel. Returns a cudaError_t code.
int t3d_rope_attention_3xtf32(const void* q, const void* k, const void* v, long long row_stride,
                              const float* cos_t, const float* sin_t, void* scratch, void* out,
                              int batch, int seq, int heads, int head_dim, float scale,
                              void* stream) {
  if (head_dim != kD || seq <= 0 || row_stride % 4 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static bool ready[kMaxDevices];
  err = prepare(rope_attention_3xtf32_kernel, ready, device);
  if (err != cudaSuccess) return (int)err;
  const HeadStrides rows{(long long)seq * row_stride, kD, row_stride};
  CUtensorMap maps[4], tm_o;
  err = split_kv(k, rows, v, rows, cos_t, sin_t, scratch_parts(scratch, batch, heads, seq),
                 batch, heads, seq, st, maps);
  if (err != cudaSuccess) return (int)err;
  const uint64_t c = (uint64_t)heads * kD;
  err = encode_f32_rows(&tm_o, out, c, seq, batch, c, seq * c);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + key_tiles::kBlockRows - 1) / key_tiles::kBlockRows, heads, batch);
  rope_attention_3xtf32_kernel<<<grid, key_tiles::kBlockThreads, Tf32x3Tiles::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], tm_o, static_cast<const float*>(q), row_stride, cos_t,
      sin_t, seq, heads, scale);
  return (int)cudaGetLastError();
}

// K4-K6: q [batch, heads, sq, 64], k/v [batch, heads, sk, 64], out like q,
// float32, each by its base pointer (16-byte aligned) and, in `strides` (12
// values, host memory), the (batch, head, row) strides in elements of q, k,
// v, out, multiples of 4 (the wrapper sends 0 for an axis of size 1);
// head_dim contiguous. scratch as for K2/K3 with seq = sk. sq, sk >= 1.
// Launches, on `stream` and the current device, the prologue and the
// key-tile kernel. Returns a cudaError_t code.
int t3d_softmax_attention_3xtf32(const void* q, const void* k, const void* v, void* out,
                                 const long long* strides, void* scratch, int batch, int heads,
                                 int sq, int sk, int head_dim, float scale, void* stream) {
  if (head_dim != kD || sq <= 0 || sk <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static bool ready[kMaxDevices];
  err = prepare(softmax_attention_3xtf32_kernel, ready, device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4], tm_q, tm_o;
  err = split_kv(k, HeadStrides{strides[3], strides[4], strides[5]}, v,
                 HeadStrides{strides[6], strides[7], strides[8]}, nullptr, nullptr,
                 scratch_parts(scratch, batch, heads, sk), batch, heads, sk, st, maps);
  if (err != cudaSuccess) return (int)err;
  // q's and out's maps: 4 bytes an element, one row for an axis of size 1
  long long bytes[6];
  const int extents[3] = {batch, heads, sq};
  for (int i = 0; i < 6; ++i) {
    const long long stride = strides[i < 3 ? i : 9 + (i - 3)];
    bytes[i] = extents[i % 3] == 1 ? kSizeOneStrideBytes : 4 * stride;
  }
  err = encode_f32_heads(&tm_q, q, sq, heads, batch, bytes[0], bytes[1], bytes[2]);
  if (err == cudaSuccess)
    err = encode_f32_heads(&tm_o, out, sq, heads, batch, bytes[3], bytes[4], bytes[5]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + key_tiles::kBlockRows - 1) / key_tiles::kBlockRows, heads, batch);
  softmax_attention_3xtf32_kernel<<<grid, key_tiles::kBlockThreads, Tf32x3Tiles::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], tm_q, tm_o, sk, heads, scale);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
