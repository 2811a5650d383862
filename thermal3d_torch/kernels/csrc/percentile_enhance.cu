// K1: per-image p2/p98 percentile contrast enhancement, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel thermal3d/kernels/image_ops.py::_enhance_kernel
// (pallas_call in percentile_enhance_pallas). Same result, bit for bit:
//   q = clamp(floor(x * 65535), 0, 65535)
//   p = smallest grid value v with count(q <= v) >= target, target = frac/100
//       * N rounded to float32, the count compared as a float32 (the Pallas
//       kernel finds it by a 16-step binary search on [0, 65535])
//   out = clip((x - p_lo) * (1 / max(p_hi - p_lo, 1e-12)), 0, 1)
// so kernel and plain versions (kernels/image_ops.py) agree bit for bit.
// Build without fast-math: floorf, the division and the compares must be
// IEEE.
//
// What bounds it on an H100: device memory. The function reads the image
// once and writes it once (8 bytes a pixel). Design: a two-level radix
// select spread over many blocks an image, so that a serving batch of 32
// fills the card and an image of any size up to 2^24 pixels works (the
// counts are exact int32 and exact as float32 up to there). Each image is
// cut into tiles of kTilePixels; grid (tiles, images) for each of three
// launches on one stream:
//   1. hist_hi: each block quantises its tile and histograms q >> 8 into 256
//      shared-memory bins, then adds them into the image's row of hist_hi
//      [B,256] (int32 atomics; the wrapper zeroes the scratch).
//   2. hist_lo: each block scans hist_hi: for each percentile the high bin
//      j where the cumulative count first reaches the target (bins whose
//      inclusive count is below it, counted by __syncthreads_count) and the
//      count below j. It histograms the low bytes of its pixels that fall in
//      those two bins into hist_lo [B,2,256]; block 0 of the image writes
//      j and the count below into sel [B,4].
//   3. rescale: each block finds, per percentile, the low byte the same way
//      from hist_lo and sel, so v = 256 j + low, p = v / 65535, and rescales
//      its tile.
// count(q <= v) is monotone in v, so this v is the binary search's result
// exactly (also where no v reaches the target: both give 65535). The x
// re-reads of passes 2 and 3 are L2 hits at the port's batch sizes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one histogram bin a thread in the scans
constexpr int kPixelsPerThread = 16;
constexpr int kTilePixels = kThreads * kPixelsPerThread;
constexpr float kGrid = 65535.0f;

__device__ __forceinline__ int quantise(float x) {
  return (int)fminf(fmaxf(floorf(x * kGrid), 0.0f), kGrid);
}

// The bin (0-255) where base + the inclusive cumulative count of hist first
// reaches target, and base + the count below it; 255 and its count below if
// no bin does. Every thread of the block calls it, with its own bin's count
// `mine` (thread t holds bin t); `scan` is 256 ints of shared memory.
__device__ __forceinline__ int2 select_bin(int mine, int base, float target, int* scan) {
  const int t = threadIdx.x;
  scan[t] = mine;
  __syncthreads();
  // Hillis-Steele inclusive scan over the 256 bins
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const int below_target = __syncthreads_count((float)(base + scan[t]) < target);
  const int bin = min(below_target, kThreads - 1);
  const int below = base + (bin > 0 ? scan[bin - 1] : 0);
  __syncthreads();  // scan is rewritten by the next call
  return make_int2(bin, below);
}

__global__ void __launch_bounds__(kThreads)
percentile_enhance_hist_hi_kernel(const float* __restrict__ x, int n, int* __restrict__ hist_hi) {
  __shared__ int bins[kThreads];
  bins[threadIdx.x] = 0;
  __syncthreads();
  const float* xi = x + (size_t)blockIdx.y * n;
  const int start = blockIdx.x * kTilePixels;
  const int end = min(n, start + kTilePixels);
  for (int i = start + threadIdx.x; i < end; i += kThreads)
    atomicAdd(&bins[quantise(xi[i]) >> 8], 1);
  __syncthreads();
  const int c = bins[threadIdx.x];
  if (c) atomicAdd(&hist_hi[blockIdx.y * kThreads + threadIdx.x], c);
}

__global__ void __launch_bounds__(kThreads)
percentile_enhance_hist_lo_kernel(const float* __restrict__ x, int n, const int* __restrict__ hist_hi,
                                  int* __restrict__ hist_lo, int* __restrict__ sel,
                                  float target_lo, float target_hi) {
  __shared__ int scan[kThreads];
  __shared__ int bins[2][kThreads];
  const int b = blockIdx.y;
  const int mine = hist_hi[b * kThreads + threadIdx.x];
  const int2 lo = select_bin(mine, 0, target_lo, scan);
  const int2 hi = select_bin(mine, 0, target_hi, scan);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sel[4 * b + 0] = lo.x;
    sel[4 * b + 1] = lo.y;
    sel[4 * b + 2] = hi.x;
    sel[4 * b + 3] = hi.y;
  }
  bins[0][threadIdx.x] = 0;
  bins[1][threadIdx.x] = 0;
  __syncthreads();
  const float* xi = x + (size_t)b * n;
  const int start = blockIdx.x * kTilePixels;
  const int end = min(n, start + kTilePixels);
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const int q = quantise(xi[i]);
    if (q >> 8 == lo.x) atomicAdd(&bins[0][q & 255], 1);
    if (q >> 8 == hi.x) atomicAdd(&bins[1][q & 255], 1);
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k) {
    const int c = bins[k][threadIdx.x];
    if (c) atomicAdd(&hist_lo[(2 * b + k) * kThreads + threadIdx.x], c);
  }
}

__global__ void __launch_bounds__(kThreads)
percentile_enhance_rescale_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                  const int* __restrict__ hist_lo, const int* __restrict__ sel,
                                  float target_lo, float target_hi) {
  __shared__ int scan[kThreads];
  const int b = blockIdx.y;
  const int2 lo = select_bin(hist_lo[(2 * b) * kThreads + threadIdx.x], sel[4 * b + 1],
                             target_lo, scan);
  const int2 hi = select_bin(hist_lo[(2 * b + 1) * kThreads + threadIdx.x], sel[4 * b + 3],
                             target_hi, scan);
  const float p_lo = (float)(sel[4 * b + 0] * 256 + lo.x) / kGrid;
  const float p_hi = (float)(sel[4 * b + 2] * 256 + hi.x) / kGrid;
  const float scale = 1.0f / fmaxf(p_hi - p_lo, 1e-12f);
  const float* xi = x + (size_t)b * n;
  float* oi = out + (size_t)b * n;
  const int start = blockIdx.x * kTilePixels;
  const int end = min(n, start + kTilePixels);
  for (int i = start + threadIdx.x; i < end; i += kThreads)
    oi[i] = fminf(fmaxf((xi[i] - p_lo) * scale, 0.0f), 1.0f);
}

}  // namespace

extern "C" {

// x, out: [batch, n] float32 on the device, n <= 2^24; scratch: int32 of
// (256 + 512 + 4) * batch, zero-filled (hist_hi, hist_lo, sel). Launches
// the three passes on `stream`. Returns a cudaError_t code.
int t3d_percentile_enhance(const float* x, float* out, int* scratch, int batch, int n,
                           float target_lo, float target_hi, void* stream) {
  if (n <= 0 || n > (1 << 24) || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* hist_hi = scratch;
  int* hist_lo = hist_hi + 256 * batch;
  int* sel = hist_lo + 512 * batch;
  const dim3 grid((n + kTilePixels - 1) / kTilePixels, batch);
  percentile_enhance_hist_hi_kernel<<<grid, kThreads, 0, st>>>(x, n, hist_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  percentile_enhance_hist_lo_kernel<<<grid, kThreads, 0, st>>>(x, n, hist_hi, hist_lo, sel,
                                                               target_lo, target_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  percentile_enhance_rescale_kernel<<<grid, kThreads, 0, st>>>(x, out, n, hist_lo, sel,
                                                               target_lo, target_hi);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
