// K1: per-image p2/p98 percentile contrast enhancement, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel thermal3d/kernels/image_ops.py::_enhance_kernel
// (pallas_call in percentile_enhance_pallas). Same arithmetic, step for step:
//   q = floor(x * 65535)                          (x already in [0, 1])
//   p = smallest grid value v with count(q <= v) >= target, by a 16-step
//       binary search on [0, 65535]; target = frac/100 * N rounded to float32
//   out = clip((x - p_lo) * (1 / max(p_hi - p_lo, 1e-12)), 0, 1)
// so kernel and plain version (kernels/image_ops.py) agree bit for bit. Build
// without fast-math: floorf, the divisions and the compares must be IEEE.
//
// What bounds it on an H100: device memory. The function reads the image
// once and writes it once (8 bytes a pixel); the search's 16 counting passes
// are ~2 integer ops a pixel each. Design: one block per image. The image is
// quantised once into dynamic shared memory as uint16 (224*224*2 = 100,352 B,
// above the 48 KB default, hence cudaFuncSetAttribute), and both percentiles
// are searched together, so the 16 passes run over shared memory, not device
// memory, with one block-wide reduction of two counters each (warp shuffles,
// then 32 per-warp partials). The rescale re-reads the image (an L2 hit).
// Known weakness: one block per image, so a batch of 32 fills 32 of 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSearchSteps = 16;  // ceil(log2(65536))
constexpr float kGrid = 65535.0f;

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of two counters; every thread receives both totals.
__device__ __forceinline__ void block_sum2(int& a, int& b, int2* partials) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partials[warp] = make_int2(a, b);
  __syncthreads();
  int ta = 0, tb = 0;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) {
    ta += partials[w].x;
    tb += partials[w].y;
  }
  __syncthreads();  // partials are rewritten by the next call
  a = ta;
  b = tb;
}

__global__ void __launch_bounds__(kThreads)
percentile_enhance_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int n, float target_lo, float target_hi) {
  extern __shared__ uint16_t q[];
  __shared__ int2 partials[kThreads / 32];
  const float* xi = x + (size_t)blockIdx.x * n;
  float* oi = out + (size_t)blockIdx.x * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // Clamping to the grid changes no count: the search's mid stays in
    // [0, 65534], so a value below 0 counts as 0 would and one above 65535
    // counts as 65535 would.
    const float g = fminf(fmaxf(floorf(xi[i] * kGrid), 0.0f), kGrid);
    q[i] = (uint16_t)g;
  }
  __syncthreads();

  float lo_a = 0.0f, hi_a = kGrid;  // p_lo search
  float lo_b = 0.0f, hi_b = kGrid;  // p_hi search
  for (int step = 0; step < kSearchSteps; ++step) {
    const float mid_a = floorf((lo_a + hi_a) * 0.5f);
    const float mid_b = floorf((lo_b + hi_b) * 0.5f);
    const int ma = (int)mid_a, mb = (int)mid_b;
    int ca = 0, cb = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int v = q[i];
      ca += v <= ma;
      cb += v <= mb;
    }
    block_sum2(ca, cb, partials);
    // counts are exact in float32 (n < 2^24), as the reference's f32 sums are
    const bool ok_a = (float)ca >= target_lo;
    const bool ok_b = (float)cb >= target_hi;
    lo_a = ok_a ? lo_a : mid_a + 1.0f;
    hi_a = ok_a ? mid_a : hi_a;
    lo_b = ok_b ? lo_b : mid_b + 1.0f;
    hi_b = ok_b ? mid_b : hi_b;
  }
  const float p_lo = lo_a / kGrid;
  const float p_hi = lo_b / kGrid;
  const float scale = 1.0f / fmaxf(p_hi - p_lo, 1e-12f);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    oi[i] = fminf(fmaxf((xi[i] - p_lo) * scale, 0.0f), 1.0f);
}

}  // namespace

extern "C" {

// x, out: [batch, n] float32 on the device. Returns a cudaError_t code.
int t3d_percentile_enhance(const float* x, float* out, int batch, int n,
                           float target_lo, float target_hi, void* stream) {
  const size_t smem = (size_t)n * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      percentile_enhance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  percentile_enhance_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, n, target_lo, target_hi);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
