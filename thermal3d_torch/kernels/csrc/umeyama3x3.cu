// The Umeyama/Kabsch 3x3 solve of the pseudo-GT pose, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves its 3x3 SVD and sign fix
// (thermal3d/geometry/umeyama.py::_umeyama_core, jnp.linalg.svd and two
// jnp.linalg.det) to XLA. On CUDA, torch.linalg.svd reads the solver's info
// back to the host, so a pseudo-GT step that called it waited there for the
// device and the host could not dispatch the next step while this one
// computed. This kernel reads nothing back.
//
// For each covariance C (float32 [3,3], row-major), in float64 registers:
//   1. one-sided cyclic Jacobi on C's columns: B = C V, V a product of plane
//      rotations (so det V = +1), kSweeps sweeps over the pairs (0,1),
//      (0,2), (1,2), each rotation making its two columns orthogonal;
//   2. the columns sorted by norm, descending, by three compare-and-swaps;
//      a swap negates the column it moves down, so det V stays +1;
//   3. U = [u1, u2, u1 x u2]: u1 = b1/|b1| (e1 if C = 0), u2 = b2 less its
//      part along u1, normalised (if less than kLeft of it is left, u1 x e_k
//      for the axis e_k least along u1), so det U = +1 and every column is
//      finite;
//   4. the singular values as u_i . C v_i = u_i . b_i, not as square roots of
//      eigenvalues, so small ones keep their absolute accuracy: s1, |s2|
//      and a signed s3 whose sign is det C's;
//   5. R = U V^T, the Kabsch rotation (C = U diag(s1, s2, s3) V^T with U, V
//      rotations), and rank_ok = (#|s_i| > FLT_EPSILON) >= 2.
// kernels/umeyama3x3.py::kabsch3x3_plain is the same arithmetic in PyTorch.
//
// What bounds it on an H100: latency. A step solves 8 covariances, one
// thread each (128 a block), each one dependent chain of about a thousand
// float64 operations, 96 of them square roots and divisions: ~10 us a launch
// against a step's ~89 ms of device work, so nothing more is done for speed.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// The columns were orthogonal to float64 rounding after 4 sweeps on every
// input tried (random, clustered, ill-conditioned, rank-deficient).
constexpr int kSweeps = 8;
constexpr double kLeft = 1e-6;  // least share of b2 off u1 that makes u2

// b[i][j], v[i][j]: row i, column j
__device__ __forceinline__ void rotate(double (&b)[3][3], double (&v)[3][3], int p, int q) {
  double a = 0.0, c2 = 0.0, g = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a += b[i][p] * b[i][p];
    c2 += b[i][q] * b[i][q];
    g += b[i][p] * b[i][q];
  }
  if (g == 0.0) return;
  const double zeta = (c2 - a) / (2.0 * g);
  const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  const double c = 1.0 / sqrt(1.0 + t * t);
  const double s = c * t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double bp = b[i][p], bq = b[i][q];
    b[i][p] = c * bp - s * bq;
    b[i][q] = s * bp + c * bq;
    const double vp = v[i][p], vq = v[i][q];
    v[i][p] = c * vp - s * vq;
    v[i][q] = s * vp + c * vq;
  }
}

// Columns p < q in descending order of norm; a swap negates the new column q.
__device__ __forceinline__ void order(double (&b)[3][3], double (&v)[3][3], double (&n)[3],
                                      int p, int q) {
  if (!(n[q] > n[p])) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double bp = b[i][p], vp = v[i][p];
    b[i][p] = b[i][q];
    b[i][q] = -bp;
    v[i][p] = v[i][q];
    v[i][q] = -vp;
  }
  const double np = n[p];
  n[p] = n[q];
  n[q] = np;
}

__device__ __forceinline__ void cross(const double (&x)[3], const double (&y)[3],
                                      double (&out)[3]) {
  out[0] = x[1] * y[2] - x[2] * y[1];
  out[1] = x[2] * y[0] - x[0] * y[2];
  out[2] = x[0] * y[1] - x[1] * y[0];
}

__global__ void __launch_bounds__(kThreads)
umeyama3x3_kernel(const float* __restrict__ cov, float* __restrict__ r, float* __restrict__ sig,
                  uint8_t* __restrict__ rank_ok, int batch) {
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= batch) return;
  const float* c = cov + (size_t)item * 9;
  double b[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[i][j] = (double)c[i * 3 + j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate(b, v, 0, 1);
    rotate(b, v, 0, 2);
    rotate(b, v, 1, 2);
  }
  double n[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) n[j] = b[0][j] * b[0][j] + b[1][j] * b[1][j] + b[2][j] * b[2][j];
  order(b, v, n, 0, 1);
  order(b, v, n, 1, 2);
  order(b, v, n, 0, 1);

  double u1[3], u2[3], u3[3];
  const double s1 = sqrt(n[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = s1 > 0.0 ? b[i][0] / s1 : (i == 0 ? 1.0 : 0.0);
  const double along = u1[0] * b[0][1] + u1[1] * b[1][1] + u1[2] * b[2][1];
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = b[i][1] - along * u1[i];
  double w = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  // b2 of a rank-1 C is rounding noise and may lie along u1; what is left of
  // it then is not orthogonal to u1 to float64 precision: complete instead
  if (!(w > kLeft * sqrt(n[1]))) {
    int k = 0;
#pragma unroll
    for (int i = 1; i < 3; ++i)
      if (fabs(u1[i]) < fabs(u1[k])) k = i;
    double e[3] = {0.0, 0.0, 0.0};
    e[k] = 1.0;
    cross(u1, e, u2);
    w = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] /= w;
  cross(u1, u2, u3);

  double s[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[0] += u1[i] * b[i][0];
    s[1] += u2[i] * b[i][1];
    s[2] += u3[i] * b[i][2];
  }
  s[1] = fabs(s[1]);
  int above = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    above += fabs(s[j]) > (double)FLT_EPSILON;
    sig[(size_t)item * 3 + j] = (float)s[j];
  }
  rank_ok[item] = above >= 2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[(size_t)item * 9 + i * 3 + j] =
          (float)(u1[i] * v[j][0] + u2[i] * v[j][1] + u3[i] * v[j][2]);
  }
}

}  // namespace

extern "C" {

// cov, r: [batch, 3, 3] float32 on the device; sig: [batch, 3] float32;
// rank_ok: [batch] bytes (torch.bool). Launches on `stream`. Returns a
// cudaError_t code.
int t3d_umeyama3x3(const float* cov, float* r, float* sig, uint8_t* rank_ok, int batch,
                   void* stream) {
  if (batch <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + kThreads - 1) / kThreads;
  umeyama3x3_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(cov, r, sig, rank_ok, batch);
  return (int)cudaGetLastError();
}

const char* t3d_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
