// Float32 arithmetic rounded as the JAX reference's compiled CPU program
// rounds it, where a ranking or a threshold hangs on the last ulp: the 2-NN
// sweeps' squared distances, squared norms and atan2.
//
// Replaces no Pallas kernel. sq_dist is XLA:CPU's compiled form of the
// reference's |q|^2 + |t|^2 - 2 q.t (knn, scaloam_tpu/ops/voxel.py:534, and
// the sweeps built on it), sum3_sq its compiled jnp.sum(v * v, axis=-1) over
// x, y, z (curvature, range filter, grid-map and re-rank distances), atan2
// the C library's atan2f that XLA calls for jnp.arctan2
// (scaloam_tpu/ops/features.py:52, :91, :114). Their plain versions are
// scaloam_tpu_torch/ops/f32.py's sq_dist, sum3_sq and atan2, float64 /
// float32 elementwise PyTorch that rounds the same on the CPU and the card.
//
// Every step is written with a round-to-nearest intrinsic, so nvcc contracts
// nothing: __fmaf_rn is XLA's contracted multiply-add (one rounding), and a
// separate __fmul_rn / __fadd_rn / __fdiv_rn is a step XLA or glibc rounds on
// its own.
//
// sq_dist: out[b, i, j] for query [B, Q, 3] and target [B, T, 3], each
//   squared norm and the dot product a chain of fused multiply-adds over
//   x, y, z, then (|q|^2 + |t|^2) - 2 q.t. Bound on the card: the [Q, T]
//   output (4 bytes a pair) against 12 bytes of input a point. A thread owns
//   one target point and kRows query rows (broadcast from shared memory), so
//   each output is written once, coalesced, and nothing else is stored.
// sum3_sq: out[k] for v [n, 3], the same chain as sq_dist's norms, one
//   thread an element.
// atan2: glibc's float atan2f (csrc/atan2f.cuh), one thread an element.

#include <cuda_runtime.h>
#include <cstdint>

#include "atan2f.cuh"

namespace {

constexpr int kThreads = 128;  // target points of a block
constexpr int kRows = 8;       // query rows of a block

__device__ __forceinline__ float sum3_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__global__ void __launch_bounds__(kThreads)
sq_dist_kernel(const float* __restrict__ q, const float* __restrict__ t, int Q, int T,
               float* __restrict__ out) {
  __shared__ float rows[kRows][4];  // x, y, z, |q|^2
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  q += size_t(b) * Q * 3;
  t += size_t(b) * T * 3;
  out += size_t(b) * Q * T;
  if (threadIdx.x < kRows && i0 + int(threadIdx.x) < Q) {
    const float* p = q + size_t(i0 + threadIdx.x) * 3;
    const float x = p[0], y = p[1], z = p[2];
    rows[threadIdx.x][0] = x;
    rows[threadIdx.x][1] = y;
    rows[threadIdx.x][2] = z;
    rows[threadIdx.x][3] = sum3_sq(x, y, z);
  }
  __syncthreads();
  if (j >= T) return;
  const float tx = t[3 * size_t(j)], ty = t[3 * size_t(j) + 1], tz = t[3 * size_t(j) + 2];
  const float tt = sum3_sq(tx, ty, tz);
  const int n = min(kRows, Q - i0);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= n) break;
    const float c = __fmaf_rn(rows[r][2], tz, __fmaf_rn(rows[r][1], ty, __fmul_rn(rows[r][0], tx)));
    out[size_t(i0 + r) * T + j] = __fsub_rn(__fadd_rn(rows[r][3], tt), __fmul_rn(2.0f, c));
  }
}

__global__ void sum3_sq_kernel(const float* __restrict__ v, int64_t n, float* __restrict__ out) {
  const int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  out[k] = sum3_sq(v[3 * k], v[3 * k + 1], v[3 * k + 2]);
}

__global__ void atan2_kernel(const float* __restrict__ y, const float* __restrict__ x, int64_t n,
                             float* __restrict__ out) {
  const int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  out[k] = glibc_f32::atan2f(y[k], x[k]);
}

}  // namespace

extern "C" int scaloam_sq_dist(const void* query, const void* target, int B, int Q, int T,
                               void* out, void* stream) {
  if (B <= 0 || Q <= 0 || T <= 0) return 0;
  const dim3 grid((T + kThreads - 1) / kThreads, (Q + kRows - 1) / kRows, B);
  sq_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(target), Q, T,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scaloam_sum3_sq(const void* v, long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  sum3_sq_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scaloam_atan2f(const void* y, const void* x, long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  atan2_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
