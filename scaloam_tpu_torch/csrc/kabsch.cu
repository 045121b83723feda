// The weighted Kabsch rotation of ICP's alignment step: for each 3x3
// H = P^T Q the proper rotation R = V diag(1, 1, sign det(V U^T)) U^T of
// H's SVD H = U S V^T, singular values in descending order.
//
// Replaces no Pallas kernel: the reference calls jnp.linalg.svd inside its
// compiled ICP programs (scaloam_tpu/ops/icp.py:122-126, :185-189). On the
// card torch.linalg.svd reads the device from the host, so the ICP step
// could not be captured as one program; this kernel is one launch a solve.
//
// One thread a matrix, everything in registers (the device code is in
// csrc/kabsch.cuh, which csrc/kabsch_step.cu shares): a one-sided (Hestenes)
// Jacobi orthogonalises H's columns by SWEEPS sweeps of plane rotations
// over the pairs (0, 1), (0, 2), (1, 2), accumulating V; the two columns of
// largest norm give u1, u2 (u2 made orthogonal to u1) and v1, v2, and
//   R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T,
// which is the sign-fixed rotation for any third singular pair (a
// near-planar or rank-2 H included). H is scaled by its largest entry
// first; a zero column norm takes a unit vector instead (H = 0 gives I).
// The algorithm and its reasons: scaloam_tpu_torch/ops/kernels/kabsch.py,
// whose plain version performs the same IEEE operations in the same order:
// every step here is a round-to-nearest intrinsic, so nvcc contracts
// nothing and the two agree to the bit.
//
// Bound on the card: ~1.5k float operations and 72 bytes a matrix; at the
// ICP's 1-2 matrices a launch the launch itself is the cost.

#include <cuda_runtime.h>
#include <cstdint>

#include "kabsch.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
kabsch_kernel(const float* __restrict__ H, int64_t n, float* __restrict__ R) {
  const int64_t m = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= n) return;
  float h[9], r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = H[9 * m + k];
  kabsch3::rotation(h, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[9 * m + k] = r[k];
}

}  // namespace

extern "C" int scaloam_kabsch(const float* H, long long n, float* R, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  kabsch_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(H, n, R);
  return int(cudaGetLastError());
}
