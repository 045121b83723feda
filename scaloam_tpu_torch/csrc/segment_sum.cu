// A scatter-add in one fixed order: out[n] = base[n] + the rows whose index
// is n, added one after another in ascending row order, which is the order
// of the reference's `.at[idx].add(rows)` (XLA's scatter walks its updates
// in order, scaloam_tpu/models/posegraph.py:439-443, :467-468). PyTorch's
// index_add_ on the card sums colliding rows with float atomics, in a new
// order each run.
//
// Replaces no Pallas kernel. The caller sorts the rows once by a stable
// sort of their index (order) and passes each segment's first position in
// that order (starts, [N + 1]); one thread a (segment, component) walks its
// rows in order and writes its sum once. Nothing is atomic, so a result is
// the same every run and equals the plain version
// (scaloam_tpu_torch/ops/kernels/segment_sum.py) bit for bit.
//
// Bound on the card: the bytes (base, rows, order, starts read once, the
// output written once); a few hundred loop rows a call, so the launch is
// the cost.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ base, const float* __restrict__ rows,
                   const int64_t* __restrict__ order, const int64_t* __restrict__ starts,
                   int64_t n, int64_t c, float* __restrict__ out) {
  const int64_t k = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n * c) return;
  const int64_t seg = k / c, col = k - seg * c;
  float acc = base[k];
  const int64_t end = starts[seg + 1];
  for (int64_t r = starts[seg]; r < end; ++r) {
    acc = __fadd_rn(acc, rows[order[r] * c + col]);
  }
  out[k] = acc;
}

}  // namespace

extern "C" int scaloam_segment_sum(const float* base, const float* rows, const int64_t* order,
                                   const int64_t* starts, long long n, long long c, float* out,
                                   cudaStream_t stream) {
  const long long blocks = (n * c + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  segment_sum_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(base, rows, order, starts, n, c,
                                                                 out);
  return int(cudaGetLastError());
}
