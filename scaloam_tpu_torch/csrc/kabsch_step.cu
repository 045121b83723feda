// One weighted-Kabsch step of ICP, one launch an iteration: for each batch
// row b, with weights w [S] and targets t [S, 3] for the source s [S, 3],
//
//   wsum = max(sum w, 1), mu_s = sum w s / wsum, mu_t = sum w t / wsum,
//   P = (s - mu_s) w, Q = t - mu_t (0 where w <= 0 if mask_q), H = P^T Q,
//   R = the Kabsch rotation of H (csrc/kabsch.cuh), t = mu_t - R mu_s,
//
// and the pose (mat_to_quat(R), t), mat_to_quat as
// scaloam_tpu_torch/ops/se3.py computes it (the largest of four pivots,
// the first of equal ones; w >= 0).
//
// Replaces no Pallas kernel: the reference's ICP step
// (scaloam_tpu/ops/icp.py:113-126, and its twin at :185) is XLA's fusion of
// the sums, a LAPACK SVD and mat_to_quat. In the port that step was ~40
// launches an ICP iteration (sums, divisions, P, Q, a matmul, the
// csrc/kabsch.cu rotation, t and mat_to_quat's ~25 operations); this is one.
//
// Bound on the card: the bytes, 28 a point (s, w, t read once): 0.23 MB at
// the fine stage's 8192 points (~7e-5 ms at 3.35 TB/s), 0.17 MB at the
// coarse stage's 2 x 2048; ~30 float operations a point. The launch and the
// two dependent reductions cost more: the design keeps it to one launch.
//
// Design: one thread-block cluster of C <= 8 blocks (the portable size) a
// batch row, kThreads threads a block; block r owns points
// [r K kThreads, (r + 1) K kThreads) of its row, thread i of it the points
// i, i + kThreads, ... of that slice (K each). C and K come from the host
// (scaloam_tpu_torch/ops/kernels/kabsch.py `step_layout`), so the plain
// version sums in the same tree:
//  - Each block stages its slice of s, w and t into shared memory once, by
//    cp.async.bulk on one mbarrier (csrc/bulk_stage.cuh).
//  - Pass 1 sums sum w, sum w s, sum w t; pass 2 H's 9 entries, both from
//    shared memory. Each sum: a thread's partial from 0 over its points in
//    order; the warp's by an xor butterfly (offsets 16, 8, 4, 2, 1); the
//    block's over its warps in order; the cluster's over the blocks in rank
//    order: every block writes its partials into every block's inbox
//    through distributed shared memory, one cluster.sync(), and each block
//    adds its inbox in rank order, so every block holds bit-identical sums.
//  - Thread 0 of the leading block runs the rotation, t and the quaternion.
// Every step is a round-to-nearest intrinsic (nvcc contracts nothing), so
// the plain version's elementwise tensor ops give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "bulk_stage.cuh"
#include "kabsch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kBytesPerPoint = 28;  // s (12), w (4), t (12)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-12f;  // se3._EPS

// The sums v[0..Q) over every thread of the cluster (see the header), into
// every thread's tot[0..Q).
template <int Q>
__device__ void cluster_sum(float (&v)[Q], float (*red)[Q], float (*inbox)[Q],
                            const cg::cluster_group& cluster, float (&tot)[Q]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[q] = __fadd_rn(v[q], __shfl_xor_sync(kFull, v[q], off));
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < Q; ++q) red[warp][q] = v[q];
  __syncthreads();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x < Q) {
    const int q = threadIdx.x;
    float s = red[0][q];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w][q]);
    for (int r = 0; r < n; ++r) cluster.map_shared_rank(&inbox[rank][q], r)[0] = s;
  }
  cluster.sync();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float s = inbox[0][q];
    for (int r = 1; r < n; ++r) s = __fadd_rn(s, inbox[r][q]);
    tot[q] = s;
  }
}

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// se3.mat_to_quat of R (row-major [3, 3]) into q (wxyz)
__device__ void mat_to_quat(const float (&m)[9], float (&q)[4]) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5],
              m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = add(add(m00, m11), m22);
  const float p[4] = {add(1.0f, tr), sub(sub(add(1.0f, m00), m11), m22),
                      sub(add(sub(1.0f, m00), m11), m22), add(sub(sub(1.0f, m00), m11), m22)};
  const float cand[4][4] = {
      {p[0], sub(m21, m12), sub(m02, m20), sub(m10, m01)},
      {sub(m21, m12), p[1], add(m01, m10), add(m02, m20)},
      {sub(m02, m20), add(m01, m10), p[2], add(m12, m21)},
      {sub(m10, m01), add(m02, m20), add(m12, m21), p[3]}};
  int best = 0;  // the first of equal pivots
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (p[k] > p[best]) best = k;
  float c[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = cand[best][k];
  const float n2 = add(add(add(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])), __fmul_rn(c[2], c[2])),
                       __fmul_rn(c[3], c[3]));
  float n = __fsqrt_rn(n2);
  n = n < kEps ? kEps : n;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = __fdiv_rn(c[k], n);
  const float sign = c[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __fmul_rn(c[k], sign);
}

__global__ void __launch_bounds__(kThreads)
kabsch_step_kernel(const float* __restrict__ src, long long src_stride,
                   const float* __restrict__ w, const float* __restrict__ tgt, int S, int K,
                   int mask_q, float* __restrict__ quat, float* __restrict__ trans) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red1[kWarps][7], red2[kWarps][9];
  __shared__ float inbox1[kMaxCluster][7], inbox2[kMaxCluster][9];
  __shared__ uint64_t bar;

  // Arrive now, wait before the first write into another block's shared
  // memory: every block of the cluster has then started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C;
  const int slice = K * kThreads;
  const int lo = rank * slice;
  const int n = max(0, min(S - lo, slice));  // this block's points

  float* s_src = reinterpret_cast<float*>(smem);  // [slice, 3]
  float* s_w = s_src + 3 * slice;                  // [slice]
  float* s_tgt = s_w + slice;                      // [slice, 3]
  const long long wrow = static_cast<long long>(row) * S + lo;
  const bulk::Copy copies[3] = {
      bulk::copy(s_src, src + row * src_stride + 3LL * lo, 3LL * n),
      bulk::copy(s_w, w + wrow, static_cast<long long>(n)),
      bulk::copy(s_tgt, tgt + 3 * wrow, 3LL * n)};
  bulk::stage(copies, &bar);

  // pass 1: sum w, sum w s, sum w t
  float v1[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < n) {
      const float we = s_w[e];
      v1[0] = add(v1[0], we);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v1[1 + c] = add(v1[1 + c], __fmul_rn(s_src[3 * e + c], we));
        v1[4 + c] = add(v1[4 + c], __fmul_rn(s_tgt[3 * e + c], we));
      }
    }
  }
  float t1[7];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster_sum<7>(v1, red1, inbox1, cluster, t1);
  const float wsum = t1[0] < 1.0f ? 1.0f : t1[0];  // clamp(min=1), NaN kept
  float mu_s[3], mu_t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = __fdiv_rn(t1[1 + c], wsum);
    mu_t[c] = __fdiv_rn(t1[4 + c], wsum);
  }

  // pass 2: H = P^T Q
  float v2[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < n) {
      const float we = s_w[e];
      const bool keep = !mask_q || we > 0.0f;
      float P[3], Q[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        P[c] = __fmul_rn(sub(s_src[3 * e + c], mu_s[c]), we);
        Q[c] = keep ? sub(s_tgt[3 * e + c], mu_t[c]) : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) v2[3 * a + b] = add(v2[3 * a + b], __fmul_rn(P[a], Q[b]));
    }
  }
  float H[9];
  cluster_sum<9>(v2, red2, inbox2, cluster, H);

  if (rank == 0 && threadIdx.x == 0) {
    float R[9], q[4];
    kabsch3::rotation(H, R);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float Rmu = add(add(__fmul_rn(R[3 * a], mu_s[0]), __fmul_rn(R[3 * a + 1], mu_s[1])),
                            __fmul_rn(R[3 * a + 2], mu_s[2]));
      trans[3 * row + a] = sub(mu_t[a], Rmu);
    }
    mat_to_quat(R, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) quat[4 * row + k] = q[k];
  }
  // No block reads or writes another's shared memory past the last
  // cluster.sync(), so each may leave.
}

}  // namespace

// Shared memory a block needs for a slice of K * kThreads points.
extern "C" long long scaloam_kabsch_step_smem(int K) {
  return static_cast<long long>(K) * kThreads * kBytesPerPoint;
}

extern "C" int scaloam_kabsch_step_threads() { return kThreads; }

// B rows, clusters of C blocks, K points a thread; src_stride 0 when every
// row shares one source, else 3 S.
extern "C" int scaloam_kabsch_step(const float* src, long long src_stride, const float* w,
                                   const float* tgt, int B, int S, int C, int K, int mask_q,
                                   float* quat, float* trans, cudaStream_t stream) {
  static int smem_limit = 0;  // the kernel's raised dynamic shared-memory limit
  if (B < 1 || C < 1 || C > kMaxCluster || K < 1) return int(cudaErrorInvalidValue);
  const long long smem = scaloam_kabsch_step_smem(K);
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        kabsch_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return int(err);
    smem_limit = static_cast<int>(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kabsch_step_kernel, src, src_stride, w, tgt, S,
                                             K, mask_q, quat, trans);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
