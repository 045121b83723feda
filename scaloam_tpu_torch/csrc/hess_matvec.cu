// The pose-graph optimise's Hessian-vector product, one launch a CG step:
//
//   out = where(free, damp * v' + chain(v') + gps(v') + loops(v'), 0),
//   v'  = where(free, v, 0),
//
// H = sum_f J_f^T W_f J_f over the odometry factors (node k to k + 1), the
// altitude-only GPS factors (node k; its Jacobian's five zero rows kept in
// the arithmetic) and the loop factors (nodes i_l, j_l), never formed.
//
// Replaces no Pallas kernel: the reference's _hess_matvec
// (scaloam_tpu/models/posegraph.py:447-470, loop sums `.at[].add` at
// :467-468) is XLA's fusion of ~30 operations. In the port it ran as that
// many launches a CG step (gathers, einsums, shifts, two masks and two
// csrc/segment_sum.cu scatter-adds), 192 steps an optimise at 256 nodes.
//
// Order of the additions for every node n (component c), the port's and
// the reference's: damp*v; + Ji^T W Av of odometry factor n; + Jj^T W Av of
// factor n - 1 (0 at node 0); + the GPS term; the node's loop i-rows in
// ascending row order; then its j-rows in ascending row order. Each
// 6-term product J x is ((J0 x0 + J1 x1) + ...) + J5 x5 over the columns,
// each J^T y the same over the rows, and every step is a round-to-nearest
// intrinsic, so nvcc contracts nothing: the plain version
// (scaloam_tpu_torch/ops/kernels/hess_matvec.py) performs the same IEEE
// operations with elementwise tensor ops and the two agree to the bit.
// Nothing is atomic.
//
// Bound on the card: the bytes. At 256 nodes and 64 loops the inputs are
// ~0.17 MB (the three [N, 6, 6] Jacobians most of it), ~5e-5 ms at 3.35
// TB/s; ~0.1 MFLOP. A launch costs more than either: the design's point is
// one launch where there were ~30.
//
// Design: each block owns kNodes consecutive nodes, 6 threads a node.
//  - It stages its nodes' odometry and GPS Jacobians, W, v, damp and the
//    mask into shared memory by cp.async.bulk on one mbarrier
//    (csrc/bulk_stage.cuh), and the halo (factor a - 1 and v at nodes a - 1
//    and b) by plain loads.
//  - It computes W Av of factors a - 1 .. b - 1 and the GPS W J v once
//    (shared), then each thread (node, component) sums its chain terms.
//  - The loop rows whose ends fall in its range come from the plans
//    (segment_sum.plan: rows stably sorted by node, padding slots left
//    out): the block computes each such row's W Avl once (in chunks of
//    kRowCap rows), and each thread adds its node's rows in plan order, the
//    i-rows first, then writes once.

#include <cuda_runtime.h>
#include <cstdint>

#include "bulk_stage.cuh"

namespace {

constexpr int kNodes = 32;  // nodes a block
constexpr int kThreads = 6 * kNodes;
constexpr int kRowCap = 64;  // loop rows a chunk

__device__ __forceinline__ long long lmin(long long x, long long y) { return x < y ? x : y; }
__device__ __forceinline__ long long lmax(long long x, long long y) { return x > y ? x : y; }

// ((J[0] x[0] + J[1] x[1]) + ...) + J[5] x[5], J one row, stride 1
__device__ __forceinline__ float row_dot(const float* J, const float* x) {
  float s = __fmul_rn(J[0], x[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) s = __fadd_rn(s, __fmul_rn(J[k], x[k]));
  return s;
}

// ((J[0][c] y[0] + J[1][c] y[1]) + ...) + J[5][c] y[5], J row-major [6, 6]
__device__ __forceinline__ float col_dot(const float* J, int c, const float* y) {
  float s = __fmul_rn(J[c], y[0]);
#pragma unroll
  for (int r = 1; r < 6; ++r) s = __fadd_rn(s, __fmul_rn(J[6 * r + c], y[r]));
  return s;
}

__global__ void __launch_bounds__(kThreads)
hess_matvec_kernel(const float* __restrict__ v, const float* __restrict__ damp,
                   const bool* __restrict__ free_mask, const float* __restrict__ oJi,
                   const float* __restrict__ oJj, const float* __restrict__ oW,
                   const float* __restrict__ gJ, const float* __restrict__ gW,
                   const float* __restrict__ lJi, const float* __restrict__ lJj,
                   const float* __restrict__ lW, const int64_t* __restrict__ li,
                   const int64_t* __restrict__ lj, const int64_t* __restrict__ ord_i,
                   const int64_t* __restrict__ st_i, const int64_t* __restrict__ ord_j,
                   const int64_t* __restrict__ st_j, int N, float* __restrict__ out) {
  __shared__ __align__(16) float s_oJi[kNodes * 36];
  __shared__ __align__(16) float s_oJj[kNodes * 36];
  __shared__ __align__(16) float s_gJ[kNodes * 36];
  __shared__ __align__(16) float s_v[kNodes * 6];
  __shared__ __align__(16) float s_damp[kNodes * 6];
  __shared__ __align__(16) float s_oW[kNodes * 6];
  __shared__ __align__(16) float s_gW[kNodes * 6];
  __shared__ __align__(16) bool s_free[kNodes];
  __shared__ float s_hJi[36], s_hJj[36], s_hW[6];  // factor a - 1
  __shared__ float s_vlo[6], s_vhi[6];               // v' at nodes a - 1 and b
  __shared__ float s_WAv[(kNodes + 1) * 6];         // factors a - 1 .. b - 1
  __shared__ float s_WAg[kNodes * 6];
  __shared__ float s_rows[kRowCap * 6];  // a chunk's W Avl
  __shared__ int64_t s_row_id[kRowCap];
  __shared__ uint64_t bar;

  const int a = blockIdx.x * kNodes;
  const int nv = min(kNodes, N - a);  // nodes of this block, >= 1
  const int b = a + nv;
  const int t = threadIdx.x;

  // halo: factor a - 1 (none at node 0) and v' beside the range
  if (t < 36) {
    s_hJi[t] = a > 0 ? oJi[36 * (a - 1) + t] : 0.0f;
    s_hJj[t] = a > 0 ? oJj[36 * (a - 1) + t] : 0.0f;
  }
  if (t < 6) {
    s_hW[t] = a > 0 ? oW[6 * (a - 1) + t] : 0.0f;
    s_vlo[t] = a > 0 && free_mask[a - 1] ? v[6 * (a - 1) + t] : 0.0f;
    s_vhi[t] = b < N && free_mask[b] ? v[6 * b + t] : 0.0f;
  }
  const bulk::Copy copies[8] = {
      bulk::copy(s_oJi, oJi + 36 * a, 36LL * nv), bulk::copy(s_oJj, oJj + 36 * a, 36LL * nv),
      bulk::copy(s_gJ, gJ + 36 * a, 36LL * nv),   bulk::copy(s_v, v + 6 * a, 6LL * nv),
      bulk::copy(s_damp, damp + 6 * a, 6LL * nv), bulk::copy(s_oW, oW + 6 * a, 6LL * nv),
      bulk::copy(s_gW, gW + 6 * a, 6LL * nv),     bulk::copy(s_free, free_mask + a, nv)};
  bulk::stage(copies, &bar);

  // v' = where(free, v, 0); the nodes past N hold 0 (the chain's v'[N])
  s_v[t] = t / 6 < nv && s_free[t / 6] ? s_v[t] : 0.0f;  // kThreads == 6 * kNodes
  __syncthreads();

  // W Av of factors a - 1 .. b - 1 (local f + 1), the GPS W J v of the nodes
  for (int item = t; item < (kNodes + 1) * 6 + kNodes * 6; item += kThreads) {
    if (item < (kNodes + 1) * 6) {
      const int f = item / 6 - 1, r = item % 6;
      if (f >= nv || (f < 0 && a == 0)) continue;
      const float* Ji = f < 0 ? s_hJi : s_oJi + 36 * f;
      const float* Jj = f < 0 ? s_hJj : s_oJj + 36 * f;
      const float* W = f < 0 ? s_hW : s_oW + 6 * f;
      const float* vi = f < 0 ? s_vlo : s_v + 6 * f;
      const float* vj = f + 1 < kNodes ? s_v + 6 * (f + 1) : s_vhi;
      const float Av = __fadd_rn(row_dot(Ji + 6 * r, vi), row_dot(Jj + 6 * r, vj));
      s_WAv[item] = __fmul_rn(W[r], Av);
    } else {
      const int k = item - (kNodes + 1) * 6, q = k / 6, r = k % 6;
      if (q >= nv) continue;
      s_WAg[k] = __fmul_rn(s_gW[k], row_dot(s_gJ + 36 * q + 6 * r, s_v + 6 * q));
    }
  }
  __syncthreads();

  // the chain and GPS terms of node a + q, component c
  const int q = t / 6, c = t % 6;
  float acc = 0.0f;
  if (q < nv) {
    acc = __fmul_rn(s_damp[t], s_v[t]);
    acc = __fadd_rn(acc, col_dot(s_oJi + 36 * q, c, s_WAv + 6 * (q + 1)));
    const float down = a + q == 0 ? 0.0f
                       : col_dot(q == 0 ? s_hJj : s_oJj + 36 * (q - 1), c, s_WAv + 6 * q);
    acc = __fadd_rn(acc, down);
    acc = __fadd_rn(acc, col_dot(s_gJ + 36 * q, c, s_WAg + 6 * q));
  }

  // the loop rows of the block's nodes: positions [ia, ib) of plan i, then
  // [ja, jb) of plan j, as local rows [0, Ri) and [Ri, Ri + Rj)
  const long long ia = st_i[a], ib = st_i[b], ja = st_j[a], jb = st_j[b];
  const long long Ri = ib - ia, R = Ri + (jb - ja);
  long long my_i0 = 0, my_i1 = 0, my_j0 = 0, my_j1 = 0;
  if (q < nv) {
    my_i0 = st_i[a + q] - ia;
    my_i1 = st_i[a + q + 1] - ia;
    my_j0 = Ri + st_j[a + q] - ja;
    my_j1 = Ri + st_j[a + q + 1] - ja;
  }
  for (long long base = 0; base < R; base += kRowCap) {
    const int n_rows = R - base < kRowCap ? static_cast<int>(R - base) : kRowCap;
    for (int item = t; item < n_rows * 6; item += kThreads) {
      const long long k = base + item / 6;
      const int r = item % 6;
      const int64_t l = k < Ri ? ord_i[ia + k] : ord_j[ja + (k - Ri)];
      const int64_t i = li[l], j = lj[l];
      float vi[6], vj[6];
      const bool fi = free_mask[i], fj = free_mask[j];
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        vi[m] = fi ? v[6 * i + m] : 0.0f;
        vj[m] = fj ? v[6 * j + m] : 0.0f;
      }
      const float Avl = __fadd_rn(row_dot(lJi + 36 * l + 6 * r, vi), row_dot(lJj + 36 * l + 6 * r, vj));
      s_rows[item] = __fmul_rn(lW[6 * l + r], Avl);
      if (r == 0) s_row_id[item / 6] = l;
    }
    __syncthreads();
    const long long end = base + n_rows;
    for (long long k = lmax(my_i0, base); k < lmin(my_i1, end); ++k)
      acc = __fadd_rn(acc, col_dot(lJi + 36 * s_row_id[k - base], c, s_rows + 6 * (k - base)));
    for (long long k = lmax(my_j0, base); k < lmin(my_j1, end); ++k)
      acc = __fadd_rn(acc, col_dot(lJj + 36 * s_row_id[k - base], c, s_rows + 6 * (k - base)));
    __syncthreads();
  }

  if (q < nv) out[6 * (a + q) + c] = s_free[q] ? acc : 0.0f;
}

}  // namespace

extern "C" int scaloam_hess_matvec(const float* v, const float* damp, const bool* free_mask,
                                   const float* oJi, const float* oJj, const float* oW,
                                   const float* gJ, const float* gW, const float* lJi,
                                   const float* lJj, const float* lW, const int64_t* li,
                                   const int64_t* lj, const int64_t* ord_i, const int64_t* st_i,
                                   const int64_t* ord_j, const int64_t* st_j, int N, float* out,
                                   cudaStream_t stream) {
  if (N < 1) return int(cudaErrorInvalidValue);
  const int blocks = (N + kNodes - 1) / kNodes;
  hess_matvec_kernel<<<blocks, kThreads, 0, stream>>>(v, damp, free_mask, oJi, oJj, oW, gJ, gW,
                                                      lJi, lJj, lW, li, lj, ord_i, st_i, ord_j,
                                                      st_j, N, out);
  return int(cudaGetLastError());
}
