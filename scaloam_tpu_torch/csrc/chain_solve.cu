// The pose-chain preconditioner's block-tridiagonal solve, one launch a
// call: cyclic reduction over the packed factor of ops/blocktri.py,
//
//   out = [where(free, .., 0) if mask_out] solve(chain, where(free, b, 0))
//
// for b [n, 6] or the multi-right-hand-side [n, 6, C] (free optional).
//
// Replaces no Pallas kernel: the reference's blocktri.solve
// (scaloam_tpu/ops/blocktri.py:201-258) is XLA's fusion of each level's
// 6x6 products. In the port it ran as ~90 launches a call at 256 nodes
// (three batched matmuls, two subtractions, a slice update and a stack a
// level, 8 levels down and 8 up), 195 calls an optimise.
//
// The factor (ops/blocktri.py `factor`) packs level l's inverted odd
// diagonal blocks Do_inv, couplings L[k] = B[2k] and R[k] = B[2k + 1] at
// rows P - (P >> l) .. P - (P >> (l + 1)) - 1 of three [P - 1, 6, 6]
// buffers (P = N padded to a power of two), and the root's inverse.
//
// Order of operations at every level, the port's (and the plain version's,
// scaloam_tpu_torch/ops/kernels/chain_solve.py):
//   forward  t = Do_inv bo; x = be - L t; x[k] -= R[k-1]^T t[k-1] (k >= 1)
//   root     x = root_inv x
//   back     rhs = bo - L^T x; rhs[k] -= R[k] x[k+1] (k < m - 1);
//            x_odd = Do_inv rhs
// Each 6-term product sums its terms from the first, one rounding a step,
// every step a round-to-nearest intrinsic, so nvcc contracts nothing and
// the kernel gives the plain version's bits. Nothing is atomic and the
// order is the same whatever the launch shape.
//
// Bound on the card: the bytes. At 256 nodes it reads 3 x 255 x 144 B of
// levels + 144 B of root and the 6 KB vector, and writes 6 KB: ~0.12 MB,
// ~3.7e-5 ms at 3.35 TB/s; ~0.1 MFLOP. The levels are sequential: the
// design's point is one launch with block barriers between levels where
// there were ~90 launches.
//
// Design: the state x (N_pad x 6 floats a column) lives in shared memory
// and the reduction runs in place: level l's odd positions keep their bo
// for the back substitution, which writes x_odd over them. One thread an
// item (block row k of a level, column c): it forms t[k - 1] itself (the
// same operations as the item of k - 1), so a level costs one barrier down
// and one up, and writes only its own position of the level (2k s down,
// (2k + 1) s up), which no other item of the level reads. Two layouts:
//  - staged (the optimise's 256-node chain and smaller): one block a group
//    of up to 32 columns stages every level's blocks into its shared
//    memory first (~110 KB at 256 nodes, four cp.async.bulk copies on one
//    mbarrier, csrc/bulk_stage.cuh), so that the levels' ~17
//    barrier-separated phases read shared memory only;
//  - clustered (larger chains, and wide right-hand sides that do not fit):
//    a cluster of 8 blocks a group of columns, x spread over the blocks'
//    shared memory by node position (read and written through distributed
//    shared memory), the items of a level spread over the cluster's
//    threads, the level's blocks read from global memory (L2-resident: the
//    factor wrote them just before) by 8 SMs, cluster barriers between
//    levels. Items of one block row and neighbouring columns read the same
//    matrix entries, so a warp's loads of them are broadcasts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "bulk_stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxColumns = 32;            // columns a group
constexpr int kCluster = 8;                // blocks a cluster, the clustered layout
constexpr long long kSmemMaxBytes = 200 * 1024;

struct Args {
  const float* Do_inv;  // [P - 1, 6, 6]
  const float* L;
  const float* R;
  const float* root;    // [6, 6]
  const float* b;       // [n, 6, C]
  const bool* free_mask;
  float* out;           // [n, 6, C]
  int P, n, C, cw;      // cw: columns a group
  int mask_out, staged;
};

// A 6x6 block (16-byte aligned, shared or global) into registers as nine
// 16-byte loads: a warp's rows 144 B apart touch every bank once a quarter.
__device__ __forceinline__ void load36(const float* M, float* m) {
  const float4* q = reinterpret_cast<const float4*>(M);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 v = q[i];
    m[4 * i] = v.x;
    m[4 * i + 1] = v.y;
    m[4 * i + 2] = v.z;
    m[4 * i + 3] = v.w;
  }
}

// y = M v: y[i] = ((M[i][0] v[0] + M[i][1] v[1]) + ...) + M[i][5] v[5]
__device__ __forceinline__ void mv(const float* M, const float* v, float* y) {
  float m[36];
  load36(M, m);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = __fmul_rn(m[6 * i], v[0]);
#pragma unroll
    for (int j = 1; j < 6; ++j) s = __fadd_rn(s, __fmul_rn(m[6 * i + j], v[j]));
    y[i] = s;
  }
}

// y = M^T v: y[i] = ((M[0][i] v[0] + M[1][i] v[1]) + ...) + M[5][i] v[5]
__device__ __forceinline__ void mtv(const float* M, const float* v, float* y) {
  float m[36];
  load36(M, m);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = __fmul_rn(m[i], v[0]);
#pragma unroll
    for (int j = 1; j < 6; ++j) s = __fadd_rn(s, __fmul_rn(m[6 * j + i], v[j]));
    y[i] = s;
  }
}

// a column's 6 components, cw apart (one column: three 8-byte loads)
__device__ __forceinline__ void load6(const float* p, int stride, float* v) {
  if (stride == 1) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float2 w = q[i];
      v[2 * i] = w.x;
      v[2 * i + 1] = w.y;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = p[i * stride];
}

__device__ __forceinline__ void store6(float* p, int stride, const float* v) {
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i * stride] = v[i];
}

__global__ void __launch_bounds__(kMaxThreads) chain_solve_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = a.P, cw = a.cw;
  const int c0 = static_cast<int>(blockIdx.x) / n_blocks * cw;  // the group's first column
  const int Pb = P / n_blocks;                                   // positions a block holds
  const int tid = rank * blockDim.x + threadIdx.x, n_threads = n_blocks * blockDim.x;
  const float *Do_inv = a.Do_inv, *L = a.L, *R = a.R, *root = a.root;
  float* xs = smem;  // [Pb][6][cw]
  if (a.staged) {  // one block: every level's blocks, then the root, ahead of x
    __shared__ uint64_t bar;
    const int nm = 36 * (P - 1);
    float* s_D = smem;
    const bulk::Copy copies[4] = {
        bulk::copy(s_D, a.Do_inv, nm), bulk::copy(s_D + nm, a.L, nm),
        bulk::copy(s_D + 2 * nm, a.R, nm), bulk::copy(s_D + 3 * nm, a.root, 36)};
    bulk::stage(copies, &bar);
    Do_inv = s_D;
    L = s_D + nm;
    R = s_D + 2 * nm;
    root = s_D + 3 * nm;
    xs = s_D + 3 * nm + 36;
  }
  // column c's component 0 at node position pos (component i at + i cw)
  auto at = [&](int pos, int c) -> float* {
    float* base = n_blocks == 1 ? xs : cluster.map_shared_rank(xs, pos / Pb);
    return base + (pos % Pb) * 6 * cw + c;
  };
  // a block barrier alone, a cluster's barrier across its blocks
  auto sync = [&]() {
    if (n_blocks == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  const bool* free_mask = a.free_mask;
  for (int e = threadIdx.x; e < Pb * 6 * cw; e += blockDim.x) {
    const int pos = rank * Pb + e / (6 * cw), col = c0 + e % cw;
    const bool in = pos < a.n && col < a.C;
    const float v = in ? a.b[(size_t(pos) * 6 + e / cw % 6) * a.C + col] : 0.0f;
    const bool held = in && (free_mask == nullptr || free_mask[pos]);
    xs[e] = held ? v : 0.0f;
  }
  sync();
  int levels = 0;
  while ((1 << levels) < P) ++levels;

  // forward reduction, in place: the even positions 2k s take the reduced
  // right-hand side, the odd ones (2k + 1) s keep their bo
  for (int l = 0; l < levels; ++l) {
    const int m = P >> (l + 1), s = 1 << l, off = P - 2 * m;
    for (int it = tid; it < m * cw; it += n_threads) {
      const int k = it / cw, c = it % cw;
      if (c0 + c >= a.C) continue;
      float bo[6], t[6], u[6], xe[6];
      float* pe = at(2 * k * s, c);
      load6(at((2 * k + 1) * s, c), cw, bo);
      load6(pe, cw, xe);
      mv(Do_inv + 36 * (off + k), bo, t);
      mv(L + 36 * (off + k), t, u);
#pragma unroll
      for (int i = 0; i < 6; ++i) xe[i] = __fsub_rn(xe[i], u[i]);
      if (k > 0) {
        float bp[6], tp[6], w[6];
        load6(at((2 * k - 1) * s, c), cw, bp);
        mv(Do_inv + 36 * (off + k - 1), bp, tp);
        mtv(R + 36 * (off + k - 1), tp, w);
#pragma unroll
        for (int i = 0; i < 6; ++i) xe[i] = __fsub_rn(xe[i], w[i]);
      }
      store6(pe, cw, xe);
    }
    sync();
  }

  if (tid < cw && c0 + tid < a.C) {
    float v[6], y[6];
    float* p = at(0, tid);
    load6(p, cw, v);
    mv(root, v, y);
    store6(p, cw, y);
  }
  sync();

  // back substitution: each odd position from its even neighbours
  for (int l = levels - 1; l >= 0; --l) {
    const int m = P >> (l + 1), s = 1 << l, off = P - 2 * m;
    for (int it = tid; it < m * cw; it += n_threads) {
      const int k = it / cw, c = it % cw;
      if (c0 + c >= a.C) continue;
      float xe[6], rhs[6], u[6], xo[6];
      float* po = at((2 * k + 1) * s, c);
      load6(at(2 * k * s, c), cw, xe);
      load6(po, cw, rhs);
      mtv(L + 36 * (off + k), xe, u);
#pragma unroll
      for (int i = 0; i < 6; ++i) rhs[i] = __fsub_rn(rhs[i], u[i]);
      if (k < m - 1) {
        float xn[6], w[6];
        load6(at((2 * k + 2) * s, c), cw, xn);
        mv(R + 36 * (off + k), xn, w);
#pragma unroll
        for (int i = 0; i < 6; ++i) rhs[i] = __fsub_rn(rhs[i], w[i]);
      }
      mv(Do_inv + 36 * (off + k), rhs, xo);
      store6(po, cw, xo);
    }
    sync();
  }

  // each block writes its own positions (no remote read after the barrier)
  for (int e = threadIdx.x; e < Pb * 6 * cw; e += blockDim.x) {
    const int pos = rank * Pb + e / (6 * cw), col = c0 + e % cw;
    if (pos >= a.n || col >= a.C) continue;
    const bool keep = !a.mask_out || free_mask[pos];
    a.out[(size_t(pos) * 6 + e / cw % 6) * a.C + col] = keep ? xs[e] : 0.0f;
  }
}

}  // namespace

// Do_inv, L, R [P - 1, 6, 6] and root [6, 6], b and out
// [n, 6, C] (row-major), free_mask [n] or null; P a power of two >= n.
extern "C" int scaloam_chain_solve(const float* Do_inv, const float* L, const float* R,
                                   const float* root, int P, const float* b, int n, int C,
                                   const bool* free_mask, int mask_out, float* out,
                                   cudaStream_t stream) {
  if (P < 1 || (P & (P - 1)) != 0 || n < 1 || n > P || C < 1) return int(cudaErrorInvalidValue);
  if (mask_out && free_mask == nullptr) return int(cudaErrorInvalidValue);
  Args a = {Do_inv, L, R, root, b, free_mask, out, P, n, C, C < kMaxColumns ? C : kMaxColumns,
            mask_out, 0};
  int n_blocks = 1;
  long long smem = 4LL * (108LL * (P - 1) + 36) + 24LL * P * a.cw;
  if (smem <= kSmemMaxBytes) {
    a.staged = 1;
  } else {
    n_blocks = P >= kCluster ? kCluster : 1;
    while (a.cw > 1 && 24LL * a.cw * P / n_blocks > kSmemMaxBytes) a.cw /= 2;
    smem = 24LL * a.cw * P / n_blocks;
    if (smem > kSmemMaxBytes) return int(cudaErrorInvalidValue);
  }
  // Raise the dynamic shared-memory limit once per size, not on every call
  // (launches are also captured into CUDA graphs).
  static int smem_limit = 0;
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return int(err);
    smem_limit = static_cast<int>(smem);
  }
  // one block: four of its 6 P cw entries of x a thread to load (level 0
  // has a third as many items); a cluster: an item of level 0 a thread
  const long long want = 3LL * P * a.cw / n_blocks / (n_blocks == 1 ? 2 : 6);
  const int threads = static_cast<int>(want >= kMaxThreads ? kMaxThreads
                                       : want <= 32 ? 32 : (want + 31) / 32 * 32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((C + a.cw - 1) / a.cw * n_blocks), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chain_solve_kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
