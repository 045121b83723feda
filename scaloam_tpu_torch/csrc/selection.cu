// Greedy curvature feature selection, one thread block per ring row.
//
// Replaces the TPU kernel scaloam_tpu/ops/pallas/selection.py:select_features
// (body _make_kernel). Semantics per row: n_corner rounds, each taking the
// subregions s = 0..nsub-1 in order; a pick is the argmax of curv among
// eligible, unsuppressed points of [sp[s], ep[s]] with curv > thr (ties to
// the lowest index) and suppresses the band [j - left[j], j + right[j]]. Then
// n_flat rounds of argmin over curv < thr; the last flat round suppresses
// nothing. Corner picks set labels. A pick that finds nothing returns index 0,
// ok false.
//
// The Pallas kernel keeps a per-round candidate array `val` beside the
// suppression mask. Every band that strikes `val` also sets the mask (and the
// last flat round changes neither), so "eligible & not suppressed now &
// threshold" equals `val` at every pick: one flag byte per point suffices.
//
// Bound on the card: ~3 MB moved at full width (64 x 2304), under 1 us at
// 3.35 TB/s; the real limit is the chain of 144 dependent picks per row.
// Design: rows are independent, so one block per row keeps the whole row
// (curv, reach, flags, labels: 14 B per point) in shared memory; each pick
// scans only its subregion and is one block-wide (value, index) reduction,
// warp shuffles then one shared-memory pass.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Best {
  float v;
  int j;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(0xffffffffu, b.v, off);
    o.j = __shfl_down_sync(0xffffffffu, b.j, off);
    b = better(b, o);
  }
  return b;
}

// Block-wide (max value, lowest index). Every thread gets the result.
__device__ Best block_best(Best b, Best* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  b = warp_best(b);
  if (lane == 0) red[warp] = b;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    Best w = lane < nw ? red[lane] : Best{kNeg, INT_MAX};
    w = warp_best(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kThreads) select_kernel(
    const float* __restrict__ curv, const int* __restrict__ left,
    const int* __restrict__ right, const uint8_t* __restrict__ elig,
    const int* __restrict__ sp, const int* __restrict__ ep, int W, int nsub,
    int n_corner, int n_flat, float thr, int* __restrict__ corner_idx,
    uint8_t* __restrict__ corner_ok, int* __restrict__ flat_idx,
    uint8_t* __restrict__ flat_ok, uint8_t* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_curv = reinterpret_cast<float*>(smem);
  int* s_left = reinterpret_cast<int*>(s_curv + W);
  int* s_right = s_left + W;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_right + W);  // 1 eligible, 2 suppressed
  uint8_t* s_label = s_flag + W;
  __shared__ Best red[33];

  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    s_curv[j] = curv[off + j];
    s_left[j] = left[off + j];
    s_right[j] = right[off + j];
    s_flag[j] = elig[off + j] ? 1 : 0;
    s_label[j] = 0;
  }
  __syncthreads();

  const int n_rounds = n_corner + n_flat;
  for (int p = 0; p < n_rounds; ++p) {
    const bool corner = p < n_corner;
    const bool suppress = corner || (p - n_corner) < n_flat - 1;
    for (int s = 0; s < nsub; ++s) {
      const int lo = max(sp[row * nsub + s], 0);
      const int hi = min(ep[row * nsub + s], W - 1);
      Best b{kNeg, INT_MAX};
      for (int j = lo + threadIdx.x; j <= hi; j += blockDim.x) {
        if (s_flag[j] != 1) continue;  // not eligible, or suppressed
        const float c = s_curv[j];
        if (corner ? !(c > thr) : !(c < thr)) continue;
        b = better(b, Best{corner ? c : -c, j});
      }
      b = block_best(b, red);
      const bool found = b.v > kNeg;
      const int jstar = found ? b.j : 0;
      if (found && suppress) {
        const int blo = max(jstar - max(s_left[jstar], 0), 0);
        const int bhi = min(jstar + max(s_right[jstar], 0), W - 1);
        for (int j = blo + threadIdx.x; j <= bhi; j += blockDim.x) s_flag[j] |= 2;
      }
      if (threadIdx.x == 0) {
        if (corner) {
          const int o = (row * nsub + s) * n_corner + p;
          corner_idx[o] = jstar;
          corner_ok[o] = found;
          if (found) s_label[jstar] = 1;
        } else {
          const int o = (row * nsub + s) * n_flat + (p - n_corner);
          flat_idx[o] = jstar;
          flat_ok[o] = found;
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < W; j += blockDim.x) labels[off + j] = s_label[j];
}

}  // namespace

extern "C" int scaloam_select_features(
    const void* curv, const void* left, const void* right, const void* elig,
    const void* sp, const void* ep, int S, int W, int nsub, int n_corner,
    int n_flat, float thr, void* corner_idx, void* corner_ok, void* flat_idx,
    void* flat_ok, void* labels, void* stream) {
  const int smem = 14 * W;  // curv, left, right (4 B each), flags, labels
  // Raise the kernel's dynamic shared-memory limit once per size (not on
  // every call, so launches can also be captured into a CUDA graph).
  static int smem_limit = 48 * 1024;
  if (smem > smem_limit) {
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem;
  }
  select_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(curv), static_cast<const int*>(left),
      static_cast<const int*>(right), static_cast<const uint8_t*>(elig),
      static_cast<const int*>(sp), static_cast<const int*>(ep), W, nsub,
      n_corner, n_flat, thr, static_cast<int*>(corner_idx),
      static_cast<uint8_t*>(corner_ok), static_cast<int*>(flat_idx),
      static_cast<uint8_t*>(flat_ok), static_cast<uint8_t*>(labels));
  return static_cast<int>(cudaGetLastError());
}
