// Odometry's 2-NN sweep of one query cloud against one target cloud, one
// launch a sweep: the two nearest targets of each query in three classes,
// their indices and points.
//
//   phase 1, any:    every target that passes the target mask, over tiles
//                    of tile_any targets
//   phase 2, same:   adr < 0.5 and j != excl         (want_same only)
//            other:  0.5 <= adr <= nearby            over tiles of tile_ring
//   where adr = |ring[j] - ring_ref|, and ring_ref and excl are the ring and
//   the index of the query's phase-1 winner (0 and 0 where it has none).
//
// Replaces no Pallas kernel: the reference sweeps in XLA
// (scaloam_tpu/models/odometry.py `_sweep_candidates` over
// scaloam_tpu/ops/voxel.py `knn2_payload` and scaloam_tpu/ops/correspond.py
// `ring_constrained_nn2_pts`). In the port each tile of those sweeps was
// csrc/f32ops.cu's sq_dist writing the whole [Q, tile] distance block, then
// a mask select for each class, the ring compares, and voxel.tile_top2 a
// class (an ArgMin, a copy of the block for the out-of-place scatter of the
// winner, a second ArgMin), then voxel.merge_top2: ~28 B of device traffic
// a pair for the any class and ~93 B for the ring classes. Here the
// distances, the masks and the running top-2s stay in registers.
//
// Results equal the plain composition (scaloam_tpu_torch/ops/kernels/
// sweep_top2.py `sweep_top2_plain`) bit for bit, ties and empty slots
// included:
// - each distance is sq_dist's chain: the squared norms and the dot product
//   as fused multiply-adds over x, y, z, then (|q|^2 + |t|^2) - 2 q.t, one
//   rounding a step (fma(-2, c, s) is s - 2c rounded once: 2c is exact);
// - within a tile the winners are the lexicographic top-2 by (distance,
//   index) over the pairs that pass; a slot no passing pair fills holds
//   (BIG, the tile's first index), as ArgMin over BIG gives; distances of
//   passing pairs are finite and below BIG (coordinates below ~1e14);
// - tiles merge into the running best by merge_top2's rule, in tile order,
//   from (BIG, -1) x 2. A staged chunk of targets that all fail the target
//   mask leaves every slot as it was, so its pairs are skipped.
//
// Work: each query's pairs are split over kLanes lanes (a lane takes every
// kLanes-th target of a tile, in ascending order, so a strict compare keeps
// the lower index); at a tile's end the lanes' top-2s merge by warp
// shuffles. Targets are staged a chunk at a time into shared memory with
// their squared norms, the ring (NaN where masked) beside them. Bound on the
// card: the instructions, ~11 a pair in phase 1 and ~17 in phase 2, ~1.2e10
// a batched frame of 8 kitti_hdl64 sequences (1536 x 32768 and 768 x 4096
// pairs a sequence), ~0.4 ms at the card's instruction rate. The bytes are the
// points read, 24 a target a block of queries (from L2), and the indices
// and points written.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;  // targets staged in shared memory at a time
constexpr float kBig = 1e30f;  // voxel.BIG
constexpr unsigned kFull = 0xffffffffu;

struct Top2 {
  float d1;
  int i1;
  float d2;
  int i2;
};

__device__ __forceinline__ float sum3_sq(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// sq_dist_kernel's (|q|^2 + |t|^2) - 2 q.t; p holds x, y, z and |t|^2.
__device__ __forceinline__ float dist(float qx, float qy, float qz, float qq, float4 p) {
  const float c = __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fmaf_rn(-2.0f, c, __fadd_rn(qq, p.w));
}

// A lane visits its targets in ascending index order: on equal distances
// the one it holds has the lower index and stays.
__device__ __forceinline__ void push(Top2& s, float d, int j) {
  if (d < s.d2) {
    if (d < s.d1) {
      s.d2 = s.d1;
      s.i2 = s.i1;
      s.d1 = d;
      s.i1 = j;
    } else {
      s.d2 = d;
      s.i2 = j;
    }
  }
}

__device__ __forceinline__ bool before(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// The lexicographic top-2 of the kLanes lanes' top-2s, in every lane.
template <int kLanes>
__device__ __forceinline__ void merge_lanes(Top2& s) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float od1 = __shfl_xor_sync(kFull, s.d1, off);
    const int oi1 = __shfl_xor_sync(kFull, s.i1, off);
    const float od2 = __shfl_xor_sync(kFull, s.d2, off);
    const int oi2 = __shfl_xor_sync(kFull, s.i2, off);
    if (before(od1, oi1, s.d1, s.i1)) {
      if (before(od2, oi2, s.d1, s.i1)) {
        s.d2 = od2;
        s.i2 = oi2;
      } else {
        s.d2 = s.d1;
        s.i2 = s.i1;
      }
      s.d1 = od1;
      s.i1 = oi1;
    } else if (before(od1, oi1, s.d2, s.i2)) {
      s.d2 = od1;
      s.i2 = oi1;
    }
  }
}

// voxel.merge_top2(best, tile): on equal distances the running best's first
// stays, and its loser ties with the winner's second to that second.
__device__ __forceinline__ void merge_running(Top2& b, const Top2& v) {
  const bool t = v.d1 < b.d1;
  const float l1d = t ? b.d1 : v.d1;
  const int l1i = t ? b.i1 : v.i1;
  const float o2d = t ? v.d2 : b.d2;
  const int o2i = t ? v.i2 : b.i2;
  if (t) {
    b.d1 = v.d1;
    b.i1 = v.i1;
  }
  const bool s = l1d < o2d;
  b.d2 = s ? l1d : o2d;
  b.i2 = s ? l1i : o2i;
}

// Stage targets [c0, c0 + n) with their squared norms; true where any passes
// the mask. Ends with a barrier.
__device__ __forceinline__ bool stage(const float* __restrict__ t, const uint8_t* __restrict__ m,
                                      const float* __restrict__ r, int c0, int n,
                                      float4* s_pt, float* s_ring) {
  int any = 0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int j = c0 + k;
    const float x = t[3 * j], y = t[3 * j + 1], z = t[3 * j + 2];
    s_pt[k] = make_float4(x, y, z, sum3_sq(x, y, z));
    const bool ok = m[j] != 0;
    s_ring[k] = ok ? r[j] : __int_as_float(0x7fc00000);
    any |= ok;
  }
  return __syncthreads_or(any) != 0;
}

// One phase over all T targets in tiles of `tile`: reset(t0) at a tile's
// start, visit(k, j) for this lane's staged targets (k in the chunk, j in
// the cloud), close() at a tile's end. Every loop bound but the lane's own
// is uniform over the block.
template <int kLanes, class Reset, class Visit, class Close>
__device__ __forceinline__ void sweep(const float* __restrict__ t, const uint8_t* __restrict__ m,
                                      const float* __restrict__ r, int T, int tile, int lane,
                                      float4* s_pt, float* s_ring, Reset reset, Visit visit,
                                      Close close) {
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, T);
    __syncthreads();  // the previous chunk is read
    const bool any = stage(t, m, r, c0, c1 - c0, s_pt, s_ring);
    for (int s0 = c0; s0 < c1;) {
      const int te = min((s0 / tile + 1) * tile, T);
      const int s1 = min(te, c1);
      if (s0 % tile == 0) reset(s0);
      if (any) {
#pragma unroll 4
        for (int j = s0 + lane; j < s1; j += kLanes) visit(j - c0, j);
      }
      if (s1 == te) close();
      s0 = s1;
    }
  }
}

template <int kLanes, bool kWantSame>
__global__ void __launch_bounds__(kThreads)
sweep_top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const uint8_t* __restrict__ m, const float* __restrict__ r, int Q, int T,
                  int tile_any, int tile_ring, float nearby, int64_t* __restrict__ idx,
                  float* __restrict__ pts) {
  constexpr int kClasses = kWantSame ? 3 : 2;
  __shared__ float4 s_pt[kChunk];
  __shared__ float s_ring[kChunk];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int qi = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const bool real = qi < Q;
  q += size_t(b) * Q * 3;
  t += size_t(b) * T * 3;
  m += size_t(b) * T;
  r += size_t(b) * T;
  idx += size_t(b) * kClasses * Q * 2;
  pts += size_t(b) * kClasses * Q * 6;
  const int qc = real ? qi : Q - 1;  // a block's spare queries run along
  const float qx = q[3 * qc], qy = q[3 * qc + 1], qz = q[3 * qc + 2];
  const float qq = sum3_sq(qx, qy, qz);

  auto write = [&](int c, const Top2& w) {
    if (!real || lane != 0) return;
    const size_t o = size_t(c) * Q + qi;
    const int wi[2] = {w.i1, w.i2};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      idx[2 * o + k] = wi[k];
#pragma unroll
      for (int a = 0; a < 3; ++a) pts[6 * o + 3 * k + a] = wi[k] >= 0 ? t[3 * wi[k] + a] : 0.0f;
    }
  };

  Top2 win_any = {kBig, -1, kBig, -1}, lane_any;
  sweep<kLanes>(
      t, m, r, T, tile_any, lane, s_pt, s_ring,
      [&](int t0) { lane_any = {kBig, t0, kBig, t0}; },
      [&](int k, int j) {
        const float rg = s_ring[k];
        const float d = dist(qx, qy, qz, qq, s_pt[k]);
        if (rg == rg) push(lane_any, d, j);
      },
      [&]() {
        merge_lanes<kLanes>(lane_any);
        merge_running(win_any, lane_any);
      });
  write(0, win_any);

  // The odometry's payload row of the 1-NN: its ring and index, 0 and 0
  // where it has none.
  const float ring_ref = win_any.i1 >= 0 ? r[win_any.i1] : 0.0f;
  const int excl = max(win_any.i1, 0);
  Top2 win_same = {kBig, -1, kBig, -1}, win_other = win_same, lane_same, lane_other;
  sweep<kLanes>(
      t, m, r, T, tile_ring, lane, s_pt, s_ring,
      [&](int t0) { lane_same = lane_other = {kBig, t0, kBig, t0}; },
      [&](int k, int j) {
        const float adr = fabsf(__fsub_rn(s_ring[k], ring_ref));  // NaN where masked
        const float d = dist(qx, qy, qz, qq, s_pt[k]);
        if (kWantSame && adr < 0.5f && j != excl) push(lane_same, d, j);
        if (adr >= 0.5f && adr <= nearby) push(lane_other, d, j);
      },
      [&]() {
        if (kWantSame) {
          merge_lanes<kLanes>(lane_same);
          merge_running(win_same, lane_same);
        }
        merge_lanes<kLanes>(lane_other);
        merge_running(win_other, lane_other);
      });
  if (kWantSame) write(1, win_same);
  write(kClasses - 1, win_other);
}

template <int kLanes>
int launch(const float* q, const float* t, const uint8_t* m, const float* r, int B, int Q, int T,
           int tile_any, int tile_ring, float nearby, bool want_same, int64_t* idx, float* pts,
           cudaStream_t stream) {
  const dim3 grid((Q + kThreads / kLanes - 1) / (kThreads / kLanes), B);
  if (want_same)
    sweep_top2_kernel<kLanes, true><<<grid, kThreads, 0, stream>>>(
        q, t, m, r, Q, T, tile_any, tile_ring, nearby, idx, pts);
  else
    sweep_top2_kernel<kLanes, false><<<grid, kThreads, 0, stream>>>(
        q, t, m, r, Q, T, tile_any, tile_ring, nearby, idx, pts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query [B, Q, 3], target [B, T, 3], mask [B, T] (bool), ring [B, T];
// idx [B, C, Q, 2] (int64) and pts [B, C, Q, 2, 3] for the C = 2 + want_same
// classes any, (same,) other. lanes: 8, 16 or 32 a query.
extern "C" int scaloam_sweep_top2(const void* query, const void* target, const void* mask,
                                  const void* ring, int B, int Q, int T, int tile_any,
                                  int tile_ring, float nearby, int want_same, int lanes, void* idx,
                                  void* pts, void* stream) {
  if (B <= 0 || Q <= 0) return 0;
  if (tile_any <= 0 || tile_ring <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const float*>(query);
  const auto* t = static_cast<const float*>(target);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* r = static_cast<const float*>(ring);
  auto* i = static_cast<int64_t*>(idx);
  auto* p = static_cast<float*>(pts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8:
      return launch<8>(q, t, m, r, B, Q, T, tile_any, tile_ring, nearby, want_same, i, p, s);
    case 16:
      return launch<16>(q, t, m, r, B, Q, T, tile_any, tile_ring, nearby, want_same, i, p, s);
    case 32:
      return launch<32>(q, t, m, r, B, Q, T, tile_any, tile_ring, nearby, want_same, i, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
