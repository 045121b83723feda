// Gauss-Newton pose solves, one thread-block cluster a problem: a shared GN
// core over prepared point-to-line and point-to-plane factors, and two entry
// points, each over a batch of problems.
//
// Entry A, scaloam_gn_odometry_batched, replaces the TPU kernel
// scaloam_tpu/ops/pallas/gn_odometry.py:associate_and_solve (body
// _make_kernel): per outer pass, re-rank the two cached candidates of every
// class at the current pose (gate d^2 < thr), prepare the factors (the edge
// endpoints a, b; the 3-point plane's unit normal n and offset, once per
// pass), then run gn_iters GN iterations with the correspondences frozen.
// Returns the pose and the valid counts of the last pass.
//
// Entry B, scaloam_gn_solve_prepared_batched, replaces the scan-to-map GN loop of
// scaloam_tpu/models/mapping.py:187 (scaloam_tpu/ops/gn.py:gauss_newton over
// residuals.edge_factors_from_prep and plane_norm_factors_T): the GN core
// alone over factors the caller prepared.
//
// GN core, per iteration: the point-to-line residuals (p'-a)x(p'-b)/|a-b| and
// the plane residuals n.p' + d with their Jacobians, Huber(delta) weights,
// the 21 upper-triangle entries of J^T W J and the 6 of J^T W r summed over
// all valid factors (invalid rows are skipped, not multiplied by 0: the
// mapping's degenerate fits carry NaN), the diagonal damped by
// damping*max(diag, 1e-8), an unrolled 6x6 Cholesky solve and the update
// q <- normalize(q * Exp(dtheta)), t <- t + dt.
//
// Bound on the card: ~180 KB (entry A, 768 corner + 1536 surf points) or
// ~270 KB (entry B, 2048 + 6656 factors) read once and a few MFLOP: well
// under 1 us either way. What limits it is latency: gn_iters dependent
// reductions per pass, each followed by a scalar 6x6 solve. Design:
//  - One cluster of C <= 8 blocks per problem (the host picks C from the
//    point counts: about one point per thread, and enough blocks for each
//    slice to fit in shared memory); each block owns a contiguous slice of
//    the corner and of the surf points. A batch of B problems (the Pallas
//    kernel under jax.vmap: a leading grid axis) is one launch of B
//    clusters, gridDim = B * C, cluster i solving problem i at a per-problem
//    stride into every array; C is the same for the whole batch (the
//    capacities are static), and clusters past what the card holds at once
//    (scaloam_gn_max_active_clusters) run in waves. A problem's result does
//    not depend on the batch around it.
//  - Inputs are staged into shared memory once per launch by bulk
//    asynchronous copies (cp.async.bulk global->shared, completing on an
//    mbarrier); the GN iterations touch no global memory. Each thread owns a
//    fixed stride of its block's points, so the association it writes is
//    read back by the same thread without a barrier.
//  - Reduction: the 27 sums (and 2 valid counts in spare slots) fold within
//    each warp by a transposed butterfly (31 shuffle-adds for 32 slots),
//    then across warps through shared memory. Warp 0 of each block writes
//    its block's partials into every block's double-buffered inbox (slot
//    [parity][rank]) through distributed shared memory
//    (cluster.map_shared_rank), one cluster.sync(), and each block sums its
//    own inbox in rank order. So every block holds bit-identical sums, the
//    result does not change from run to run, and no shared-memory read
//    crosses SMs (remote stores are posted before the barrier).
//  - Warp 0 of every block then solves the damped system and updates the
//    pose (all lanes alike, in registers) and publishes it to its block
//    through shared memory: no pose crosses blocks, no single-thread
//    hand-off. Divisions become reciprocal multiplies (rounding differs from
//    the plain version's divisions within the tolerances).
//  - A final cluster.sync() keeps every block resident until all are done.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSlots = 32;      // 21 J^T W J + 6 J^T W r, 2 counts, 3 spare
constexpr int kCountSlot = 27;
constexpr size_t kSmemBudget = 220 * 1024;  // of 227 KB, beside the static arrays
constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ math

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 div(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }

struct Rot {
  float m[3][3];
};

// se3.quat_to_mat on a wxyz quaternion.
__device__ Rot rot_from_quat(const float (&q)[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  Rot R;
  R.m[0][0] = 1 - 2 * (yy + zz); R.m[0][1] = 2 * (xy - wz); R.m[0][2] = 2 * (xz + wy);
  R.m[1][0] = 2 * (xy + wz); R.m[1][1] = 1 - 2 * (xx + zz); R.m[1][2] = 2 * (yz - wx);
  R.m[2][0] = 2 * (xz - wy); R.m[2][1] = 2 * (yz + wx); R.m[2][2] = 1 - 2 * (xx + yy);
  return R;
}

__device__ __forceinline__ V3 apply_R(const Rot& R, V3 v) {
  return {R.m[0][0] * v.x + R.m[0][1] * v.y + R.m[0][2] * v.z,
          R.m[1][0] * v.x + R.m[1][1] * v.y + R.m[1][2] * v.z,
          R.m[2][0] * v.x + R.m[2][1] * v.y + R.m[2][2] * v.z};
}

__device__ __forceinline__ V3 apply_RT(const Rot& R, V3 v) {
  return {R.m[0][0] * v.x + R.m[1][0] * v.y + R.m[2][0] * v.z,
          R.m[0][1] * v.x + R.m[1][1] * v.y + R.m[2][1] * v.z,
          R.m[0][2] * v.x + R.m[1][2] * v.y + R.m[2][2] * v.z};
}

__device__ __forceinline__ V3 col(const Rot& R, int k) { return {R.m[0][k], R.m[1][k], R.m[2][k]}; }

// Nearer of two cached candidates c[0..2], c[3..5]: returns d^2 and the
// chosen point (the second only when strictly nearer).
__device__ __forceinline__ float pick_nearer(V3 pw, const float* c, V3* chosen) {
  const V3 c0 = load3(c), c1 = load3(c + 3);
  const V3 e0 = sub(pw, c0), e1 = sub(pw, c1);
  const float d0 = dot(e0, e0), d1 = dot(e1, e1);
  *chosen = d1 < d0 ? c1 : c0;
  return fminf(d0, d1);
}

__device__ __forceinline__ float huber_w(float s, float delta, float delta_sq) {
  return s <= delta_sq ? 1.0f : delta * rsqrtf(fmaxf(s, 1e-20f));
}

// Adds w * J_i . J_j (i <= j) and w * J_i . r to acc; J has R rows of 6.
template <int R>
__device__ __forceinline__ void accumulate(float (&acc)[kSlots], const float (&J)[6][R],
                                           const float (&r)[R], float w) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) s += J[i][c] * J[j][c];
      acc[k++] += w * s;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < R; ++c) s += J[i][c] * r[c];
    acc[k++] += w * s;
  }
}

// gn.cholesky_solve6: A x = b, pivots clamped at 1e-20.
__device__ void chol6_solve(const float (&A)[6][6], const float (&b)[6], float (&x)[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    inv[j] = rsqrtf(fmaxf(s, 1e-20f));  // 1 / L[j][j]
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// gn.solve_step + gn.apply_delta from the reduced sums, in registers.
__device__ void solve_and_update(const float (&tot)[kSlots], float damping, float (&q)[4],
                                 float (&t)[3]) {
  float A[6][6], g[6], x[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) { A[i][j] = tot[k]; A[j][i] = tot[k]; ++k; }
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = -tot[k + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) A[i][i] += damping * fmaxf(A[i][i], 1e-8f);
  chol6_solve(A, g, x);
  // exp_so3
  const float t2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  const bool small = t2 < 1e-12f;
  const float theta = sqrtf(small ? 1.0f : t2);
  float sh, ch;
  sincosf(0.5f * theta, &sh, &ch);
  const float kk = small ? 0.5f - t2 * (1.0f / 48.0f) : sh / theta;
  const float cw = small ? 1.0f - t2 * 0.125f : ch;
  const float dq[4] = {cw, kk * x[0], kk * x[1], kk * x[2]};
  const float aw = q[0], ax = q[1], ay = q[2], az = q[3];
  const float n[4] = {
      aw * dq[0] - ax * dq[1] - ay * dq[2] - az * dq[3],
      aw * dq[1] + ax * dq[0] + ay * dq[3] - az * dq[2],
      aw * dq[2] - ax * dq[3] + ay * dq[0] + az * dq[1],
      aw * dq[3] + ax * dq[2] - ay * dq[1] + az * dq[0],
  };
  const float qn = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2] + n[3] * n[3]), kEps);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = n[i] / qn;
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] += x[3 + i];
}

// ------------------------------------------------------------ reduction

// One step of the transposed butterfly: lanes exchange the half of their
// N live slots that the partner keeps. After the folds for N = 32..2, lane
// l holds the warp's sum of slot l in v[0].
template <int N>
__device__ __forceinline__ void fold(float (&v)[kSlots], int lane) {
  const bool upper = lane & (N / 2);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, N / 2);
  }
}

struct Reducer {
  float (*red)[kSlots];                   // [kWarps][kSlots] warp sums
  float (*inbox)[kMaxCluster][kSlots];    // [2][kMaxCluster][kSlots] by parity, rank
  float* pose;                            // [8]: q, t published by warp 0
  int parity;
};

// One GN step over the cluster: sums v over every thread of the cluster in
// a fixed order, then warp 0 solves and updates (q, t), which every thread
// of the block holds on return. The first step's count slots go to counts
// (in warp 0).
__device__ void reduce_and_step(float (&v)[kSlots], Reducer& rd, const cg::cluster_group& cluster,
                                float damping, float (&q)[4], float (&t)[3], bool first,
                                float (&counts)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  fold<32>(v, lane);
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  rd.red[warp][lane] = v[0];
  __syncthreads();
  const int n = static_cast<int>(cluster.num_blocks());
  float (*inbox)[kSlots] = rd.inbox[rd.parity];
  if (warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rd.red[w][lane];
    float* mine = inbox[cluster.block_rank()];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) cluster.map_shared_rank(mine, r)[lane] = s;
  }
  cluster.sync();
  if (warp == 0) {
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) tot += inbox[r][lane];
    float sums[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) sums[k] = __shfl_sync(kFull, tot, k);
    if (first) {
      counts[0] = sums[kCountSlot];
      counts[1] = sums[kCountSlot + 1];
    }
    solve_and_update(sums, damping, q, t);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) rd.pose[i] = q[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) rd.pose[4 + i] = t[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = rd.pose[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = rd.pose[4 + i];
  rd.parity ^= 1;
}

// ------------------------------------------------------------- GN core

// Prepared factors of this block's slice, in shared memory ([n, 3] rows).
struct Factors {
  const float *cp, *ca, *cb;  // corner point, line endpoints
  const uint8_t* cv;
  int nc;
  const float *sp, *sn, *sd;  // surf point, unit normal, offset (neg_d)
  const uint8_t* sv;
  int ns;
};

// gn_iters GN iterations over the cluster's factors. counts[0..1] (corner,
// surf) are summed with the first iteration's sums and returned in counts.
__device__ void gn_core(const Factors& f, float (&q)[4], float (&t)[3], int gn_iters,
                        float delta, float delta_sq, float damping, float (&counts)[2],
                        Reducer& rd, const cg::cluster_group& cluster) {
  for (int it = 0; it < gn_iters; ++it) {
    const Rot R = rot_from_quat(q);
    const V3 tv = {t[0], t[1], t[2]};
    float acc[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;
    if (it == 0) {
      acc[kCountSlot] = counts[0];
      acc[kCountSlot + 1] = counts[1];
    }

    for (int i = threadIdx.x; i < f.nc; i += kThreads) {
      if (!f.cv[i]) continue;
      const V3 a = load3(f.ca + 3 * i), b = load3(f.cb + 3 * i);
      const V3 d = sub(a, b);
      const float inv = 1.0f / fmaxf(sqrtf(dot(d, d)), kEps);  // 1 / |a - b|
      const V3 w3 = apply_R(R, load3(f.cp + 3 * i));
      const V3 pw = {w3.x + tv.x, w3.y + tv.y, w3.z + tv.z};
      const V3 rv = scale(cross(sub(pw, a), sub(pw, b)), inv);
      const V3 e = scale(d, inv);
      float J[6][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const V3 jr = cross(cross(col(R, k), w3), e);
        J[k][0] = jr.x; J[k][1] = jr.y; J[k][2] = jr.z;
      }
      // translation block: column k is e_k x (d / |d|)
      J[3][0] = 0.f;   J[3][1] = -e.z; J[3][2] = e.y;
      J[4][0] = e.z;   J[4][1] = 0.f;  J[4][2] = -e.x;
      J[5][0] = -e.y;  J[5][1] = e.x;  J[5][2] = 0.f;
      const float r[3] = {rv.x, rv.y, rv.z};
      accumulate<3>(acc, J, r, huber_w(dot(rv, rv), delta, delta_sq));
    }

    for (int i = threadIdx.x; i < f.ns; i += kThreads) {
      if (!f.sv[i]) continue;
      const V3 nrm = load3(f.sn + 3 * i);
      const V3 p = load3(f.sp + 3 * i);
      const V3 w3 = apply_R(R, p);
      const V3 pw = {w3.x + tv.x, w3.y + tv.y, w3.z + tv.z};
      const float rs = dot(nrm, pw) + f.sd[i];
      const V3 jrot = cross(p, apply_RT(R, nrm));
      const float J[6][1] = {{jrot.x}, {jrot.y}, {jrot.z}, {nrm.x}, {nrm.y}, {nrm.z}};
      const float r[1] = {rs};
      accumulate<1>(acc, J, r, huber_w(rs * rs, delta, delta_sq));
    }

    reduce_and_step(acc, rd, cluster, damping, q, t, it == 0, counts);
  }
}

// -------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Copy {
  unsigned char* dst;  // shared
  const unsigned char* src;  // global
  uint32_t n;
};

// Bytes of c that go by bulk copy: both ends 16-aligned, a multiple of 16.
__device__ __forceinline__ uint32_t bulk_bytes(const Copy& c) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(c.dst) | reinterpret_cast<uintptr_t>(c.src)) & 15) == 0;
  return aligned ? (c.n & ~15u) : 0u;
}

// Copies every c.src into c.dst: thread 0 issues one cp.async.bulk per array
// completing on *bar; all threads copy the tails (and any misaligned array)
// byte by byte. On return the whole block sees every byte.
template <int N>
__device__ void stage(const Copy (&cs)[N], uint64_t* bar) {
  const uint32_t bar_s = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) total += bulk_bytes(cs[i]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s), "r"(total)
                 : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t b = bulk_bytes(cs[i]);
      if (b)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(cs[i].dst)),
            "l"(cs[i].src), "r"(b), "r"(bar_s)
            : "memory");
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (uint32_t k = bulk_bytes(cs[i]) + threadIdx.x; k < cs[i].n; k += kThreads)
      cs[i].dst[k] = cs[i].src[k];
  __syncthreads();  // the barrier is initialised; the tails are written
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_s), "r"(0u)
        : "memory");
  }
}

// ------------------------------------------------------------- layouts

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }
__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o += align16(n);
  return at;
}

// Points per block: ceil(n / C) rounded up to 16, so every slice starts
// 16-byte aligned in every array.
__host__ __device__ inline int chunk_of(int n, int C) { return ((n + C - 1) / C + 15) / 16 * 16; }

// Entry A, per block (cc corner, cs surf points): the raw inputs, then the
// prepared factors written by the association.
struct LayoutA {
  size_t c_xyz, c_any, c_oth, c_mask, s_xyz, s_any, s_same, s_oth, s_mask;
  size_t c_a, c_b, c_v, s_n, s_d, s_v, total;
  __host__ __device__ LayoutA(size_t cc, size_t cs) {
    size_t o = 0;
    c_xyz = take(o, 12 * cc); c_any = take(o, 24 * cc); c_oth = take(o, 24 * cc);
    c_mask = take(o, cc);
    s_xyz = take(o, 12 * cs); s_any = take(o, 24 * cs); s_same = take(o, 24 * cs);
    s_oth = take(o, 24 * cs); s_mask = take(o, cs);
    c_a = take(o, 12 * cc); c_b = take(o, 12 * cc); c_v = take(o, cc);
    s_n = take(o, 12 * cs); s_d = take(o, 4 * cs); s_v = take(o, cs);
    total = o;
  }
};

// Entry B, per block: the prepared factors.
struct LayoutB {
  size_t c_p, c_a, c_b, c_v, s_p, s_n, s_d, s_v, total;
  __host__ __device__ LayoutB(size_t cc, size_t cs) {
    size_t o = 0;
    c_p = take(o, 12 * cc); c_a = take(o, 12 * cc); c_b = take(o, 12 * cc); c_v = take(o, cc);
    s_p = take(o, 12 * cs); s_n = take(o, 12 * cs); s_d = take(o, 4 * cs); s_v = take(o, cs);
    total = o;
  }
};

struct Slice {
  int lo, n;
  __device__ Slice(int total, int C, int rank) {
    const int chunk = chunk_of(total, C);
    lo = min(rank * chunk, total);
    n = min(chunk, total - lo);
  }
};

template <typename T>
__device__ __forceinline__ Copy copy_of(unsigned char* smem, size_t off, const T* src, int lo,
                                        int n, int per_point) {
  return {smem + off, reinterpret_cast<const unsigned char*>(src) + size_t(lo) * per_point,
          static_cast<uint32_t>(n) * per_point};
}

// ------------------------------------------------------------- kernels

__global__ void __launch_bounds__(kThreads) assoc_solve_kernel(
    const float* __restrict__ c_xyz, const float* __restrict__ c_any,
    const float* __restrict__ c_oth, const uint8_t* __restrict__ c_mask, int Nc,
    const float* __restrict__ s_xyz, const float* __restrict__ s_any,
    const float* __restrict__ s_same, const float* __restrict__ s_oth,
    const uint8_t* __restrict__ s_mask, int Ns, const float* __restrict__ q0,
    const float* __restrict__ t0, int outer, int gn_iters, float thr, float delta,
    float delta_sq, float damping, float* __restrict__ q_out, float* __restrict__ t_out,
    int* __restrict__ counts_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps][kSlots], inbox[2][kMaxCluster][kSlots], pose[8];
  __shared__ __align__(8) uint64_t bar;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // This cluster's problem of the batch: every array advances by one
  // problem's extent.
  const size_t prob = blockIdx.x / C;
  c_xyz += prob * Nc * 3; c_any += prob * Nc * 6; c_oth += prob * Nc * 6; c_mask += prob * Nc;
  s_xyz += prob * Ns * 3; s_any += prob * Ns * 6; s_same += prob * Ns * 6;
  s_oth += prob * Ns * 6; s_mask += prob * Ns;
  q0 += prob * 4; t0 += prob * 3; q_out += prob * 4; t_out += prob * 3; counts_out += prob * 2;
  const Slice cs(Nc, C, rank), ss(Ns, C, rank);
  const LayoutA L(chunk_of(Nc, C), chunk_of(Ns, C));

  const Copy copies[9] = {
      copy_of(smem, L.c_xyz, c_xyz, cs.lo, cs.n, 12), copy_of(smem, L.c_any, c_any, cs.lo, cs.n, 24),
      copy_of(smem, L.c_oth, c_oth, cs.lo, cs.n, 24), copy_of(smem, L.c_mask, c_mask, cs.lo, cs.n, 1),
      copy_of(smem, L.s_xyz, s_xyz, ss.lo, ss.n, 12), copy_of(smem, L.s_any, s_any, ss.lo, ss.n, 24),
      copy_of(smem, L.s_same, s_same, ss.lo, ss.n, 24), copy_of(smem, L.s_oth, s_oth, ss.lo, ss.n, 24),
      copy_of(smem, L.s_mask, s_mask, ss.lo, ss.n, 1),
  };
  stage(copies, &bar);

  const float* sc_xyz = reinterpret_cast<const float*>(smem + L.c_xyz);
  const float* sc_any = reinterpret_cast<const float*>(smem + L.c_any);
  const float* sc_oth = reinterpret_cast<const float*>(smem + L.c_oth);
  const uint8_t* sc_mask = smem + L.c_mask;
  const float* ss_xyz = reinterpret_cast<const float*>(smem + L.s_xyz);
  const float* ss_any = reinterpret_cast<const float*>(smem + L.s_any);
  const float* ss_same = reinterpret_cast<const float*>(smem + L.s_same);
  const float* ss_oth = reinterpret_cast<const float*>(smem + L.s_oth);
  const uint8_t* ss_mask = smem + L.s_mask;
  float* fc_a = reinterpret_cast<float*>(smem + L.c_a);
  float* fc_b = reinterpret_cast<float*>(smem + L.c_b);
  uint8_t* fc_v = smem + L.c_v;
  float* fs_n = reinterpret_cast<float*>(smem + L.s_n);
  float* fs_d = reinterpret_cast<float*>(smem + L.s_d);
  uint8_t* fs_v = smem + L.s_v;
  const Factors f{sc_xyz, fc_a, fc_b, fc_v, cs.n, ss_xyz, fs_n, fs_d, fs_v, ss.n};

  float q[4] = {q0[0], q0[1], q0[2], q0[3]};
  float t[3] = {t0[0], t0[1], t0[2]};
  float counts[2] = {0.f, 0.f};
  Reducer rd{red, inbox, pose, 0};

  for (int pass = 0; pass < outer; ++pass) {
    // ---- data association at the current pose (odometry._associate),
    // then the pose-independent factor halves (odometry._solve's prep)
    const Rot R = rot_from_quat(q);
    const V3 tv = {t[0], t[1], t[2]};
    float nc = 0.f, ns = 0.f;
    for (int i = threadIdx.x; i < cs.n; i += kThreads) {
      const V3 w = apply_R(R, load3(sc_xyz + 3 * i));
      const V3 p = {w.x + tv.x, w.y + tv.y, w.z + tv.z};
      V3 a, b;
      const float dj = pick_nearer(p, sc_any + 6 * i, &a);
      const float dd = pick_nearer(p, sc_oth + 6 * i, &b);
      const bool valid = sc_mask[i] && dj < thr && dd < thr;
      store3(fc_a + 3 * i, a);
      store3(fc_b + 3 * i, b);
      fc_v[i] = valid;
      nc += valid;
    }
    for (int i = threadIdx.x; i < ss.n; i += kThreads) {
      const V3 w = apply_R(R, load3(ss_xyz + 3 * i));
      const V3 p = {w.x + tv.x, w.y + tv.y, w.z + tv.z};
      V3 pj, pl, pm;
      const float dj = pick_nearer(p, ss_any + 6 * i, &pj);
      const float dl = pick_nearer(p, ss_same + 6 * i, &pl);
      const float dm = pick_nearer(p, ss_oth + 6 * i, &pm);
      const bool valid = ss_mask[i] && dj < thr && dl < thr && dm < thr;
      V3 nrm = cross(sub(pj, pl), sub(pj, pm));
      nrm = div(nrm, fmaxf(sqrtf(dot(nrm, nrm)), kEps));
      store3(fs_n + 3 * i, nrm);
      fs_d[i] = -dot(pj, nrm);
      fs_v[i] = valid;
      ns += valid;
    }
    counts[0] = nc;
    counts[1] = ns;
    gn_core(f, q, t, gn_iters, delta, delta_sq, damping, counts, rd, cluster);
  }
  if (rank == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) q_out[i] = q[i];
    for (int i = 0; i < 3; ++i) t_out[i] = t[i];
    counts_out[0] = outer > 0 ? static_cast<int>(counts[0]) : 0;
    counts_out[1] = outer > 0 ? static_cast<int>(counts[1]) : 0;
  }
  cluster.sync();
}

__global__ void __launch_bounds__(kThreads) prepared_solve_kernel(
    const float* __restrict__ c_p, const float* __restrict__ c_a,
    const float* __restrict__ c_b, const uint8_t* __restrict__ c_v, int Nc,
    const float* __restrict__ s_p, const float* __restrict__ s_n,
    const float* __restrict__ s_d, const uint8_t* __restrict__ s_v, int Ns,
    const float* __restrict__ q0, const float* __restrict__ t0, int gn_iters, float delta,
    float delta_sq, float damping, float* __restrict__ q_out, float* __restrict__ t_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps][kSlots], inbox[2][kMaxCluster][kSlots], pose[8];
  __shared__ __align__(8) uint64_t bar;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t prob = blockIdx.x / C;  // as in assoc_solve_kernel
  c_p += prob * Nc * 3; c_a += prob * Nc * 3; c_b += prob * Nc * 3; c_v += prob * Nc;
  s_p += prob * Ns * 3; s_n += prob * Ns * 3; s_d += prob * Ns; s_v += prob * Ns;
  q0 += prob * 4; t0 += prob * 3; q_out += prob * 4; t_out += prob * 3;
  const Slice cs(Nc, C, rank), ss(Ns, C, rank);
  const LayoutB L(chunk_of(Nc, C), chunk_of(Ns, C));

  const Copy copies[8] = {
      copy_of(smem, L.c_p, c_p, cs.lo, cs.n, 12), copy_of(smem, L.c_a, c_a, cs.lo, cs.n, 12),
      copy_of(smem, L.c_b, c_b, cs.lo, cs.n, 12), copy_of(smem, L.c_v, c_v, cs.lo, cs.n, 1),
      copy_of(smem, L.s_p, s_p, ss.lo, ss.n, 12), copy_of(smem, L.s_n, s_n, ss.lo, ss.n, 12),
      copy_of(smem, L.s_d, s_d, ss.lo, ss.n, 4), copy_of(smem, L.s_v, s_v, ss.lo, ss.n, 1),
  };
  stage(copies, &bar);

  const Factors f{reinterpret_cast<const float*>(smem + L.c_p),
                  reinterpret_cast<const float*>(smem + L.c_a),
                  reinterpret_cast<const float*>(smem + L.c_b), smem + L.c_v, cs.n,
                  reinterpret_cast<const float*>(smem + L.s_p),
                  reinterpret_cast<const float*>(smem + L.s_n),
                  reinterpret_cast<const float*>(smem + L.s_d), smem + L.s_v, ss.n};
  float q[4] = {q0[0], q0[1], q0[2], q0[3]};
  float t[3] = {t0[0], t0[1], t0[2]};
  float counts[2] = {0.f, 0.f};
  Reducer rd{red, inbox, pose, 0};
  gn_core(f, q, t, gn_iters, delta, delta_sq, damping, counts, rd, cluster);
  if (rank == 0 && threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) q_out[i] = q[i];
    for (int i = 0; i < 3; ++i) t_out[i] = t[i];
  }
  cluster.sync();
}

// ---------------------------------------------------------------- host

size_t smem_bytes(bool prepared, int Nc, int Ns, int C) {
  const int cc = chunk_of(Nc, C), cs = chunk_of(Ns, C);
  return prepared ? LayoutB(cc, cs).total : LayoutA(cc, cs).total;
}

// Cluster size: about one point per thread, at most 8, and as many blocks
// as the slices need to fit in shared memory. -1 if even 8 do not suffice.
// More blocks shorten each iteration's accumulation more than they lengthen
// its cluster barrier at both main-path sizes.
int cluster_size(bool prepared, int Nc, int Ns) {
  const int work = (Nc + Ns + kThreads - 1) / kThreads;
  for (int C = std::max(1, std::min(work, kMaxCluster)); C <= kMaxCluster; ++C)
    if (smem_bytes(prepared, Nc, Ns, C) <= kSmemBudget) return C;
  return -1;
}

// The cluster launch of one kernel at one point count: C blocks a cluster
// and its dynamic shared memory; C < 0 if the points do not fit.
template <typename... Params>
struct ClusterLaunch {
  void (*kernel)(Params...);
  int C;
  size_t smem;

  ClusterLaunch(void (*k)(Params...), bool prepared, int Nc, int Ns, int* smem_limit)
      : kernel(k), C(cluster_size(prepared, Nc, Ns)),
        smem(C > 0 ? smem_bytes(prepared, Nc, Ns, C) : 0) {
    // Raise the kernel's dynamic shared-memory limit once per size (not on
    // every call, so launches can also be captured into a CUDA graph). Set
    // it even below 48 KB: static plus dynamic above 48 KB needs it too.
    if (C > 0 && static_cast<int>(smem) > *smem_limit) {
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem)) != cudaSuccess) {
        C = -1;
        return;
      }
      *smem_limit = static_cast<int>(smem);
    }
  }

  // gridDim = n_problems * C: cluster i solves problem i.
  cudaLaunchConfig_t config(int n_problems, void* stream, cudaLaunchAttribute* attr) const {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_problems * C, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  template <typename... Args>
  int launch(int n_problems, void* stream, Args... args) const {
    if (C < 0 || n_problems < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(n_problems, stream, attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }

  // Clusters of this shape the card holds at once; -error on failure.
  int max_active() const {
    if (C < 0) return -static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(1, nullptr, attr);
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
};

int smem_limit_a = 0, smem_limit_b = 0;  // the kernels' raised limits

auto launch_a(int Nc, int Ns) {
  return ClusterLaunch(assoc_solve_kernel, false, Nc, Ns, &smem_limit_a);
}

auto launch_b(int Nc, int Ns) {
  return ClusterLaunch(prepared_solve_kernel, true, Nc, Ns, &smem_limit_b);
}

}  // namespace

// Cluster size entry A (prepared = 0) or B (prepared = 1) launches with.
extern "C" int scaloam_gn_cluster_size(int prepared, int Nc, int Ns) {
  return cluster_size(prepared != 0, Nc, Ns);
}

// Clusters of entry A (prepared = 0) or B (prepared = 1) at these point
// counts that the card holds at once (cudaOccupancyMaxActiveClusters); a
// batch of more problems runs in waves. -error on failure.
extern "C" int scaloam_gn_max_active_clusters(int prepared, int Nc, int Ns) {
  return prepared ? launch_b(Nc, Ns).max_active() : launch_a(Nc, Ns).max_active();
}

// Entry A over B problems, each array holding B problems back to back
// (c_xyz [B, Nc, 3], ..., q0 [B, 4], counts [B, 2]): B clusters, one launch.
extern "C" int scaloam_gn_odometry_batched(
    int B, const void* c_xyz, const void* c_any, const void* c_oth, const void* c_mask, int Nc,
    const void* s_xyz, const void* s_any, const void* s_same, const void* s_oth,
    const void* s_mask, int Ns, const void* q0, const void* t0, int outer,
    int gn_iters, float thr, float delta, float delta_sq, float damping,
    void* q_out, void* t_out, void* counts, void* stream) {
  return launch_a(Nc, Ns).launch(
      B, stream,
      static_cast<const float*>(c_xyz), static_cast<const float*>(c_any),
      static_cast<const float*>(c_oth), static_cast<const uint8_t*>(c_mask), Nc,
      static_cast<const float*>(s_xyz), static_cast<const float*>(s_any),
      static_cast<const float*>(s_same), static_cast<const float*>(s_oth),
      static_cast<const uint8_t*>(s_mask), Ns, static_cast<const float*>(q0),
      static_cast<const float*>(t0), outer, gn_iters, thr, delta, delta_sq, damping,
      static_cast<float*>(q_out), static_cast<float*>(t_out), static_cast<int*>(counts));
}

// Entry B over B problems laid out as in scaloam_gn_odometry_batched.
extern "C" int scaloam_gn_solve_prepared_batched(
    int B, const void* c_p, const void* c_a, const void* c_b, const void* c_v, int Nc,
    const void* s_p, const void* s_n, const void* s_d, const void* s_v, int Ns,
    const void* q0, const void* t0, int gn_iters, float delta, float delta_sq,
    float damping, void* q_out, void* t_out, void* stream) {
  return launch_b(Nc, Ns).launch(
      B, stream,
      static_cast<const float*>(c_p), static_cast<const float*>(c_a),
      static_cast<const float*>(c_b), static_cast<const uint8_t*>(c_v), Nc,
      static_cast<const float*>(s_p), static_cast<const float*>(s_n),
      static_cast<const float*>(s_d), static_cast<const uint8_t*>(s_v), Ns,
      static_cast<const float*>(q0), static_cast<const float*>(t0), gn_iters, delta,
      delta_sq, damping, static_cast<float*>(q_out), static_cast<float*>(t_out));
}
