// Scan-to-scan odometry solve for one frame: candidate re-ranking plus
// Gauss-Newton, in one single-block kernel.
//
// Replaces the TPU kernel scaloam_tpu/ops/pallas/gn_odometry.py:
// associate_and_solve (body _make_kernel). Per outer pass: re-rank the two
// cached candidates of every class at the current pose (gate d^2 < thr),
// then run gn_iters Gauss-Newton iterations with the correspondences frozen.
// Each iteration builds the point-to-line residuals (p'-a)x(p'-b)/|a-b| and
// the 3-point plane residuals n.p' + d with their Jacobians, weights them by
// Huber(delta), reduces the 21 upper-triangle entries of J^T W J and the 6 of
// J^T W r over all points, damps the diagonal by damping*max(diag, 1e-8),
// solves the 6x6 system with an unrolled Cholesky and applies the
// right-multiplicative update q <- normalize(q * Exp(dtheta)), t <- t + dt.
// Returns the pose and the valid counts of the last pass.
//
// Bound on the card: ~180 KB of input and ~5 MFLOP at the kitti_hdl64 sizes
// (768 corner, 1536 surf points): well under 1 us either way. The real limit
// is latency: 2 x 4 dependent block reductions, each followed by a scalar
// solve. Design: one block; each thread owns a fixed stride of points, so
// the per-pass candidate choice it records in a scratch byte per point is
// read back by the same thread without a barrier; per iteration each thread
// accumulates the 27 sums in registers, then warp shuffles and one
// shared-memory pass reduce them, and thread 0 solves and publishes the pose
// through shared memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // 21 upper-triangle J^T W J + 6 J^T W r
constexpr float kEps = 1e-9f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 div(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

struct Rot {
  float m[3][3];
};

// se3.quat_to_mat on a wxyz quaternion.
__device__ Rot rot_from_quat(const float* q) {
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

// Nearer of two cached candidates c[0..2], c[3..5]: returns d^2, sets take1.
__device__ __forceinline__ float pick_nearer(V3 pw, const float* c, bool* take1) {
  const V3 e0 = sub(pw, load3(c)), e1 = sub(pw, load3(c + 3));
  const float d0 = dot(e0, e0), d1 = dot(e1, e1);
  *take1 = d1 < d0;
  return fminf(d0, d1);
}

__device__ __forceinline__ V3 chosen(const float* c, bool take1) { return load3(c + (take1 ? 3 : 0)); }

__device__ __forceinline__ float huber_w(float s, float delta, float delta_sq) {
  return s <= delta_sq ? 1.0f : delta / sqrtf(fmaxf(s, 1e-20f));
}

// Adds w * J_i . J_j (i <= j) and w * J_i . r to acc; J has R rows of 6.
template <int R>
__device__ __forceinline__ void accumulate(float* acc, const float (&J)[6][R],
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
__device__ void chol6_solve(float (&A)[6][6], const float (&b)[6], float (&x)[6]) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float Ljj = sqrtf(fmaxf(s, 1e-20f));
    L[j][j] = Ljj;
    const float inv = 1.0f / Ljj;
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

__global__ void __launch_bounds__(kThreads) gn_kernel(
    const float* __restrict__ c_xyz, const float* __restrict__ c_any,
    const float* __restrict__ c_oth, const uint8_t* __restrict__ c_mask, int Nc,
    const float* __restrict__ s_xyz, const float* __restrict__ s_any,
    const float* __restrict__ s_same, const float* __restrict__ s_oth,
    const uint8_t* __restrict__ s_mask, int Ns, const float* __restrict__ q0,
    const float* __restrict__ t0, int outer, int gn_iters, float thr,
    float delta, float delta_sq, float damping, uint8_t* __restrict__ choice,
    float* __restrict__ q_out, float* __restrict__ t_out, int* __restrict__ counts) {
  __shared__ float sh_q[4], sh_t[3];
  __shared__ float red[kWarps][kSums];
  __shared__ float tot[kSums];
  __shared__ int sh_nc, sh_ns;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  uint8_t* c_choice = choice;
  uint8_t* s_choice = choice + Nc;

  if (tid < 4) sh_q[tid] = q0[tid];
  if (tid < 3) sh_t[tid] = t0[tid];
  __syncthreads();

  for (int pass = 0; pass < outer; ++pass) {
    // ---- data association at the current pose (odometry._associate)
    if (tid == 0) { sh_nc = 0; sh_ns = 0; }
    {
      const Rot R = rot_from_quat(sh_q);
      const V3 t = {sh_t[0], sh_t[1], sh_t[2]};
      int nc = 0, ns = 0;
      for (int i = tid; i < Nc; i += kThreads) {
        const V3 w = apply_R(R, load3(c_xyz + 3 * i));
        const V3 p = {w.x + t.x, w.y + t.y, w.z + t.z};
        bool ta, tb;
        const float dj = pick_nearer(p, c_any + 6 * i, &ta);
        const float dd = pick_nearer(p, c_oth + 6 * i, &tb);
        const bool valid = c_mask[i] && dj < thr && dd < thr;
        c_choice[i] = (ta ? 1 : 0) | (tb ? 2 : 0) | (valid ? 4 : 0);
        nc += valid;
      }
      for (int i = tid; i < Ns; i += kThreads) {
        const V3 w = apply_R(R, load3(s_xyz + 3 * i));
        const V3 p = {w.x + t.x, w.y + t.y, w.z + t.z};
        bool tj, tl, tm;
        const float dj = pick_nearer(p, s_any + 6 * i, &tj);
        const float dl = pick_nearer(p, s_same + 6 * i, &tl);
        const float dm = pick_nearer(p, s_oth + 6 * i, &tm);
        const bool valid = s_mask[i] && dj < thr && dl < thr && dm < thr;
        s_choice[i] = (tj ? 1 : 0) | (tl ? 2 : 0) | (tm ? 4 : 0) | (valid ? 8 : 0);
        ns += valid;
      }
      __syncthreads();  // sh_nc/sh_ns reset is visible
      atomicAdd(&sh_nc, nc);
      atomicAdd(&sh_ns, ns);
      __syncthreads();
    }

    // ---- gn_iters relinearizations with frozen correspondences
    for (int it = 0; it < gn_iters; ++it) {
      const Rot R = rot_from_quat(sh_q);
      const V3 t = {sh_t[0], sh_t[1], sh_t[2]};
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

      for (int i = tid; i < Nc; i += kThreads) {
        const uint8_t ch = c_choice[i];
        if (!(ch & 4)) continue;
        const V3 a = chosen(c_any + 6 * i, ch & 1);
        const V3 b = chosen(c_oth + 6 * i, ch & 2);
        const V3 d = sub(a, b);
        const float dn = fmaxf(sqrtf(dot(d, d)), kEps);
        const V3 w3 = apply_R(R, load3(c_xyz + 3 * i));
        const V3 pw = {w3.x + t.x, w3.y + t.y, w3.z + t.z};
        const V3 rv = div(cross(sub(pw, a), sub(pw, b)), dn);
        float J[6][3];
        for (int k = 0; k < 3; ++k) {
          const V3 jr = div(cross(cross(col(R, k), w3), d), dn);
          J[k][0] = jr.x; J[k][1] = jr.y; J[k][2] = jr.z;
        }
        // translation block: column k is (e_k x d) / dn
        J[3][0] = 0.f;       J[3][1] = -d.z / dn; J[3][2] = d.y / dn;
        J[4][0] = d.z / dn;  J[4][1] = 0.f;       J[4][2] = -d.x / dn;
        J[5][0] = -d.y / dn; J[5][1] = d.x / dn;  J[5][2] = 0.f;
        const float r[3] = {rv.x, rv.y, rv.z};
        accumulate<3>(acc, J, r, huber_w(dot(rv, rv), delta, delta_sq));
      }

      for (int i = tid; i < Ns; i += kThreads) {
        const uint8_t ch = s_choice[i];
        if (!(ch & 8)) continue;
        const V3 pj = chosen(s_any + 6 * i, ch & 1);
        const V3 pl = chosen(s_same + 6 * i, ch & 2);
        const V3 pm = chosen(s_oth + 6 * i, ch & 4);
        V3 nrm = cross(sub(pj, pl), sub(pj, pm));
        const float nn = fmaxf(sqrtf(dot(nrm, nrm)), kEps);
        nrm = div(nrm, nn);
        const float neg_d = -dot(pj, nrm);
        const V3 sp = load3(s_xyz + 3 * i);
        const V3 w3 = apply_R(R, sp);
        const V3 pw = {w3.x + t.x, w3.y + t.y, w3.z + t.z};
        const float rs = dot(nrm, pw) + neg_d;
        const V3 jrot = cross(sp, apply_RT(R, nrm));
        const float J[6][1] = {{jrot.x}, {jrot.y}, {jrot.z}, {nrm.x}, {nrm.y}, {nrm.z}};
        const float r[1] = {rs};
        accumulate<1>(acc, J, r, huber_w(rs * rs, delta, delta_sq));
      }

      // ---- block reduction of the 27 sums
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float v = acc[k];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][k] = v;
      }
      __syncthreads();
      if (tid < kSums) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += red[w][tid];
        tot[tid] = v;
      }
      __syncthreads();

      // ---- damped solve and pose update (gn.solve_step / apply_delta)
      if (tid == 0) {
        float A[6][6], g[6], x[6];
        int k = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = i; j < 6; ++j) { A[i][j] = tot[k]; A[j][i] = tot[k]; ++k; }
        for (int i = 0; i < 6; ++i) g[i] = -tot[k + i];
        for (int i = 0; i < 6; ++i) A[i][i] += damping * fmaxf(A[i][i], 1e-8f);
        chol6_solve(A, g, x);
        // exp_so3
        const float t2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
        const bool small = t2 < 1e-12f;
        const float theta = sqrtf(small ? 1.0f : t2);
        const float half = 0.5f * theta;
        const float kk = small ? 0.5f - t2 / 48.0f : sinf(half) / theta;
        const float cw = small ? 1.0f - t2 / 8.0f : cosf(half);
        const float dq[4] = {cw, kk * x[0], kk * x[1], kk * x[2]};
        const float aw = sh_q[0], ax = sh_q[1], ay = sh_q[2], az = sh_q[3];
        float q[4] = {
            aw * dq[0] - ax * dq[1] - ay * dq[2] - az * dq[3],
            aw * dq[1] + ax * dq[0] + ay * dq[3] - az * dq[2],
            aw * dq[2] - ax * dq[3] + ay * dq[0] + az * dq[1],
            aw * dq[3] + ax * dq[2] - ay * dq[1] + az * dq[0],
        };
        const float qn = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), kEps);
        for (int i = 0; i < 4; ++i) sh_q[i] = q[i] / qn;
        for (int i = 0; i < 3; ++i) sh_t[i] += x[3 + i];
      }
      __syncthreads();
    }
  }
  if (tid < 4) q_out[tid] = sh_q[tid];
  if (tid < 3) t_out[tid] = sh_t[tid];
  if (tid == 0) { counts[0] = sh_nc; counts[1] = sh_ns; }
}

}  // namespace

extern "C" int scaloam_gn_odometry(
    const void* c_xyz, const void* c_any, const void* c_oth, const void* c_mask, int Nc,
    const void* s_xyz, const void* s_any, const void* s_same, const void* s_oth,
    const void* s_mask, int Ns, const void* q0, const void* t0, int outer,
    int gn_iters, float thr, float delta, float delta_sq, float damping, void* choice,
    void* q_out, void* t_out, void* counts, void* stream) {
  gn_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c_xyz), static_cast<const float*>(c_any),
      static_cast<const float*>(c_oth), static_cast<const uint8_t*>(c_mask), Nc,
      static_cast<const float*>(s_xyz), static_cast<const float*>(s_any),
      static_cast<const float*>(s_same), static_cast<const float*>(s_oth),
      static_cast<const uint8_t*>(s_mask), Ns, static_cast<const float*>(q0),
      static_cast<const float*>(t0), outer, gn_iters, thr, delta, delta_sq, damping,
      static_cast<uint8_t*>(choice), static_cast<float*>(q_out),
      static_cast<float*>(t_out), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
