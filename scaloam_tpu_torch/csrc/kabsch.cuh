// The weighted Kabsch rotation of a 3x3 H = P^T Q in one thread, the device
// code of csrc/kabsch.cu and csrc/kabsch_step.cu: a one-sided (Hestenes)
// Jacobi of kSweeps sweeps over the column pairs (0, 1), (0, 2), (1, 2),
// then R = v1 u1^T + v2 u2^T + (v1 x v2)(u1 x u2)^T from the two columns of
// largest norm (see csrc/kabsch.cu and scaloam_tpu_torch/ops/kernels/kabsch.py).
// Every step is a round-to-nearest intrinsic, so nvcc contracts nothing and
// both kernels give the plain version's bits for the same H.

#pragma once

#include <cuda_runtime.h>

namespace kabsch3 {

constexpr int kSweeps = 6;  // kabsch.py SWEEPS

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

// (c a - s b, s a + c b)
__device__ __forceinline__ void rotate(V3& a, V3& b, float c, float s) {
  const V3 p = {__fsub_rn(__fmul_rn(c, a.x), __fmul_rn(s, b.x)),
                __fsub_rn(__fmul_rn(c, a.y), __fmul_rn(s, b.y)),
                __fsub_rn(__fmul_rn(c, a.z), __fmul_rn(s, b.z))};
  const V3 q = {__fadd_rn(__fmul_rn(s, a.x), __fmul_rn(c, b.x)),
                __fadd_rn(__fmul_rn(s, a.y), __fmul_rn(c, b.y)),
                __fadd_rn(__fmul_rn(s, a.z), __fmul_rn(c, b.z))};
  a = p;
  b = q;
}

__device__ __forceinline__ void jacobi_pair(V3& ap, V3& aq, V3& vp, V3& vq) {
  const float alpha = dot(ap, ap), beta = dot(aq, aq), gamma = dot(ap, aq);
  float t = 0.0f;  // gamma = 0: c = 1, s = 0, applied as the plain version applies it
  if (gamma != 0.0f) {
    const float zeta = __fdiv_rn(__fsub_rn(beta, alpha), __fmul_rn(2.0f, gamma));
    const float root = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(zeta, zeta)));
    t = __fdiv_rn(zeta >= 0.0f ? 1.0f : -1.0f, __fadd_rn(fabsf(zeta), root));
  }
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  const float s = __fmul_rn(c, t);
  rotate(ap, aq, c, s);
  rotate(vp, vq, c, s);
}

__device__ __forceinline__ V3 scaled(V3 a, float d) {
  return {__fdiv_rn(a.x, d), __fdiv_rn(a.y, d), __fdiv_rn(a.z, d)};
}

// a - d u
__device__ __forceinline__ V3 minus(V3 a, float d, V3 u) {
  return {__fsub_rn(a.x, __fmul_rn(d, u.x)), __fsub_rn(a.y, __fmul_rn(d, u.y)),
          __fsub_rn(a.z, __fmul_rn(d, u.z))};
}

// R (row-major [3, 3]) from H (row-major [3, 3]).
__device__ __forceinline__ void rotation(const float (&h_)[9], float (&r)[9]) {
  float big = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) big = fmaxf(big, fabsf(h_[k]));
  const float s = big > 0.0f ? big : 1.0f;
  // Columns of H (row-major [3, 3]) scaled by the largest entry.
  V3 a[3], v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = {__fdiv_rn(h_[k], s), __fdiv_rn(h_[3 + k], s), __fdiv_rn(h_[6 + k], s)};
    v[k] = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f};
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_pair(a[0], a[1], v[0], v[1]);
    jacobi_pair(a[0], a[2], v[0], v[2]);
    jacobi_pair(a[1], a[2], v[1], v[2]);
  }
  const float n0 = dot(a[0], a[0]), n1 = dot(a[1], a[1]), n2 = dot(a[2], a[2]);
  int i, j;  // the largest column and the second largest, ties to the lower index
  if (n0 >= n1 && n0 >= n2) {
    i = 0;
    j = n1 >= n2 ? 1 : 2;
  } else if (n1 >= n2) {
    i = 1;
    j = n0 >= n2 ? 0 : 2;
  } else {
    i = 2;
    j = n0 >= n1 ? 0 : 1;
  }
  const V3 a1 = a[i], a2 = a[j], v1 = v[i], v2 = v[j];
  const float l1 = __fsqrt_rn(dot(a1, a1));
  const V3 u1 = l1 > 0.0f ? scaled(a1, l1) : V3{1.0f, 0.0f, 0.0f};
  V3 w = minus(a2, dot(u1, a2), u1);
  float l2 = __fsqrt_rn(dot(w, w));
  if (!(l2 > 0.0f)) {  // the unit axis least aligned with u1, orthogonal to it
    const float m0 = fabsf(u1.x), m1 = fabsf(u1.y), m2 = fabsf(u1.z);
    V3 e;
    if (m0 <= m1 && m0 <= m2) {
      e = {1.0f, 0.0f, 0.0f};
    } else if (m1 <= m2) {
      e = {0.0f, 1.0f, 0.0f};
    } else {
      e = {0.0f, 0.0f, 1.0f};
    }
    w = minus(e, dot(u1, e), u1);
    l2 = __fsqrt_rn(dot(w, w));
  }
  const V3 u2 = scaled(w, l2);
  const V3 v3 = cross(v1, v2), u3 = cross(u1, u2);
  const float vv[3][3] = {{v1.x, v2.x, v3.x}, {v1.y, v2.y, v3.y}, {v1.z, v2.z, v3.z}};
  const float uu[3][3] = {{u1.x, u2.x, u3.x}, {u1.y, u2.y, u3.y}, {u1.z, u2.z, u3.z}};
#pragma unroll
  for (int row = 0; row < 3; ++row) {
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      r[3 * row + col] = __fadd_rn(
          __fadd_rn(__fmul_rn(vv[row][0], uu[col][0]), __fmul_rn(vv[row][1], uu[col][1])),
          __fmul_rn(vv[row][2], uu[col][2]));
    }
  }
}

}  // namespace kabsch3
