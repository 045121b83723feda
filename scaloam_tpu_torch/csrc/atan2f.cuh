// glibc's float atan2f (sysdeps/ieee754/flt-32: fdlibm's argument reduction
// to four intervals and an odd polynomial in float32), the device code of
// csrc/f32ops.cu's atan2 and csrc/ring_azimuth.cu. Every step is a
// round-to-nearest intrinsic, so nvcc contracts nothing and both kernels
// give the bits of scaloam_tpu_torch/ops/f32.py's atan2, the C library's.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace glibc_f32 {

// glibc's float atan constants, as stored in its libm: atan(0.5), atan(1),
// atan(1.5), atan(inf) in a high and a low part, and the odd polynomial's
// coefficients.
__constant__ uint32_t kAtanHi[4] = {0x3EED6338u, 0x3F490FDAu, 0x3F7B985Eu, 0x3FC90FDAu};
__constant__ uint32_t kAtanLo[4] = {0x31AC3769u, 0x33222168u, 0x33140FB4u, 0x33A22168u};
__constant__ uint32_t kAt[11] = {0x3EAAAAABu, 0xBE4CCCCDu, 0x3E124925u, 0xBDE38E38u,
                                 0x3DBA2E6Eu, 0xBD9D8795u, 0x3D886B35u, 0xBD6EF16Bu,
                                 0x3D4BDA59u, 0xBD15A221u, 0x3C8569D7u};

__device__ __forceinline__ float bits(uint32_t b) { return __uint_as_float(b); }

// glibc's atanf on x >= 0.
__device__ inline float atan_abs(float x) {
  if (x >= 0x1p25f) return __fadd_rn(bits(kAtanHi[3]), bits(kAtanLo[3]));
  if (x < 0x1p-29f) return x;
  int band;
  float xr;
  if (x < 0.4375f) {
    band = -1;
    xr = x;
  } else if (x < 0.6875f) {
    band = 0;
    xr = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, x), 1.0f), __fadd_rn(2.0f, x));
  } else if (x < 1.1875f) {
    band = 1;
    xr = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
  } else if (x < 2.4375f) {
    band = 2;
    xr = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
  } else {
    band = 3;
    xr = __fdiv_rn(-1.0f, x);
  }
  const float z = __fmul_rn(xr, xr);
  const float w = __fmul_rn(z, z);
  float p1 = __fadd_rn(__fmul_rn(w, bits(kAt[10])), bits(kAt[8]));
  for (int k = 6; k >= 0; k -= 2) p1 = __fadd_rn(__fmul_rn(p1, w), bits(kAt[k]));
  float p2 = __fadd_rn(__fmul_rn(w, bits(kAt[9])), bits(kAt[7]));
  for (int k = 5; k >= 1; k -= 2) p2 = __fadd_rn(__fmul_rn(p2, w), bits(kAt[k]));
  const float s = __fmul_rn(xr, __fadd_rn(__fmul_rn(z, p1), __fmul_rn(w, p2)));
  if (band < 0) return __fsub_rn(xr, s);
  return __fsub_rn(bits(kAtanHi[band]), __fsub_rn(__fsub_rn(s, bits(kAtanLo[band])), xr));
}

// glibc's atan2f(y, x).
__device__ inline float atan2f(float y, float x) {
  const float pi = bits(0x40490FDBu), pi_lo = bits(0xB3BBBD2Eu), pi_o_2 = bits(0x3FC90FDBu);
  const float z = atan_abs(fabsf(__fdiv_rn(y, x)));
  const bool ny = signbit(y), nx = signbit(x);
  float r = ny ? -z : z;
  if (nx) r = ny ? __fsub_rn(__fsub_rn(z, pi_lo), pi) : __fsub_rn(pi, __fsub_rn(z, pi_lo));
  if (x == 0.0f) r = ny ? -pi_o_2 : pi_o_2;
  if (y == 0.0f) r = nx ? (ny ? -pi : pi) : y;
  return r;
}

}  // namespace glibc_f32
