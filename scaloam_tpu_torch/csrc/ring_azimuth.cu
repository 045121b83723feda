// The ring id, its validity and the raw azimuth of every point of a scan,
// one pass a frame:
//
//   hyp     = sqrt(fma(x, x, y * y))         one rounding each
//   rad     = atan2f(z, hyp)                  glibc's, csrc/atan2f.cuh
//   ring    = clamp(the sensor's ring formula of rad, 0, n_scans - 1)
//   ring_ok = the formula's bounds
//   ori_raw = -atan2f(y, x)
//
// Replaces no Pallas kernel: the reference computes these in XLA
// (scaloam_tpu/ops/features.py:49-71 `_ring_id` and the azimuths at :91 and
// :114). In the port they were three launches of csrc/f32ops.cu's atan2 a
// frame (the third on the sorted copy of the same points) and ~15
// elementwise launches around the first (the float64 fused multiply-add
// and root of hyp, the ring formula, trunc, the bounds, the clamp); the
// range image now gathers ori_raw in sorted order.
//
// Arithmetic: the plain version (scaloam_tpu_torch/ops/kernels/ring_azimuth.py,
// the port's former composition regrouped) in the same IEEE operations,
// each a round-to-nearest intrinsic, so nvcc contracts nothing and the two
// agree to the bit. The reference's compiled code forms `angle + c` as one
// fused multiply-add of the radians (__fmaf_rn) and hyp with one fused
// multiply-add and a correctly rounded root: __fsqrt_rn is that root, as
// the plain version's float64 root rounded once to float32 is (53 >= 2 * 24
// + 2 bits). trunc toward zero is __float2int_rz, PyTorch's cast on the
// card (a NaN point gives 0 there; it is never valid downstream).
//
// Bound on the card: the bytes, 21 a point (12 read, 4 + 1 + 4 written):
// ~2.75 MB at kitti_hdl64's 131072 points, ~8.2e-4 ms at 3.35 TB/s. The
// operations (two atan2f of ~34 float operations, ~15 more) are ~83 a point,
// ~1.1e7 a frame, ~1.6e-4 ms at the float32 peak. One thread a point: every
// load and store is coalesced and nothing is kept between points.

#include <cuda_runtime.h>
#include <cstdint>

#include "atan2f.cuh"

namespace {

constexpr int kThreads = 256;

// ring_azimuth.py LIDAR_CODES
constexpr int kVLP16 = 0, kHDL32 = 1, kHDL64 = 2, kOS1_64 = 3;

__global__ void __launch_bounds__(kThreads)
ring_azimuth_kernel(const float* __restrict__ xyz, int64_t n, int lidar, int n_scans,
                    int* __restrict__ ring, bool* __restrict__ ring_ok,
                    float* __restrict__ ori_raw) {
  const int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
  const float hyp = __fsqrt_rn(__fmaf_rn(x, x, __fmul_rn(y, y)));
  const float rad = glibc_f32::atan2f(z, hyp);
  // float32 constants of the formulas: 180 / pi, 92 / 3, -8.83, -24.33
  const float deg = __uint_as_float(0x42652EE1u);
  const float hdl32_top = __uint_as_float(0x41F55555u);
  const float hdl64_split = __uint_as_float(0xC10D47AEu);
  const float hdl64_bottom = __uint_as_float(0xC1C2A3D7u);
  int sid;
  bool ok;
  if (lidar == kHDL64) {
    const float angle = __fmul_rn(rad, deg);
    const int upper = __float2int_rz(__fadd_rn(__fmul_rn(__fsub_rn(2.0f, angle), 3.0f), 0.5f));
    const int lower = n_scans / 2 + __float2int_rz(
        __fadd_rn(__fmul_rn(__fsub_rn(hdl64_split, angle), 2.0f), 0.5f));
    sid = angle >= hdl64_split ? upper : lower;
    ok = angle <= 2.0f && angle >= hdl64_bottom && sid >= 0 && sid <= 50;
  } else {
    float t;
    if (lidar == kHDL32) {
      t = __fdiv_rn(__fmul_rn(__fmaf_rn(rad, deg, hdl32_top), 3.0f), 4.0f);
    } else {
      const float top = lidar == kVLP16 ? 15.0f : 22.5f;  // OS1-64
      t = __fadd_rn(__fdiv_rn(__fmaf_rn(rad, deg, top), 2.0f), 0.5f);
    }
    sid = __float2int_rz(t);
    ok = sid >= 0 && sid <= n_scans - 1;
  }
  ring[k] = min(max(sid, 0), n_scans - 1);
  ring_ok[k] = ok;
  ori_raw[k] = -glibc_f32::atan2f(y, x);
}

}  // namespace

extern "C" int scaloam_ring_azimuth(const void* xyz, long long n, int lidar, int n_scans,
                                    void* ring, void* ring_ok, void* ori_raw, void* stream) {
  if (n <= 0) return 0;
  if (lidar < kVLP16 || lidar > kOS1_64 || n_scans <= 0) return int(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ring_azimuth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, lidar, n_scans, static_cast<int*>(ring),
      static_cast<bool*>(ring_ok), static_cast<float*>(ori_raw));
  return static_cast<int>(cudaGetLastError());
}
