"""Where the port's hand kernels spend their time, on one GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_kernel_probe.py

On the full-width kitti_hdl64 frame of chip_smoke.py's drive it reports:
  - K1 (select_features): the kernel timed with no picks (row load and
    sort), with the 20 corner rounds only, and with all rounds, so the
    walk's time per round (one pick in every subregion) follows;
  - K2 entry B (gn_solve_prepared) on mapping's factors of frame 3 at 1, 2,
    4 and 8 Gauss-Newton iterations: the slope is one iteration's time, the
    intercept the launch, staging and final barrier;
  - the latency, in SM cycles, of the primitives the K1 walk chains (one
    warp: a dependent shared-memory load; a ballot + __ffs + shuffle; a
    pick done alone: flag load, ballot, shuffle, band store, __syncwarp,
    list load), from a probe kernel built here with the kernels' nvcc
    flags.
Kernel times are CUDA-graph replays (chip_smoke.graph_ms). The last line of
standard output is one JSON object with these numbers.
"""

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>
// One warp chains n steps of the chosen kind; returns cycles per step.
__global__ void chain(int n, int kind, long long* out, int* sink) {
  __shared__ uint8_t flag[4096];
  __shared__ int16_t list[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) {
    flag[i] = (i * 7919) % 5 == 0 ? 2 : 1;
    list[i] = static_cast<int16_t>((i * 2654435761u) >> 20);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int j = list[lane] & 4095, acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (kind == 0) {  // dependent shared-memory load
      j = list[(j + lane) & 4095] & 4095;
    } else if (kind == 1) {  // ballot + ffs + shuffle, registers only
      const unsigned m = __ballot_sync(0xffffffffu, ((j + i) & 3) != 0);
      j = (__shfl_sync(0xffffffffu, j, __ffs(m) - 1) + lane + i) & 4095;
    } else {  // a pick done alone
      const unsigned m = __ballot_sync(0xffffffffu, flag[j] == 1);
      const int w = __shfl_sync(0xffffffffu, j, m ? __ffs(m) - 1 : 0);
      if (lane < 11) flag[(w + lane) & 4095] = (i & 1) + 1;
      __syncwarp();
      j = list[(w + lane) & 4095] & 4095;
      acc += w;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = (t1 - t0) / n;
    sink[0] = acc + j;
  }
}
extern "C" int probe_chain(int n, int kind, void* out, void* sink) {
  chain<<<1, 32>>>(n, kind, static_cast<long long*>(out), static_cast<int*>(sink));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from scaloam_tpu_torch import config
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.ops import features
    from scaloam_tpu_torch.ops.kernels import _build, gn_odometry, selection
    from scaloam_tpu_torch.types import LidarScan
    from scaloam_tpu_torch.utils import synthetic

    smi = cs.smi_line()
    print(f"card: {smi}", flush=True)
    _build.build()
    cfg = config.kitti_hdl64()
    dev = torch.device("cuda")
    world = synthetic.make_world(seed=3, n_boxes=60, extent=70.0)
    scans, _ = synthetic.simulate_trajectory(
        world, n_frames=4, speed=1.2, radius=40.0, n_scans=64, n_azimuth=2048, seed=7)
    dev_scans = [LidarScan.from_numpy(s, cfg.sensor.max_points, dev) for s in scans]

    # ---- K1 phases
    feat = cfg.features
    si = features.selection_inputs(dev_scans[1], cfg)
    args = (si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep)
    k1 = {}
    for n_corner, n_flat in ((0, 0), (feat.less_sharp_per_subregion, 0),
                             (feat.less_sharp_per_subregion, feat.flat_per_subregion)):
        k1[f"{n_corner}/{n_flat}"] = cs.graph_ms(torch, lambda: selection.select_features(
            *args, n_sub=feat.n_subregions, n_corner=n_corner, n_flat=n_flat,
            curv_thr=feat.curvature_threshold), 200) * 1e3
    rounds = feat.less_sharp_per_subregion + feat.flat_per_subregion
    full = k1[f"{feat.less_sharp_per_subregion}/{feat.flat_per_subregion}"]
    k1_round_us = (full - k1["0/0"]) / rounds
    print(f"K1 us by rounds run (corner/flat): {json.dumps(k1)}; walk {k1_round_us:.3f} us a "
          f"round of {feat.n_subregions} picks", flush=True)

    # ---- K2 entry B per iteration, on mapping's factors of frame 3
    captured = []
    kernel_b = gn_odometry.gn_solve_prepared

    def spy(*a, **k):
        captured.append((a, k))
        return gn_odometry.gn_solve_prepared_plain(*a, **k)

    fe = FrontEnd(cfg, device="cuda")
    for i, scan in enumerate(dev_scans):
        if i == 3:
            gn_odometry.gn_solve_prepared = spy
        try:
            fe.step(scan.xyz, scan.mask)
        finally:
            gn_odometry.gn_solve_prepared = kernel_b
    pa, pk = captured[0]
    kb = {it: cs.graph_ms(torch, lambda: gn_odometry.gn_solve_prepared(
        *pa, gn_iterations=it, huber_delta=pk["huber_delta"]), 200) * 1e3 for it in (1, 2, 4, 8)}
    slope = (kb[8] - kb[1]) / 7
    print(f"K2 B us by GN iterations: {json.dumps(kb)}; {slope:.3f} us an iteration, "
          f"{kb[1] - slope:.3f} us besides", flush=True)

    # ---- latency of the primitives a pick chains
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "chain.cu"), os.path.join(out_dir, "libchain.so")
    with open(src, "w") as f:
        f.write(PROBE_CU)
    subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.probe_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = {}
    for kind, name in enumerate(("dependent_lds", "ballot_ffs_shfl", "pick_alone")):
        if lib.probe_chain(1000, kind, out.data_ptr(), sink.data_ptr()):
            raise RuntimeError("probe kernel failed")
        cycles[name] = int(out.item())
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"cycles a step (one warp): {json.dumps(cycles)}; SM clock {clocks}", flush=True)
    print(json.dumps({"card": smi, "k1_us": k1, "k1_us_per_round": k1_round_us,
                      "k2b_us_by_iters": kb, "k2b_us_per_iter": slope,
                      "chain_cycles": cycles, "sm_clock": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
