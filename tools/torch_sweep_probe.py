"""Odometry's 2-NN sweep on the card: the kernel (csrc/sweep_top2.cu)
against the former composition it replaced, at the odometry's shapes.

    python tools/torch_sweep_probe.py [--reps N] [--lanes 8,16,32]

For the less-flat sweep (1536 queries x 32768 targets, three classes) and
the less-sharp sweep (768 x 4096, two) of tests/sweep_cases.py, at one
sequence and at eight under torch.func.vmap (the fleet's batched frame):
the kernel's outputs against the plain composition's on the card, bit for
bit; then the device ms of a call, each captured in a CUDA graph and
replayed `--reps` times between CUDA events: the kernel at each lane count
of `--lanes` and at the one it picks from the problem count, and the
former composition (sq_dist blocks, masks, tile_top2, merge_top2),
beside the kernel's bound (9 float operations a pair a phase at 67
TFLOP/s). One JSON line a shape; the card's name and power limit first.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OPS_PAIR_PHASE = 9
PEAK_FLOPS = 67e12


def _graph_ms(torch, fn, reps):
    """Device ms of fn() captured once and replayed reps times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--lanes", default="8,16,32")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import torch
    from sweep_cases import sweep_case
    from scaloam_tpu_torch.ops import voxel
    from scaloam_tpu_torch.ops.kernels import _build, sweep_top2

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    log = _build.build(("sweep_top2",)).get("sweep_top2", "")
    print("\n".join(line for line in log.splitlines() if "sweep_top2" in line or "Used" in line))
    dev = torch.device("cuda")
    chosen = sweep_top2._lanes
    for name, B in (("surf", 1), ("corner", 1), ("surf", 8), ("corner", 8)):
        cases = [sweep_case(name, seed=s) for s in range(B)]
        tens = [torch.stack([torch.tensor(c[k], device=dev) for c in cases])
                for k in ("query", "target", "mask", "ring")]
        c = cases[0]
        want_same = name == "surf"
        T, Q = tens[1].shape[1], tens[0].shape[1]
        tiles = (voxel.fit_tile(T, c["tile_any"]), voxel.fit_tile(T, c["tile_ring"]))

        def kernel():
            return torch.func.vmap(lambda *a: sweep_top2.sweep_top2(
                *a, c["nearby"], want_same, c["tile_any"], c["tile_ring"]))(*tens)

        def former():
            return torch.func.vmap(lambda *a: sweep_top2.sweep_top2_plain(
                *a, c["nearby"], want_same, *tiles))(*tens)

        got, want = kernel(), former()
        equal = torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))
        row = {"sweep": name, "B": B, "Q": Q, "T": T, "classes": 2 + want_same,
               "equal_bits": equal, "lanes_chosen": chosen(B * Q, dev),
               "bound_ms": B * Q * T * 2 * OPS_PAIR_PHASE / PEAK_FLOPS * 1e3}
        for lanes in (int(n) for n in args.lanes.split(",")):
            sweep_top2._lanes = lambda problems, device, n=lanes: n
            row[f"kernel_ms_lanes{lanes}"] = _graph_ms(torch, kernel, args.reps)
        sweep_top2._lanes = chosen
        row["kernel_ms"] = _graph_ms(torch, kernel, args.reps)
        row["former_ms"] = _graph_ms(torch, former, max(2, args.reps // 4))
        row["bound_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        if not equal:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
