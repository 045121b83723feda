"""Graph memory pools of the captured steps (scaloam_tpu_torch/compiled.py).

Captures (a)'s pose-graph tiers of chip_smoke.py (`optimize` at 1024 /
16, 4096 / 64 and 8192 / 256 nodes / loops on its circle chains) and
`multiseq.frame_batch` at 1, 2, 4 and 8 full-width kitti_hdl64 sequences
(both keys of each: the first frame and a later one), in two layouts,
each in a process of its own: all keys of a step in one pool, as
compiled.py does ("shared"), and a private pool a key ("per-key").

Run from the repository root on a machine with a CUDA GPU:

    python3 tools/torch_graph_pool_probe.py

Prints the card's name and power limit, then one JSON line a layout: the
GiB in graph pools after the tiers and after the batches, the GiB
reserved at the end, and the ms of a replay of each tier (CUDA events).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
LAYOUTS = ("shared", "per-key")


def run(layout: str) -> dict:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from scaloam_tpu_torch import compiled, config
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.ops.kernels import _build
    from scaloam_tpu_torch.parallel import multiseq
    from scaloam_tpu_torch.types import LidarScan, Pose
    from scaloam_tpu_torch.utils import synthetic

    if layout == "per-key":
        capture = compiled._capture
        # a private pool and a stream of its own a graph
        compiled._capture = lambda pool, fn: capture((None, torch.cuda.Stream()), fn)
    dev = torch.device("cuda")
    _build.build()
    gib = lambda b: None if b is None else b / 2**30
    out = {"layout": layout, "replay_ms": {}}
    for n, nl in chip_smoke.PGO_TIERS:
        _, oq, ot, loops = chip_smoke.circle_chain(n, nl, seed=n)
        cfg = chip_smoke.chain_pgo_cfg(config.PGOConfig(), n, nl)
        g = chip_smoke.build_graph(torch, pg, Pose, cfg, oq, ot, loops, dev)
        pg.optimize(g, cfg)  # the key's first call: eager, then captured
        out["replay_ms"][n] = chip_smoke.cuda_ms(torch, lambda: pg.optimize(g, cfg), iters=5,
                                                 warmup=1)
    torch.cuda.synchronize()
    out["graph_pools_gib_after_tiers"] = gib(chip_smoke.graph_pool_bytes(torch))
    cfg = config.kitti_hdl64()
    scans, _ = chip_smoke.preset_drive(synthetic, cfg.sensor, chip_smoke.MAIN_COLS, n_frames=2)
    dev_scans = [LidarScan.from_numpy(s, cfg.sensor.max_points, dev) for s in scans]
    for b in chip_smoke.H_BATCHES:
        o, m = multiseq.init_states(b, cfg, dev)
        for s in dev_scans:
            o, m, _, _ = multiseq.frame_batch(o, m, torch.stack([s.xyz] * b),
                                              torch.stack([s.mask] * b), cfg)
    torch.cuda.synchronize()
    out["graph_pools_gib_after_batches"] = gib(chip_smoke.graph_pool_bytes(torch))
    out["reserved_gib"] = gib(torch.cuda.memory_reserved())
    out["captures"] = {"optimize": pg.optimize.captures,
                       "frame_batch": multiseq._frame_batch.captures}
    return out


def main(argv) -> int:
    if argv[:1] == ["--layout"] and len(argv) == 2 and argv[1] in LAYOUTS:
        print(json.dumps(run(argv[1])), flush=True)
        return 0
    if argv:
        print("usage: torch_graph_pool_probe.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_graph_pool_probe: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for layout in LAYOUTS:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--layout", layout],
                              cwd=HERE, capture_output=True, text=True, timeout=900)
        if done.returncode != 0:
            print(done.stdout, done.stderr, file=sys.stderr)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
