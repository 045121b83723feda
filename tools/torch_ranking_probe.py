"""How far the port's odometry moves from the JAX reference because of its
2-NN ranking formula (CPU only; imports both packages).

Run from the repository root:

    JAX_PLATFORMS=cpu python tools/torch_ranking_probe.py [seed ...]

For each drive seed (default 40 3) it builds a reduced HDL-64 config
(16384 points, a 384-wide range image), runs the reference's odometry on frames 0-1,
carries its state into the port, and solves frame 1 in the port twice:
ranking candidates by direct differences (the port's choice) and by the
reference's |q|^2 + |t|^2 - 2 q.t, and prints both solves' rel-translation
difference from the reference.
"""

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import odometry as jodo
from scaloam_tpu.ops import features as jfeat
from scaloam_tpu.types import LidarScan as JScan
from scaloam_tpu.utils import synthetic
from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import odometry as todo
from scaloam_tpu_torch.ops import features as tfeat, voxel
from scaloam_tpu_torch.types import LidarScan as TScan


def expanded_sq_dist(q, t):
    """The reference's ranking form |q|^2 + |t|^2 - 2 q.t."""
    return (q * q).sum(-1, keepdim=True) + (t * t).sum(-1)[None, :] - 2.0 * (q @ t.T)


def main(seeds):
    cfg = jconfig.kitti_hdl64()
    cfg = cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(cfg.features, max_sharp=768, max_less_sharp=2048,
                                     max_flat=1536, max_less_flat=8192),
    )
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    direct = voxel.sq_dist
    for seed in seeds:
        scans, _ = synthetic.simulate_trajectory(
            synthetic.make_world(seed=8), n_frames=2, speed=0.8, radius=25.0,
            n_azimuth=250, seed=seed)
        jf = [jfeat.extract_features(JScan.from_numpy(s, cfg.sensor.max_points), cfg) for s in scans]
        js, _ = jodo.odometry_step(jodo.init_state(cfg), jf[0], cfg)
        host = jax.tree.map(np.array, js)
        _, jo = jodo.odometry_step(js, jf[1], cfg)
        tf = tfeat.extract_features(TScan.from_numpy(scans[1], cfg.sensor.max_points, "cpu"), tcfg)
        for name, fn in (("direct", direct), ("expanded", expanded_sq_dist)):
            voxel.sq_dist = fn
            try:
                ts = convert.odometry_state_from_numpy(host, "cpu")
                _, to = todo.odometry_step(ts, tf, tcfg)
            finally:
                voxel.sq_dist = direct
            dt = np.abs(to.rel.trans.numpy() - np.asarray(jo.rel.trans)).max()
            print(f"seed {seed} {name:8s}: |d rel trans| {dt:.3e} m  "
                  f"reference {np.asarray(jo.rel.trans)}  port {to.rel.trans.numpy()}")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [40, 3])
