"""Where the port's full-width runs depart from the JAX package's, and how
far the reference departs from itself (CPU only).

Run from the repository root:

    python tools/torch_departure_probe.py odometry [--preset P ...] [--frame K]
    python tools/torch_departure_probe.py mapping [--preset P ...] [--frame K]
    python tools/torch_departure_probe.py drive [--drive R1 R2.vlp16 ...]
    python tools/torch_departure_probe.py deskew

odometry: on chip_smoke.py's drive at a preset's full configuration, the
reference's odometry step on frame K (default 1) from its own state after
frames 0 .. K - 1, through its Pallas kernel (interpret mode) and through
its XLA path; the port's step from the same state (convert.py) on the
reference's features, with its 2-NN distances (`f32ops.sq_dist`, the
reference's rounding) and with the form it had before (torch.sum squared
norms and a BLAS matmul, `blas_sq_dist`). Prints the translation gaps and
each candidate row whose winner differs from the reference's, with the
gap between the two competing squared distances in float32 ulps of
|q|^2 + |t|^2 (the size they are rounded at before the cancellation).

mapping: the mapping step of frame K from the reference's front-end state
after frames 0 .. K - 1, in both packages on the same odometry pose and
clouds: the mapped-pose gap, the surf correspondences, and the plane
normals of the first association against a float64 eigen solve of the
same neighbourhoods (the largest angle for each package).

drive: per frame of a recorded drive, the port's CPU front end against
the recording (tests/data_torch_fullwidth_reference.npz) beside the
reference's own XLA odometry path against its Pallas path.

deskew: tests/test_torch_deskew.py's skewed 4-frame drive (reduced HDL-64,
distortion on): per frame the free drive's gap and the gap of the port's
step from the reference's state; then the reference's own frame-3 solve
with its target clouds jittered by 4e-6 m (four seeds).
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def blas_sq_dist(query, target):
    """The 2-NN distance the port used before: squared norms by
    torch.sum, the dot products by torch.matmul (BLAS / cuBLAS order)."""
    import torch

    q2 = torch.sum(query * query, dim=-1, keepdim=True)
    t2 = torch.sum(target * target, dim=-1)[None, :]
    return q2 + t2 - 2.0 * torch.matmul(query, target.T)


def odometry(name, frame):
    import jax
    import jax.numpy as jnp
    import torch

    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import odometry as jodo
    from scaloam_tpu.ops import features as jfeat
    from scaloam_tpu.types import LidarScan as JScan
    from scaloam_tpu.utils import synthetic
    from scaloam_tpu_torch import config as tconfig, convert
    from scaloam_tpu_torch.models import odometry as todo
    from scaloam_tpu_torch.ops.kernels import f32ops
    from scaloam_tpu_torch.types import FeatureCloud, RangeImage, ScanFeatures
    from tools.torch_record_reference import kernel_cfg

    cfg = kernel_cfg(jconfig.PRESETS[name]())
    cfg_xla = cfg.replace(odometry=dataclasses.replace(cfg.odometry, fused_gn_kernel="off"))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    cols = dict(chip_smoke.G_PRESETS).get(name, chip_smoke.MAIN_COLS)
    scans, _ = chip_smoke.preset_drive(synthetic, cfg.sensor, cols, n_frames=frame + 1)
    feats = [jfeat.extract_features(JScan.from_numpy(s, cfg.sensor.max_points), cfg)
             for s in scans]
    state = jodo.init_state(cfg)
    for f in feats[:frame]:
        state, _ = jodo.odometry_step(state, f, cfg)
    host = jax.tree.map(np.array, state)
    _, want = jodo.odometry_step(jax.tree.map(jnp.asarray, host), feats[frame], cfg)
    _, xla = jodo.odometry_step(jax.tree.map(jnp.asarray, host), feats[frame], cfg_xla)
    jc, js = jodo._sweep_candidates(jax.tree.map(jnp.asarray, host).rel, feats[frame],
                                    jax.tree.map(jnp.asarray, host), cfg)

    def tcloud(c):
        return FeatureCloud(*[torch.as_tensor(np.array(getattr(c, f))) for f in FeatureCloud._fields])

    f1 = feats[frame]
    tfeats = ScanFeatures(
        *[tcloud(getattr(f1, n)) for n in ("sharp", "less_sharp", "flat", "less_flat")],
        full=RangeImage(*[torch.as_tensor(np.array(getattr(f1.full, f)))
                          for f in RangeImage._fields]),
        overflow=torch.as_tensor(np.array(f1.overflow)))
    tstate = convert.odometry_state_from_numpy(host, "cpu")
    want_t = np.asarray(want.rel.trans)
    row = {"preset": name, "frame": frame, "xla_vs_pallas_m": float(np.abs(np.asarray(xla.rel.trans) - want_t).max()),
           "counts": [int(want.n_corner_corr), int(want.n_surf_corr)]}
    sq_dist = f32ops.sq_dist
    for label, fn in (("port", sq_dist), ("port_blas_sq_dist", blas_sq_dist)):
        f32ops.sq_dist = fn
        try:
            _, got = todo.odometry_step(tstate, tfeats, tcfg)
            tc, tsc = todo._sweep_candidates(tstate.rel, tfeats, tstate, tcfg)
        finally:
            f32ops.sq_dist = sq_dist
        row[label + "_vs_pallas_m"] = float(np.abs(got.rel.trans.numpy() - want_t).max())
        row[label + "_counts"] = [int(got.n_corner_corr), int(got.n_surf_corr)]
        flips = []
        for cloud, jcand, tcand in ((tfeats.sharp, jc, tc), (tfeats.flat, js, tsc)):
            q = todo.residuals.transform_points(tstate.rel, cloud.xyz)  # the sweep's queries
            for k, (a, b) in enumerate(zip(jcand, tcand)):
                a, b = np.array(a), b.numpy()
                for r in np.nonzero(np.any(a != b, axis=(1, 2)))[0]:
                    slot = int(np.nonzero(np.any(a[r] != b[r], axis=1))[0][0])
                    pts = torch.as_tensor(np.stack([a[r, slot], b[r, slot]]))
                    d = sq_dist(q[r:r + 1], pts)[0].numpy()
                    # The gap in ulps of |q|^2 + |t|^2, the size the distance
                    # is rounded at before the cancellation.
                    scale = np.float32(np.sum(q[r].numpy() ** 2) + np.sum(pts.numpy() ** 2, 1).max())
                    flips.append({"class": "corner" if cloud is tfeats.sharp else "surf",
                                  "list": k, "row": int(r), "slot": slot,
                                  "d_reference_winner": float(d[0]),
                                  "d_other_winner": float(d[1]),
                                  "gap_ulps": float(abs(d[0] - d[1]) / np.spacing(scale))})
        row[label + "_candidate_flips"] = flips
    return row


def _angle_deg(a, b):
    dot = np.abs(np.sum(a * b, axis=-1))
    norm = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return np.degrees(np.arccos(np.clip(dot / np.maximum(norm, 1e-30), 0.0, 1.0)))


def mapping(name, frame):
    import functools

    import jax
    import jax.numpy as jnp
    import torch

    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import frontend as jfront, mapping as jmap, odometry as jodo
    from scaloam_tpu.ops import features as jfeat, voxel as jvox
    from scaloam_tpu.types import LidarScan as JScan
    from scaloam_tpu.utils import synthetic
    from scaloam_tpu_torch import config as tconfig, convert
    from scaloam_tpu_torch.models import mapping as tmap
    from scaloam_tpu_torch.ops import se3 as tse3, voxel as tvox
    from scaloam_tpu_torch.types import FeatureCloud
    from tools.torch_record_reference import kernel_cfg

    cfg = kernel_cfg(jconfig.PRESETS[name]())
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    m = cfg.mapping
    cols = dict(chip_smoke.G_PRESETS).get(name, chip_smoke.MAIN_COLS)
    scans, _ = chip_smoke.preset_drive(synthetic, cfg.sensor, cols, n_frames=frame + 1)
    state = jfront.init_state(cfg)
    for pts in scans[:frame]:
        state, _ = jfront.frontend_step(state, JScan.from_numpy(pts, cfg.sensor.max_points), cfg)
    host = jax.tree.map(np.array, state)
    feats = jfeat.extract_features(JScan.from_numpy(scans[frame], cfg.sensor.max_points), cfg)
    o_state, o_out = jodo.odometry_step(jax.tree.map(jnp.asarray, host.o), feats, cfg)
    o_host = jax.tree.map(np.array, (o_state, o_out))
    j_ms = jax.tree.map(jnp.asarray, host.m)
    _, jm = jmap.mapping_step(jax.tree.map(jnp.asarray, host.m), o_out.world, o_state.last_corner,
                              o_state.last_surf, cfg)  # donates its state
    t_ms = convert.state_from_numpy(host, "cpu").m

    def tcloud(c):
        return FeatureCloud(*[torch.as_tensor(np.array(getattr(c, f))) for f in FeatureCloud._fields])

    odom = convert.pose_from_numpy(o_host[1].world, "cpu")
    surf = tcloud(o_host[0].last_surf)
    _, tm = tmap.mapping_step(t_ms, odom, tcloud(o_host[0].last_corner), surf, tcfg)
    # The first surf association of both, from the same prior and inputs.
    packed = jax.jit(jvox.voxel_downsample_packed, static_argnums=(2, 3),
                     static_argnames=("xy_bits", "z_bits"))
    jx, jmask, _ = packed(o_state.last_surf.xyz, o_state.last_surf.mask, m.plane_resolution,
                          m.max_surf_input, xy_bits=10, z_bits=9)
    prior_j = jmap.se3.compose(j_ms.correction, o_out.world)
    j_nb8 = jax.jit(functools.partial(jmap._candidates, mcfg=m))(prior_j, jx, jmask, j_ms.surf_grid)
    j_n, _, j_ok = jax.jit(functools.partial(jmap._surf_correspond, mcfg=m))(prior_j, jx, jmask, j_nb8)
    _, j_nb = jax.jit(lambda p, x, c: jmap._rerank(p, x, c, m.knn))(prior_j, jx, j_nb8)
    tx, tmask, _ = tvox.voxel_downsample_packed(surf.xyz, surf.mask, m.plane_resolution,
                                                m.max_surf_input, xy_bits=10, z_bits=9)
    prior_t = tse3.compose(t_ms.correction, odom)
    t_nb8 = tmap._candidates(prior_t, tx, tmask, t_ms.surf_grid, m)
    t_n, _, t_ok = tmap._surf_correspond(prior_t, tx, tmask, t_nb8, m)
    nb = np.asarray(j_nb).astype(np.float64)
    centred = nb - nb.mean(axis=1, keepdims=True)
    _, vecs = np.linalg.eigh(np.einsum("nki,nkj->nij", centred, centred) / nb.shape[1])
    n64, j_n, t_n = vecs[:, :, 0], np.asarray(j_n), t_n.numpy()
    both = np.asarray(j_ok) & t_ok.numpy()
    return {"preset": name, "frame": frame, "stage": "mapping",
            "mapped_dt_m": float(np.abs(tm.pose.trans.numpy() - np.asarray(jm.pose.trans)).max()),
            "surf_corr": [int(tm.n_surf_corr), int(jm.n_surf_corr)],
            "inputs_equal": bool(np.array_equal(np.asarray(jx), tx.numpy())),
            "candidates_equal": bool(np.array_equal(np.asarray(j_nb8), t_nb8.numpy())),
            "first_surf_valid_differ": int((np.asarray(j_ok) != t_ok.numpy()).sum()),
            "normal_deg_reference_vs_f64": float(_angle_deg(j_n[both], n64[both]).max()),
            "normal_deg_port_vs_f64": float(_angle_deg(t_n[both], n64[both]).max()),
            "normal_deg_port_vs_reference": float(_angle_deg(t_n[both], j_n[both]).max())}


def drive(name):
    import jax
    import torch

    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import frontend as jfront
    from scaloam_tpu.types import LidarScan as JScan
    from scaloam_tpu.utils import synthetic
    from scaloam_tpu_torch import config as tconfig
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.types import LidarScan as TScan
    from tools.torch_record_reference import kernel_cfg

    meta, arrays = chip_smoke.load_reference()
    info, want = meta["drives"][name], chip_smoke.drive_arrays(arrays, name)
    cfg = kernel_cfg(jconfig.PRESETS[info["preset"]]())
    cfg = cfg.replace(odometry=dataclasses.replace(cfg.odometry, fused_gn_kernel="off"))
    scans, _ = chip_smoke.preset_drive(synthetic, cfg.sensor, info["columns"])
    state, xla = jfront.init_state(cfg), []
    for pts in scans:
        state, out = jfront.frontend_step(state, JScan.from_numpy(pts, cfg.sensor.max_points), cfg)
        xla.append(jax.tree.map(np.asarray, (out.odom_world.trans, out.mapped_pose.trans)))
    fe = FrontEnd(tconfig.PRESETS[info["preset"]](), device="cpu")
    with torch.no_grad():
        port = [fe.step(*TScan.from_numpy(p, cfg.sensor.max_points, "cpu")) for p in scans]
    rows = []
    for i, ((xo, xm), o) in enumerate(zip(xla, port)):
        rows.append({"drive": name, "frame": i,
                     "xla_vs_pallas_odom_m": float(np.abs(xo - want["odom_t"][i]).max()),
                     "xla_vs_pallas_map_m": float(np.abs(xm - want["map_t"][i]).max()),
                     "port_odom_m": float(np.abs(o.odom_world.trans.numpy() - want["odom_t"][i]).max()),
                     "port_map_m": float(np.abs(o.mapped_pose.trans.numpy() - want["map_t"][i]).max())})
    return rows


def deskew():
    import jax
    import jax.numpy as jnp
    import torch

    from scaloam_tpu import config as jconfig
    from scaloam_tpu.models import odometry as jodo
    from scaloam_tpu.ops import features as jfeat
    from scaloam_tpu.types import LidarScan as JScan
    from scaloam_tpu.utils import synthetic
    from scaloam_tpu_torch import config as tconfig, convert
    from scaloam_tpu_torch.models import odometry as todo
    from scaloam_tpu_torch.ops import features as tfeat
    from scaloam_tpu_torch.types import LidarScan as TScan

    cfg = jconfig.kitti_hdl64()
    cfg = cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, max_points=16384, max_points_per_ring=384),
        features=dataclasses.replace(cfg.features, use_pallas_selection="on", max_sharp=768,
                                     max_less_sharp=2048, max_flat=1536, max_less_flat=8192),
        odometry=dataclasses.replace(cfg.odometry, distortion=True))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    scans, _ = synthetic.simulate_trajectory(
        synthetic.make_world(seed=3), n_frames=4, speed=0.6, radius=30.0, n_azimuth=256,
        seed=10, skew=True, accel=0.25)
    cap = cfg.sensor.max_points
    js, ts, rows, states = jodo.init_state(cfg), todo.init_state(tcfg, "cpu"), [], []
    for i, pts in enumerate(scans):
        states.append(jax.tree.map(np.array, js))
        jf = jfeat.extract_features(JScan.from_numpy(pts, cap), cfg)
        tf = tfeat.extract_features(TScan.from_numpy(pts, cap, "cpu"), tcfg)
        js, jo = jodo.odometry_step(js, jf, cfg)
        with torch.no_grad():
            ts, to = todo.odometry_step(ts, tf, tcfg)
            _, so = todo.odometry_step(convert.odometry_state_from_numpy(states[-1], "cpu"), tf, tcfg)
        want = np.asarray(jo.rel.trans)
        rows.append({"stage": "deskew", "frame": i,
                     "free_drive_rel_m": float(np.abs(to.rel.trans.numpy() - want).max()),
                     "shared_state_rel_m": float(np.abs(so.rel.trans.numpy() - want).max())})
    rng = np.random.default_rng(0)
    feats3 = jfeat.extract_features(JScan.from_numpy(scans[3], cap), cfg)
    _, base = jodo.odometry_step(jax.tree.map(jnp.asarray, states[3]), feats3, cfg)
    moved = []
    for _ in range(4):
        h = states[3]
        h = h._replace(**{c: getattr(h, c)._replace(xyz=(getattr(h, c).xyz + rng.normal(
            0, 4e-6, getattr(h, c).xyz.shape)).astype(np.float32)) for c in ("last_surf", "last_corner")})
        _, out = jodo.odometry_step(jax.tree.map(jnp.asarray, h), feats3, cfg)
        moved.append(float(np.abs(np.asarray(out.rel.trans) - np.asarray(base.rel.trans)).max()))
    rows.append({"stage": "deskew", "frame": 3, "reference_jitter_4e-6_m_moves_rel_m": moved})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", choices=("odometry", "mapping", "drive", "deskew"))
    ap.add_argument("--preset", nargs="+", default=["kitti_hdl64", "mulran_os1_64"])
    ap.add_argument("--frame", type=int, default=1)
    ap.add_argument("--drive", nargs="+", default=["R1"])
    args = ap.parse_args(argv)
    import jax

    from tools.torch_record_reference import interpret_kernels

    jax.config.update("jax_platforms", "cpu")
    interpret_kernels()
    if args.stage == "drive":
        rows = [r for name in args.drive for r in drive(name)]
    elif args.stage == "deskew":
        rows = deskew()
    else:
        probe = odometry if args.stage == "odometry" else mapping
        rows = [probe(name, args.frame) for name in args.preset]
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
