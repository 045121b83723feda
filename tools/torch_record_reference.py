"""Record the JAX package's full-width runs that chip_smoke.py phase (i)
and tests/test_torch_fullwidth.py hold the PyTorch port against.

Run from the repository root on a machine with JAX (the port never imports it):

    python tools/torch_record_reference.py [--out PATH]

It runs the reference (scaloam_tpu) on the CPU with its selection and
odometry Pallas kernels on, in interpret mode (the port's kernels are
their counterparts), on the inputs chip_smoke.py makes, and writes one
compressed file, by default tests/data_torch_fullwidth_reference.npz:

- R1, the main path: kitti_hdl64 at its full configuration through
  `frontend_step` over chip_smoke.py's 12-frame HDL-64 drive;
- R2, (g1)'s presets: vlp16 (1800 columns), hdl32 and mulran_os1_64 (2048)
  over the same course with each preset's beams;
  for each frame of R1 and R2: the odometry and mapped poses, the gate's
  fire, the degenerate flag, the keyframe cloud's point count, the four
  feature clouds' counts, the overflow count and K1's corner and flat
  picks (indices and ok flags);
- R3, (g2)'s MulRan CLI with GPS: `scaloam_tpu.run.main(["--preset",
  "mulran_os1_64", "--mulran-dir", d, "--use-gps", "--out", o])` over the
  60-frame OS1-64 course written in MulRan's layout under
  build/record_reference/: the keyframes' frame indices, every loop
  verification (pair, ICP fitness, accepted), the accepted loops, the GPS
  factors, optimized_poses.txt and the ATE against the course's poses;
- R4, (a)'s pose graph: one `optimize` from the drifted circle chains at
  each tier of PGO_TIERS below: the optimised quaternions and positions.

Every input is stored as its sha256 (float32 bytes of each scan; a
chain's odometry and loops), beside the provenance: the Python, JAX,
jaxlib and numpy versions, the commit and each configuration as a dict.
The file is written with fixed zip timestamps, so a second run on the same
machine writes the same bytes apart from the commit in the provenance.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import platform
import subprocess
import sys
import time
import zipfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (input makers, tolerances' file name)

# The pose-graph tiers recorded (nodes, loops): all three of chip_smoke's
# (a), the Woodbury tier and the large chain-CG tier included.
PGO_TIERS = chip_smoke.PGO_TIERS
# The CLI result's fields that do not depend on the host's speed.
RESULT_KEYS = ("frames", "keyframes", "loops", "degenerate_frames")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def kernel_cfg(cfg):
    """cfg with the reference's two Pallas kernels switched on."""
    return cfg.replace(
        features=dataclasses.replace(cfg.features, use_pallas_selection="on"),
        odometry=dataclasses.replace(cfg.odometry, fused_gn_kernel="on"))


def interpret_kernels():
    """Route both Pallas kernels through interpret mode (the CPU has no
    Mosaic), as tests/test_pallas_gn.py and test_pallas_selection.py do."""
    from scaloam_tpu.ops.pallas import gn_odometry, selection

    def interpret(fn):
        return lambda *a, **k: fn(*a, **{**k, "interpret": True})

    selection.select_features = interpret(selection.select_features)
    gn_odometry.associate_and_solve = interpret(gn_odometry.associate_and_solve)


def record_frontend(name, cols):
    """One front-end drive (R1 or R2) at a preset's full configuration."""
    jax = _jax()
    from scaloam_tpu import config
    from scaloam_tpu.models import frontend
    from scaloam_tpu.ops import features
    from scaloam_tpu.ops.pallas import selection
    from scaloam_tpu.types import LidarScan
    from scaloam_tpu.utils import synthetic

    cfg = kernel_cfg(config.PRESETS[name]())
    scans, _ = chip_smoke.preset_drive(synthetic, cfg.sensor, cols)
    picks, counts = [], []
    select, extract = selection.select_features, features.extract_features

    def spy_select(*a, **k):
        out = select(*a, **k)
        jax.debug.callback(lambda *p: picks.append([np.asarray(x) for x in p]), *out[:4])
        return out

    def spy_extract(scan, cfg):
        f = extract(scan, cfg)
        c = [f.sharp.mask.sum(), f.less_sharp.mask.sum(), f.flat.mask.sum(),
             f.less_flat.mask.sum(), f.overflow]
        jax.debug.callback(lambda *v: counts.append([int(x) for x in v]), *c)
        return f

    selection.select_features, features.extract_features = spy_select, spy_extract
    try:
        state = frontend.init_state(cfg)
        outs = []
        for pts in scans:
            state, out = frontend.frontend_step(
                state, LidarScan.from_numpy(pts, cfg.sensor.max_points), cfg)
            jax.effects_barrier()
            outs.append(jax.tree.map(np.asarray, out))
    finally:
        selection.select_features, features.extract_features = select, extract
    if not (len(picks) == len(counts) == len(scans)):
        raise RuntimeError(f"{name}: {len(picks)} pick and {len(counts)} count records "
                           f"for {len(scans)} frames")
    counts = np.asarray(counts, np.int32)
    rec = {
        "odom_q": np.stack([o.odom_world.quat for o in outs]),
        "odom_t": np.stack([o.odom_world.trans for o in outs]),
        "map_q": np.stack([o.mapped_pose.quat for o in outs]),
        "map_t": np.stack([o.mapped_pose.trans for o in outs]),
        "fire": np.array([bool(o.fire) for o in outs]),
        "degenerate": np.array([bool(o.degenerate) for o in outs]),
        "kf_count": np.array([int(o.kf_mask.sum()) for o in outs], np.int32),
        "feat_counts": counts[:, :4], "overflow": counts[:, 4],
        "corner_idx": np.stack([p[0] for p in picks]).astype(np.int16),
        "corner_ok": np.stack([p[1] for p in picks]).astype(bool),
        "flat_idx": np.stack([p[2] for p in picks]).astype(np.int16),
        "flat_ok": np.stack([p[3] for p in picks]).astype(bool),
        "scan_sha256": np.array([chip_smoke.sha256_f32(s) for s in scans]),
    }
    return rec, {"preset": name, "columns": cols, "frames": len(scans),
                 "config": dataclasses.asdict(cfg)}


def record_mulran(work):
    """R3: the reference's CLI over (g2)'s course in MulRan's layout."""
    import shutil

    _jax()
    from scaloam_tpu import config, run
    from scaloam_tpu.models import pipeline
    from scaloam_tpu.ops import icp
    from scaloam_tpu.utils import synthetic
    from scaloam_tpu.utils.evaluation import ate_rmse

    shutil.rmtree(work, ignore_errors=True)
    seq, out = os.path.join(work, "seq"), os.path.join(work, "out")
    made = [chip_smoke.mulran_frame(synthetic, i) for i in range(chip_smoke.G2_FRAMES)]
    scans, gt = [m[0] for m in made], np.stack([m[1] for m in made])
    stamps = chip_smoke.write_mulran(seq, scans, gt)

    systems, verify, last = [], [], []
    verify_loop = icp.verify_loop

    def spy_verify_loop(*a, **k):
        res = verify_loop(*a, **k)
        last.append(res[0])
        return res

    class Recorded(pipeline.SlamSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            systems.append(self)

        def _icp_verify(self, curr, loop_idx, yaw, poses=None):
            z = super()._icp_verify(curr, loop_idx, yaw, poses=poses)
            verify.append((curr, loop_idx, float(np.asarray(last[-1].fitness)), z is not None))
            return z

    preset = config.PRESETS["mulran_os1_64"]
    system_cls = pipeline.SlamSystem
    config.PRESETS["mulran_os1_64"] = lambda: kernel_cfg(preset())
    pipeline.SlamSystem, icp.verify_loop = Recorded, spy_verify_loop
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run.main(["--preset", "mulran_os1_64", "--mulran-dir", seq, "--use-gps",
                           "--out", out])
    finally:
        config.PRESETS["mulran_os1_64"] = preset
        pipeline.SlamSystem, icp.verify_loop = system_cls, verify_loop
    if rc != 0:
        raise RuntimeError(f"R3: run.main exit code {rc}")
    (s,) = systems
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    est = np.loadtxt(os.path.join(out, "optimized_poses.txt")).reshape(-1, 3, 4)
    rec = {
        "keyframes": np.array([kf.frame for kf in s.keyframes], np.int32),
        "verify": np.array([v[:2] for v in verify], np.int32).reshape(-1, 2),
        "verify_fitness": np.array([v[2] for v in verify], np.float32),
        "verify_accepted": np.array([v[3] for v in verify], bool),
        "loops": np.array(s.loops_found, np.int32).reshape(-1, 2),
        "gps_factors": np.int32(int(np.asarray(s.graph.gps_valid).sum())),
        "optimized_poses": est,
        "ate_m": np.float64(chip_smoke.mulran_ate(out, stamps, gt, ate_rmse)),
        "scan_sha256": np.array([chip_smoke.sha256_f32(x) for x in scans]),
        "result": np.array(json.dumps({k: result[k] for k in RESULT_KEYS})),
    }
    return rec, {"argv": ["--preset", "mulran_os1_64", "--mulran-dir", "<seq>", "--use-gps",
                          "--out", "<out>"], "frames": len(scans),
                 "config": dataclasses.asdict(kernel_cfg(preset()))}


def record_pose_graph(n, n_loops):
    """R4: one optimise of a circle chain from its drifted odometry."""
    _jax()
    import jax.numpy as jnp

    from scaloam_tpu import config
    from scaloam_tpu.models import posegraph as pg
    from scaloam_tpu.types import Pose

    _, oq, ot, loops = chip_smoke.circle_chain(n, n_loops, seed=n)
    cfg = chip_smoke.chain_pgo_cfg(config.PGOConfig(), n, n_loops)
    g = pg.init_graph(cfg, initial_nodes=n, initial_loops=n_loops)
    for k in range(n):
        g = pg.add_keyframe(g, Pose(jnp.asarray(oq[k]), jnp.asarray(ot[k])), np.float32(0.0),
                            np.bool_(False), n_nodes=k)
    ident = Pose.identity()
    for m, (i, j) in enumerate(loops):
        g = pg.add_loop(g, jnp.int32(i), jnp.int32(j), ident, n_loops=m)
    g = pg.optimize(g, cfg)
    rec = {"quat": np.asarray(g.poses.quat), "trans": np.asarray(g.poses.trans),
           "chain_sha256": np.array(chip_smoke.chain_sha256(oq, ot, loops))}
    return rec, {"nodes": n, "loops": n_loops, "config": dataclasses.asdict(cfg)}


def write_npz(path, arrays):
    """np.savez_compressed's format with fixed entry timestamps, entries
    sorted by name."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[name]), allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            zf.writestr(info, buf.getvalue(), compresslevel=9)


def _commit():
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, chip_smoke.REFERENCE_NPZ))
    args = ap.parse_args(argv)
    jax = _jax()
    import jaxlib

    interpret_kernels()
    arrays, drives, seconds = {}, {}, {}

    def put(drive, rec, info):
        arrays.update({f"{drive}.{k}": v for k, v in rec.items()})
        drives[drive] = info

    for drive, (name, cols) in [("R1", ("kitti_hdl64", chip_smoke.MAIN_COLS))] + [
            (f"R2.{p}", (p, c)) for p, c in chip_smoke.G_PRESETS]:
        t0 = time.perf_counter()
        put(drive, *record_frontend(name, cols))
        seconds[drive] = time.perf_counter() - t0
        print(f"{drive}: {seconds[drive]:.1f} s", flush=True)
    t0 = time.perf_counter()
    put("R3", *record_mulran(os.path.join(ROOT, "build", "record_reference")))
    seconds["R3"] = time.perf_counter() - t0
    print(f"R3: {seconds['R3']:.1f} s", flush=True)
    for n, n_loops in PGO_TIERS:
        t0 = time.perf_counter()
        put(f"R4.{n}", *record_pose_graph(n, n_loops))
        seconds[f"R4.{n}"] = time.perf_counter() - t0
        print(f"R4.{n}: {seconds[f'R4.{n}']:.1f} s", flush=True)
    meta = {
        "format": 1, "tool": "tools/torch_record_reference.py", "commit": _commit(),
        "versions": {"python": platform.python_version(), "jax": jax.__version__,
                     "jaxlib": jaxlib.__version__, "numpy": np.__version__},
        "kernels": "selection and gn_odometry Pallas kernels on, interpret mode",
        "drives": drives,
    }
    arrays["meta"] = np.array(json.dumps(meta, sort_keys=True))
    write_npz(args.out, arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out), "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
