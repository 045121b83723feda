"""The port's full-width runs against the JAX package's recorded runs of
the same configurations on the same inputs.

tests/data_torch_fullwidth_reference.npz is written by
tools/torch_record_reference.py from the reference on the CPU (its Pallas
kernels on, in interpret mode); chip_smoke.py phase (i) holds the card's
runs to the same recording with the same comparison functions, which
live in chip_smoke.py with their tolerances (its I_* constants):
odometry and mapped poses within 5e-4 (quaternion) / 5e-3 m on every
frame, the gate's fire and the degenerate flag equal, feature, overflow
and keyframe-cloud counts within max(1, 1 %), K1's picks equal or a
curvature near-tie within 4 float32 ulps; R4's optimised positions within
1e-3 m.

Tier-1 runs the port on the CPU over R1's first three frames at the full
kitti_hdl64 configuration; all of R1, R2 and R4 and the tool's
reproduction of the file are `slow`.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from scaloam_tpu import config as jconfig

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from tools.torch_record_reference import kernel_cfg  # noqa: E402
from scaloam_tpu_torch import config as tconfig  # noqa: E402
from scaloam_tpu_torch.utils import synthetic as tsynthetic  # noqa: E402

REF = REPO / chip_smoke.REFERENCE_NPZ
MAX_BYTES = 2 * 1024 * 1024
FIRST_FRAMES = 3
FRONT_DRIVES = ["R1"] + [f"R2.{name}" for name, _ in chip_smoke.G_PRESETS]
PRESET_OF = {"R1": ("kitti_hdl64", chip_smoke.MAIN_COLS),
             **{f"R2.{name}": (name, cols) for name, cols in chip_smoke.G_PRESETS}}
FRONT_KEYS = ("odom_q", "odom_t", "map_q", "map_t", "fire", "degenerate", "kf_count",
              "feat_counts", "overflow", "corner_idx", "corner_ok", "flat_idx", "flat_ok",
              "scan_sha256")


@pytest.fixture(scope="module")
def reference():
    return chip_smoke.load_reference(str(REF))


def _kernel_cfg_dict(cfg):
    """The recorded configuration's form: the preset with both Pallas
    kernels on, through JSON."""
    return json.loads(json.dumps(dataclasses.asdict(kernel_cfg(cfg))))


def test_recording_schema_and_provenance(reference):
    meta, arrays = reference
    assert REF.stat().st_size <= MAX_BYTES
    assert meta["tool"] == "tools/torch_record_reference.py" and meta["format"] == 1
    assert isinstance(meta["commit"], str) and len(meta["commit"]) == 40
    assert set(meta["versions"]) == {"python", "jax", "jaxlib", "numpy"}
    assert "interpret" in meta["kernels"]
    r4 = sorted(d for d in meta["drives"] if d.startswith("R4."))
    assert set(meta["drives"]) == set(FRONT_DRIVES) | {"R3"} | set(r4)
    assert r4 == sorted(f"R4.{n}" for n, _ in chip_smoke.PGO_TIERS)
    for drive in FRONT_DRIVES:
        name, cols = PRESET_OF[drive]
        info = meta["drives"][drive]
        assert (info["preset"], info["columns"], info["frames"]) == (name, cols, chip_smoke.N_FRAMES)
        cfg = jconfig.PRESETS[name]()
        assert info["config"] == _kernel_cfg_dict(cfg)
        got = chip_smoke.drive_arrays(arrays, drive)
        assert set(got) == set(FRONT_KEYS), drive
        F, S = chip_smoke.N_FRAMES, cfg.sensor.n_scans
        feat = cfg.features
        assert got["odom_t"].shape == got["map_t"].shape == (F, 3)
        assert got["odom_q"].shape == got["map_q"].shape == (F, 4)
        assert got["feat_counts"].shape == (F, 4) and got["overflow"].shape == (F,)
        assert got["corner_idx"].shape == (F, S, feat.n_subregions, feat.less_sharp_per_subregion)
        assert got["flat_idx"].shape == (F, S, feat.n_subregions, feat.flat_per_subregion)
        assert got["fire"].dtype == bool and got["fire"].sum() >= 1
        assert np.isfinite(got["map_t"]).all() and (got["feat_counts"] > 0).all()
    assert meta["drives"]["R3"]["config"] == _kernel_cfg_dict(jconfig.mulran_os1_64())
    r3 = chip_smoke.drive_arrays(arrays, "R3")
    K = len(r3["keyframes"])
    assert r3["optimized_poses"].shape == (K, 3, 4) and len(r3["scan_sha256"]) == chip_smoke.G2_FRAMES
    assert len(r3["loops"]) >= 1 and int(r3["gps_factors"]) >= 1
    assert len(r3["verify"]) == len(r3["verify_fitness"]) == len(r3["verify_accepted"])
    assert int(r3["verify_accepted"].sum()) == len(r3["loops"])
    assert json.loads(str(r3["result"]))["keyframes"] == K
    for drive in r4:
        n = meta["drives"][drive]["nodes"]
        got = chip_smoke.drive_arrays(arrays, drive)
        assert got["trans"].shape == (n, 3) and got["quat"].shape == (n, 4)


@pytest.mark.parametrize("drive", FRONT_DRIVES + ["R3"] + [f"R4.{n}" for n, _ in chip_smoke.PGO_TIERS])
def test_input_hashes_match_the_ports_generator(reference, drive):
    """The first frame of each drive (or a chain) made with the port's
    utils/synthetic.py hashes as the recorded input."""
    arrays = reference[1]
    want = chip_smoke.drive_arrays(arrays, drive)
    if drive.startswith("R4."):
        n = reference[0]["drives"][drive]["nodes"]
        _, oq, ot, loops = chip_smoke.circle_chain(n, reference[0]["drives"][drive]["loops"], seed=n)
        assert chip_smoke.chain_sha256(oq, ot, loops) == str(want["chain_sha256"])
        return
    if drive == "R3":
        pts, _ = chip_smoke.mulran_frame(tsynthetic, 0)
    else:
        name, cols = PRESET_OF[drive]
        scans, _ = chip_smoke.preset_drive(tsynthetic, tconfig.PRESETS[name]().sensor, cols,
                                           n_frames=1)
        pts = scans[0]
    assert chip_smoke.sha256_f32(pts) == str(want["scan_sha256"][0])


def _port_drive(name, cols, n_frames):
    """The port's FrontEnd on the CPU over a drive's first frames at the
    preset's full configuration, in the recording's layout."""
    from scaloam_tpu_torch.models.frontend import FrontEnd
    from scaloam_tpu_torch.types import LidarScan

    cfg = tconfig.PRESETS[name]()
    scans, _ = chip_smoke.preset_drive(tsynthetic, cfg.sensor, cols, n_frames=n_frames)
    fe = FrontEnd(cfg, device="cpu")
    with chip_smoke.capture_frames() as frames:
        outs = [fe.step(*LidarScan.from_numpy(s, cfg.sensor.max_points, "cpu")) for s in scans]
    rec = chip_smoke.frontend_record(outs, frames)
    rec["scan_sha256"] = [chip_smoke.sha256_f32(s) for s in scans]
    return rec


@pytest.fixture(scope="module")
def r1_first_frames():
    with torch.no_grad():
        return _port_drive("kitti_hdl64", chip_smoke.MAIN_COLS, FIRST_FRAMES)


def _first(want, n):
    return {k: v[:n] for k, v in want.items()}


def test_port_matches_r1_first_frames(reference, r1_first_frames):
    want = _first(chip_smoke.drive_arrays(reference[1], "R1"), FIRST_FRAMES)
    chip_smoke.check_hashes("R1", want["scan_sha256"], r1_first_frames["scan_sha256"])
    row = chip_smoke.compare_frontend("R1 frames 0-2 (CPU)", want, r1_first_frames)
    assert row["k1_picks_differ"] == 0


@pytest.mark.parametrize("plant", ["pose", "pick"])
def test_planted_departure_is_caught(reference, r1_first_frames, plant):
    want = _first(chip_smoke.drive_arrays(reference[1], "R1"), FIRST_FRAMES)
    want = {k: np.array(v, copy=True) for k, v in want.items()}
    if plant == "pose":
        want["map_t"][1, 0] += 1e-2
        match = "map pose"
    else:
        # Swap two picks of one row whose curvatures are far apart.
        idx, ok, curv = want["corner_idx"][0], want["corner_ok"][0], r1_first_frames["curv"][0]
        r = int(np.nonzero(ok[:, 0, 0] & ok[:, 1, 0])[0][0])
        a, b = int(idx[r, 0, 0]), int(idx[r, 1, 0])
        assert abs(curv[r, a] - curv[r, b]) > 1e3 * np.spacing(np.float32(max(curv[r, a], curv[r, b])))
        idx[r, 0, 0], idx[r, 1, 0] = b, a
        match = "near-tie"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.compare_frontend("R1 planted", want, r1_first_frames)


@pytest.mark.slow
@pytest.mark.parametrize("drive", FRONT_DRIVES)
def test_port_matches_whole_frontend_drive(reference, drive):
    name, cols = PRESET_OF[drive]
    want = chip_smoke.drive_arrays(reference[1], drive)
    with torch.no_grad():
        got = _port_drive(name, cols, chip_smoke.N_FRAMES)
    chip_smoke.check_hashes(drive, want["scan_sha256"], got["scan_sha256"])
    chip_smoke.compare_frontend(f"{drive} (CPU)", want, got)


@pytest.mark.slow
@pytest.mark.parametrize("nodes", [n for n, _ in chip_smoke.PGO_TIERS])
def test_port_matches_recorded_optimise(reference, nodes):
    from scaloam_tpu_torch.models import posegraph as pg
    from scaloam_tpu_torch.types import Pose

    drive = f"R4.{nodes}"
    info = reference[0]["drives"][drive]
    _, oq, ot, loops = chip_smoke.circle_chain(nodes, info["loops"], seed=nodes)
    cfg = chip_smoke.chain_pgo_cfg(tconfig.PGOConfig(), nodes, info["loops"])
    g = pg.optimize(chip_smoke.build_graph(torch, pg, Pose, cfg, oq, ot, loops, "cpu"), cfg)
    chip_smoke.compare_pose_graph(nodes, chip_smoke.drive_arrays(reference[1], drive)["trans"],
                                  g.poses.trans.numpy())


@pytest.mark.slow
def test_tool_reproduces_the_recording(reference, tmp_path):
    out = tmp_path / "ref.npz"
    subprocess.run([sys.executable, str(REPO / "tools" / "torch_record_reference.py"),
                    "--out", str(out)], cwd=REPO, check=True, timeout=3000,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    meta, arrays = chip_smoke.load_reference(str(out))
    want_meta, want = reference
    assert {k: v for k, v in meta.items() if k != "commit"} == \
        {k: v for k, v in want_meta.items() if k != "commit"}
    assert sorted(arrays) == sorted(want)
    for k in want:
        assert arrays[k].dtype == want[k].dtype and np.array_equal(arrays[k], want[k]), k
