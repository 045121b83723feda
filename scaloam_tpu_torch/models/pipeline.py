"""The full SLAM system, run synchronously (counterpart of
scaloam_tpu/models/pipeline.py): features -> odometry -> mapping ->
keyframe gate -> keyframe prep -> ScanContext -> ICP loop verification ->
pose-graph GN, every stage in order per scan.

`SlamSystem(cfg, device=None)` runs on `cuda` unless another device is
named, and raises without a GPU and without a device. The device is read
back where the reference reads it: the gate flag once a frame, the
ScanContext detect triple once a keyframe, and on a loop candidate the
pose tables, the keyframe clouds of the submap (each materialised once)
and the one ICP result.

`backend_device` puts the backend on a second device: the pose graph, the
ScanContext database and the stored keyframe clouds live there, and loop
detection, ICP verification and the optimise run there, so they take no
time of the front end's device. Only each keyframe's cloud and pose cross
at the stage boundary (the reference's TCPROS hop between its odometry
and pose-graph nodes).
"""

from __future__ import annotations

import collections
import math
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from scaloam_tpu_torch import device as _device
from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.models import mapping as mapping_mod
from scaloam_tpu_torch.models import odometry as odometry_mod
from scaloam_tpu_torch.models import posegraph as pg
from scaloam_tpu_torch.models import scancontext as scm
from scaloam_tpu_torch.ops import features, icp, se3, voxel
from scaloam_tpu_torch.ops.kernels import f32ops
from scaloam_tpu_torch.types import LidarScan, Pose


class GateState(NamedTuple):
    """Keyframe-gate state: accumulated motion since the last keyframe."""

    last_quat: torch.Tensor  # [4]
    last_trans: torch.Tensor  # [3]
    trans_accum: torch.Tensor  # f32 scalar
    rot_accum: torch.Tensor  # f32 scalar
    initialized: torch.Tensor  # bool scalar


def init_gate_state(device=None) -> GateState:
    dev = _device.resolve(device)
    return GateState(
        last_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=dev),
        last_trans=torch.zeros(3, dtype=torch.float32, device=dev),
        trans_accum=torch.zeros((), dtype=torch.float32, device=dev),
        rot_accum=torch.zeros((), dtype=torch.float32, device=dev),
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
    )


def gate_step(gs: GateState, quat, trans, meter_gap: float, deg_gap: float):
    """One keyframe-gate update; returns (new_state, fire bool scalar).
    The first frame always fires; firing resets both accumulators."""
    dt = torch.sqrt(f32ops.sum3_sq(trans - gs.last_trans))
    r, p, y = se3.quat_to_rpy(se3.quat_mul(se3.quat_conj(gs.last_quat), quat))
    live = gs.initialized
    ta = gs.trans_accum + torch.where(live, dt, 0.0)
    ra = gs.rot_accum + torch.where(live, torch.abs(r) + torch.abs(p) + torch.abs(y), 0.0)
    fire = ~live | (ta > meter_gap) | (ra > math.radians(deg_gap))
    new = GateState(
        last_quat=quat,
        last_trans=trans,
        trans_accum=torch.where(fire, 0.0, ta),
        rot_accum=torch.where(fire, 0.0, ra),
        initialized=torch.ones((), dtype=torch.bool, device=quat.device),
    )
    return new, fire


def _prepare_keyframe(ri_xyz, ri_mask, ri_rel_time, cfg: SlamConfig):
    """The keyframe cloud: the full-res local range image, 0.4 m voxel
    filtered, with the intensity channel (ring + scan_period * relTime)
    averaged alongside. Overflow drops the farthest voxels first."""
    n_rings = ri_xyz.shape[0]
    rings = torch.arange(n_rings, dtype=torch.float32, device=ri_xyz.device)[:, None]
    intens = (rings + float(cfg.sensor.scan_period) * ri_rel_time).reshape(-1, 1)
    return voxel.voxel_downsample_packed(
        ri_xyz.reshape(-1, 3), ri_mask.reshape(-1), cfg.pgo.keyframe_voxel_size,
        capacity=cfg.pgo.keyframe_cloud_capacity, extra=intens,
        xy_bits=10, z_bits=9, shell_bits=2,
    )


class FrameResult(NamedTuple):
    frame_idx: int
    odom_pose: Pose  # /laser_odom_to_init
    mapped_pose: Pose  # /aft_mapped_to_init
    is_keyframe: bool
    loop_found: Optional[tuple]  # (curr_kf, loop_kf) if a loop was added


class Keyframe:
    """A keyframe cloud ([P, 3] local frame, 0.4 m downsampled) with its
    intensity channel (ring + scan_period * relTime), from host numpy
    (resume, tests: cloud=/intensity=) or from the padded device tensors
    dev=(xyz [C, 3], mask [C], ext [C, 1]). For CUDA tensors the copy to
    the host starts at once and is waited for on first use of .cloud or
    .intensity (loop verification, artifact writing)."""

    __slots__ = ("time", "frame", "_cloud", "_intensity", "_dev", "_host", "_ready")

    def __init__(self, cloud=None, time=0.0, frame=-1, intensity=None, dev=None):
        self.time = time
        self.frame = frame
        self._cloud = cloud
        self._intensity = intensity
        self._dev = dev
        self._host = self._ready = None
        if dev is not None and dev[0].is_cuda:
            # The copies run on the current stream of the clouds' device,
            # which need not be the current device.
            self._host = tuple(a.to("cpu", non_blocking=True) for a in dev)
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(dev[0].device))

    def _materialize(self):
        if self._host is not None:
            self._ready.synchronize()
            xyz, mask, ext = self._host
        else:
            xyz, mask, ext = (a.cpu() for a in self._dev)
        m = mask.numpy()
        self._cloud = xyz.numpy()[m]
        self._intensity = ext.numpy()[m, 0]
        self._dev = self._host = self._ready = None

    @property
    def cloud(self) -> np.ndarray:
        if self._dev is not None:
            self._materialize()
        return self._cloud

    @property
    def intensity(self) -> Optional[np.ndarray]:
        if self._dev is not None:
            self._materialize()
        return self._intensity


def _pose_matrices(quat, trans) -> np.ndarray:
    """Host pose tables [K, 4] / [K, 3] (float32 numpy) -> [K, 4, 4]
    float64 matrices, the precision the reference assembles its submap in."""
    q = torch.from_numpy(np.asarray(quat)).to(torch.float64)
    t = torch.from_numpy(np.asarray(trans)).to(torch.float64)
    return se3.pose_to_matrix(Pose(q, t)).numpy()


def _linspace_take(a: np.ndarray, cap: int) -> np.ndarray:
    """At most `cap` rows of a, evenly by position (np.linspace indices)."""
    if len(a) > cap:
        a = a[np.linspace(0, len(a) - 1, cap).astype(int)]
    return a


def _padded(a: np.ndarray, cap: int, device):
    """(xyz [cap, 3], mask [cap]) device tensors holding a's rows first."""
    out = np.zeros((cap, 3), np.float32)
    out[: len(a)] = a
    m = np.zeros(cap, bool)
    m[: len(a)] = True
    return torch.from_numpy(out).to(device), torch.from_numpy(m).to(device)


class SlamSystem:
    """Host orchestrator over the port's device stages. Runs on `cuda`
    unless another device is named; raises without a GPU and a device.
    The backend runs on `backend_device` (default: the same device)."""

    def __init__(self, cfg: SlamConfig, device=None, backend_device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        dev = self.device
        self.backend_device = dev if backend_device is None else torch.device(backend_device)
        bdev = self.backend_device
        self.o_state = odometry_mod.init_state(cfg, dev)
        self.m_state = mapping_mod.init_state(cfg, dev)
        self.graph = pg.init_graph(cfg.pgo, bdev)
        self.sc = scm.SCManager(cfg.scancontext, bdev)
        self.keyframes: List[Keyframe] = []
        self.kf_times: List[float] = []
        self.frame_idx = 0
        self.gate_state = init_gate_state(dev)
        # (time, altitude) GPS events in stream order; _match_gps drops
        # those too old to match any later keyframe.
        self._pending_gps = collections.deque()
        # Altitude of the first matched fix: GPS factors are relative to it,
        # so absolute altitudes land in the graph's odometry frame.
        self._gps_alt_offset = None
        self.loops_found: List[tuple] = []
        self._writer = None  # SessionWriter when continuous flush is on
        self._live = False  # live.html per flush
        self._resume_dir = None  # set by resume(): append-safe writer dir

    # -- GPS ingestion -------------------------------------------------------

    def add_gps(self, time: float, altitude: float) -> None:
        self._pending_gps.append((time, altitude))

    def _match_gps(self, time: float):
        """Nearest GPS event within the tolerance window; events older than
        time - tol are dropped, the scan stops at the first past time + tol."""
        tol = self.cfg.pgo.gps_time_tolerance
        pend = self._pending_gps
        while pend and pend[0][0] <= time - tol:
            pend.popleft()
        best = None
        for t, z in pend:
            if t - time >= tol:
                break
            if best is None or abs(t - time) < abs(best[0] - time):
                best = (t, z)
        if best is None:
            return np.float32(0.0), False
        if self._gps_alt_offset is None:
            self._gps_alt_offset = float(best[1])
        return np.float32(best[1] - self._gps_alt_offset), True

    # -- main entry ----------------------------------------------------------

    def process_scan(self, points: np.ndarray, time: float = 0.0) -> FrameResult:
        cfg = self.cfg
        scan = LidarScan.from_numpy(points, cfg.sensor.max_points, self.device)
        feats = features.extract_features(scan, cfg)
        self.o_state, o_out = odometry_mod.odometry_step(self.o_state, feats, cfg)
        if self.frame_idx % cfg.odometry.skip_frame == 0:
            # Mapping consumes odometry's republished clouds.
            self.m_state, m_out = mapping_mod.mapping_step(
                self.m_state, o_out.world, self.o_state.last_corner,
                self.o_state.last_surf, cfg)
            mapped_pose = m_out.pose
        else:
            mapped_pose = se3.compose(self.m_state.correction, o_out.world)

        is_kf = self._keyframe_gate(mapped_pose)
        loop = None
        if is_kf:
            self._add_keyframe(feats, mapped_pose, time)
            loop = self._detect_and_verify_loop()
            if len(self.keyframes) % cfg.pgo.optimize_every_n_keyframes == 0:
                self.graph = pg.optimize(self.graph, cfg.pgo)
                if self._writer is not None:  # per-cycle crash checkpoint
                    self.flush_artifacts()
        result = FrameResult(self.frame_idx, o_out.world, mapped_pose, is_kf, loop)
        self.frame_idx += 1
        return result

    # -- keyframing ----------------------------------------------------------

    def gate_step(self, pose: Pose) -> torch.Tensor:
        """Advance the device-side keyframe gate; returns the flag unread."""
        self.gate_state, fire = gate_step(
            self.gate_state, pose.quat, pose.trans,
            float(self.cfg.pgo.keyframe_meter_gap), float(self.cfg.pgo.keyframe_deg_gap))
        return fire

    def _keyframe_gate(self, pose: Pose) -> bool:
        """The gate with its one 1-byte read a frame."""
        return bool(self.gate_step(pose))

    def _add_keyframe(self, feats, mapped_pose: Pose, time: float) -> None:
        kf_xyz, kf_mask, kf_ext = _prepare_keyframe(
            feats.full.xyz, feats.full.mask, feats.full.rel_time, self.cfg)
        self._add_keyframe_prepared(kf_xyz, kf_mask, kf_ext, mapped_pose, time)

    def _add_keyframe_prepared(self, kf_xyz, kf_mask, kf_ext, mapped_pose: Pose,
                               time: float) -> None:
        """Append an already prepared keyframe cloud: the stored keyframe,
        its ScanContext descriptor and its graph node."""
        # The stage boundary: with a backend device the cloud and the pose
        # cross here (asynchronously between cards; a copy into host memory
        # completes first), and all backend state and solves stay there.
        if self.backend_device != self.device:
            nb = self.backend_device.type == "cuda"
            kf_xyz, kf_mask, kf_ext, q, t = (
                a.to(self.backend_device, non_blocking=nb)
                for a in (kf_xyz, kf_mask, kf_ext, mapped_pose.quat, mapped_pose.trans))
            mapped_pose = Pose(q, t)
        self.keyframes.append(Keyframe(time=time, frame=self.frame_idx,
                                       dev=(kf_xyz, kf_mask, kf_ext)))
        self.kf_times.append(time)
        self.sc.make_and_save(kf_xyz, kf_mask)
        gps_z, gps_ok = self._match_gps(time)
        self.graph = pg.add_keyframe(self.graph, mapped_pose, gps_z, gps_ok,
                                     n_nodes=len(self.keyframes) - 1)

    # -- loop closure --------------------------------------------------------

    def _detect_and_verify_loop(self):
        idx, yaw, _ = self.sc.detect_loop_closure_id()
        if idx < 0:
            return None
        curr = len(self.keyframes) - 1
        z = self._icp_verify(curr, idx, yaw)
        if z is None:
            return None
        return self.commit_loop(curr, idx, z)

    def commit_loop(self, curr: int, idx: int, z: Pose):
        """Add an ICP-verified loop factor."""
        self.graph = pg.add_loop(self.graph, curr, idx, z, n_loops=len(self.loops_found))
        self.loops_found.append((curr, idx))
        return (curr, idx)

    def fetch_pose_tables(self):
        """The graph's pose tables as numpy ([N, 4], [N, 3]) in one read."""
        both = torch.cat([self.graph.poses.quat, self.graph.poses.trans], dim=-1)
        both = both.cpu().numpy()
        return both[:, :4], both[:, 4:]

    def _icp_verify(self, curr: int, loop_idx: int, yaw: float, poses=None) -> Optional[Pose]:
        """ICP verification in the loop keyframe's local frame, seeded by the
        graph-estimated relative pose and by the ScanContext yaw. Returns the
        loop measurement X_curr^-1 X_loop, or None if rejected."""
        lcfg = self.cfg.loop
        dev = self.backend_device
        poses_q, poses_t = self.fetch_pose_tables() if poses is None else poses
        n_kf = len(self.keyframes)
        T_all = _pose_matrices(poses_q[:n_kf], poses_t[:n_kf])
        T_loop_inv = np.linalg.inv(T_all[loop_idx])

        # Submap: +-25 keyframes around the loop keyframe, relative to it, in
        # ascending order, the query keyframe itself left out.
        pieces = []
        for k in range(max(0, loop_idx - lcfg.submap_half_keyframes),
                       min(n_kf, loop_idx + lcfg.submap_half_keyframes + 1)):
            if k == curr:
                continue
            rel = T_loop_inv @ T_all[k]
            pieces.append(self.keyframes[k].cloud @ rel[:3, :3].T + rel[:3, 3])
        submap = np.concatenate(pieces, axis=0).astype(np.float32)
        submap = submap[np.linalg.norm(submap[:, :2], axis=-1) < lcfg.icp_crop_radius]
        if len(submap) < 100:
            return None
        submap = _linspace_take(submap, lcfg.max_submap_points)

        src = self.keyframes[curr].cloud
        src = src[np.linalg.norm(src[:, :2], axis=-1) < lcfg.icp_crop_radius]
        if len(src) < 100:
            return None
        src = _linspace_take(src, lcfg.max_source_points)

        # Seed A: the graph-estimated relative pose T_loop^-1 T_curr; seed B:
        # identity translation with the ScanContext yaw.
        C0 = torch.from_numpy(T_loop_inv @ T_all[curr])
        init_q = np.stack([
            se3.mat_to_quat(C0[:3, :3]).numpy().astype(np.float32),
            np.array([np.cos(-yaw / 2), 0.0, 0.0, np.sin(-yaw / 2)], np.float32),
        ])
        init_t = np.stack([C0[:3, 3].numpy().astype(np.float32), np.zeros(3, np.float32)])
        inits = Pose(torch.from_numpy(init_q).to(dev), torch.from_numpy(init_t).to(dev))

        res, _ = icp.verify_loop(
            *_padded(src, lcfg.max_source_points, dev),
            *_padded(_linspace_take(src, lcfg.coarse_source_points),
                     lcfg.coarse_source_points, dev),
            *_padded(_linspace_take(submap, lcfg.coarse_target_points),
                     lcfg.coarse_target_points, dev),
            *_padded(submap, lcfg.max_submap_points, dev),
            inits,
            voxel_size=self.cfg.pgo.keyframe_voxel_size,
            sub_capacity=lcfg.max_submap_points,
            gx=lcfg.icp_grid_xy, gy=lcfg.icp_grid_xy, gz=lcfg.icp_grid_z,
            cell_size=lcfg.icp_cell_size, cell_cap=lcfg.icp_cell_cap,
            dedup_radius=self.cfg.pgo.keyframe_voxel_size,
            reach=lcfg.icp_reach, max_corr_dist=lcfg.icp_max_corr_dist,
            coarse_iterations=lcfg.coarse_iterations,
            fine_iterations=lcfg.icp_max_iterations,
            transformation_eps=lcfg.transformation_eps,
        )
        got = torch.cat([res.fitness.reshape(1), res.converged.reshape(1).to(torch.float32),
                         res.transform.quat, res.transform.trans]).cpu()  # the one read
        fit, ok = float(got[0]), bool(got[1] > 0)
        q, t = got[2:6], got[6:9]
        # A degenerate solve gives NaN fitness, which passes a plain `>`.
        if (not ok or not np.isfinite(fit) or fit > lcfg.fitness_threshold
                or not bool(torch.isfinite(got[2:]).all())):
            return None
        # C aligns curr-local onto loop-local (C ~= T_loop^-1 T_curr), so the
        # between measurement X_curr^-1 X_loop is C^-1.
        return se3.inverse(Pose(q.to(dev), t.to(dev)))

    # -- outputs -------------------------------------------------------------

    def _matrices(self, p: Pose) -> np.ndarray:
        n = len(self.keyframes)
        return se3.pose_to_matrix(Pose(p.quat[:n], p.trans[:n])).cpu().numpy()

    def optimized_poses(self) -> np.ndarray:
        """[K, 4, 4] optimized keyframe poses."""
        return self._matrices(self.graph.poses)

    def odometry_keyframe_poses(self) -> np.ndarray:
        return self._matrices(self.graph.odom_poses)

    # -- session artifacts + resume -----------------------------------------

    def attach_session_writer(self, directory: str, live: bool = True) -> None:
        """Flush artifacts into `directory` every optimize cycle. The
        directory this system was resumed from is continued; any other is
        cleared first, as a fresh session."""
        from scaloam_tpu_torch.io import artifacts

        append = (self._resume_dir is not None
                  and os.path.abspath(directory) == self._resume_dir)
        self._writer = artifacts.SessionWriter(directory, append=append)
        self._live = live

    def flush_artifacts(self) -> None:
        """Write unwritten keyframes (Scans/, SCDs/, times.txt) and the pose
        and graph artifacts."""
        w = self._writer
        if w is None:
            raise RuntimeError("attach_session_writer first")
        n = len(self.keyframes)
        start = w.n_written
        if n > start:
            descs = self.sc.db.descriptors[start:n].cpu().numpy()
            for k in range(start, n):
                kf = self.keyframes[k]
                cloud = kf.cloud
                if kf.intensity is not None and len(kf.intensity) == len(cloud):
                    cloud = np.concatenate(
                        [cloud, kf.intensity[:, None].astype(np.float32)], axis=1)
                w.save_keyframe(k, cloud, descs[k - start], kf.time)
        loop_edges = []
        nl = len(self.loops_found)
        if nl:
            g = self.graph
            T_all = se3.pose_to_matrix(Pose(g.loop_rel.quat[:nl], g.loop_rel.trans[:nl]))
            T_all = T_all.cpu().numpy()
            ij = torch.stack([g.loop_i[:nl], g.loop_j[:nl]], dim=1).cpu().numpy()
            loop_edges = [(int(ij[i, 0]), int(ij[i, 1]), T_all[i]) for i in range(nl)]
        opt = self.optimized_poses()
        odom = self.odometry_keyframe_poses()
        w.save_poses(opt, odom, loop_edges)
        if self._live:
            from scaloam_tpu_torch.utils import live as live_mod

            live_mod.write_live_view(w.dir, opt, odom, [(i, j) for i, j, _ in loop_edges])

    def save_session(self, directory: str) -> None:
        """The full artifact set: Scans/, SCDs/, times.txt, optimized and
        odometry poses (KITTI format), the g2o graph."""
        from scaloam_tpu_torch.io import artifacts

        if self._writer is None or os.path.abspath(directory) != os.path.abspath(self._writer.dir):
            append = (self._resume_dir is not None
                      and os.path.abspath(directory) == self._resume_dir)
            self._writer = artifacts.SessionWriter(directory, append=append)
        self.flush_artifacts()

    @classmethod
    def resume(cls, directory: str, cfg: SlamConfig, device=None,
               backend_device=None) -> "SlamSystem":
        """Reload keyframe clouds, poses, the ScanContext database and the
        accepted loop factors (on the backend device); odometry and mapping
        restart fresh."""
        from scaloam_tpu_torch.io import artifacts, pcd as pcd_io

        sys_ = cls(cfg, device=device, backend_device=backend_device)
        dev, bdev = sys_.device, sys_.backend_device
        sys_._resume_dir = os.path.abspath(directory)
        poses, times, scan_paths, scd_paths = artifacts.load_session(directory)
        n = min(len(times), len(scan_paths))

        def pose_of(T):
            return Pose(se3.mat_to_quat(torch.tensor(T[:3, :3], dtype=torch.float32, device=bdev)),
                        torch.tensor(T[:3, 3], dtype=torch.float32, device=bdev))

        for k in range(n):
            raw = pcd_io.read_pcd(scan_paths[k])
            cloud = raw[:, :3]
            intens = raw[:, 3] if raw.shape[1] > 3 else None
            sys_.keyframes.append(Keyframe(cloud=cloud, time=float(times[k]), intensity=intens))
            sys_.kf_times.append(float(times[k]))
            pose = pose_of(poses[k])
            sys_.graph = pg.add_keyframe(sys_.graph, pose, 0.0, False, n_nodes=k)
            if k < len(scd_paths):
                sc = np.loadtxt(scd_paths[k]).astype(np.float32)
                sys_.sc.save_descriptor(torch.from_numpy(sc).to(bdev))
            else:
                cap = cfg.scancontext.max_input_points
                sys_.sc.make_and_save(*_padded(cloud[:cap], cap, bdev))
            # The gate continues from the last restored pose.
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            sys_.gate_state = GateState(pose.quat.to(dev), pose.trans.to(dev), zero, zero.clone(),
                                        torch.ones((), dtype=torch.bool, device=dev))
        g2o_path = os.path.join(directory, "singlesession_posegraph.g2o")
        if os.path.exists(g2o_path):
            _, _, loop_edges = artifacts.load_g2o(g2o_path)
            for (i, j, T) in loop_edges:
                if i >= n or j >= n:
                    continue
                sys_.graph = pg.add_loop(sys_.graph, i, j, pose_of(T),
                                         n_loops=len(sys_.loops_found))
                sys_.loops_found.append((i, j))
        sys_.frame_idx = 0
        return sys_
