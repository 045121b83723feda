"""The odometry front end alone (A-LOAM without the pose-graph node):
`FrontEnd.step` on scans uploaded from host memory one at a time
(`LidarScan.from_numpy`, the program's own padding and pinned upload),
each scan's mapped pose read back before the next is sent.

The scans are one closed lap of a circle whose circumference is a whole
number of frames, driven round and round, so the drive is continuous and
stationary. The set-up runs the lap's first frames (the first frame, the
steady step and the keyframe prep each captured); the window goes on
from there, and its compared frames are drawn from its first lap."""

from __future__ import annotations

import numpy as np

from benchlib import driving, synthetic
from reference import compare


class Driver:
    def __init__(self, ctx: driving.Context):
        from scaloam_tpu_torch.models import frontend
        from scaloam_tpu_torch.types import LidarScan

        self.ctx, self.LidarScan = ctx, LidarScan
        self.cfg = ctx.slam_config()
        p = ctx.params
        self.lap = p["lap_frames"]
        course = synthetic.circle_course(self.lap, p["step_m"],
                                         synthetic.lap_radius(self.lap, p["step_m"]))
        self.scans = driving.make_scans(ctx, course, self.cfg)
        self.fe = frontend.FrontEnd(self.cfg, device=ctx.device)
        self.spans = [(frontend.FrontEnd, "step", "frontend_step")]
        self.f, self.window_steps, self.samples = 0, 0, []
        self.failed = 0  # scans whose mapped pose is not finite
        self.sample_at = driving.sample_frames(ctx.rng(1), self.lap, p["samples"])

    def setup(self) -> None:
        self.window_steps = self.lap  # nothing sampled while warming up
        for _ in range(self.ctx.params["warm_frames"]):
            self._frame()
        self.window_steps = 0

    def trace_steps(self) -> int:
        return self.ctx.params["trace_frames"]

    def _frame(self):
        points = self.scans[self.f % self.lap]
        self.f += 1
        state = compare.clone_tree(self.fe.state) if self._sampled() else None
        with driving.Timer() as t:
            scan = self.LidarScan.from_numpy(points, self.cfg.sensor.max_points, self.ctx.device)
            out = self.fe.step(scan.xyz, scan.mask)
            pose = driving.pose_to_host(out.mapped_pose)
        self.failed += int(not np.isfinite(pose).all())
        return t.seconds, scan, state, out

    def _sampled(self) -> bool:
        return self.window_steps < self.lap and self.window_steps in self.sample_at

    def step(self) -> list:
        sampled = self._sampled()
        seconds, scan, state, out = self._frame()
        if sampled:
            self.samples.append(compare.FrontendSample(
                state, scan.xyz.clone(), scan.mask.clone(), compare.clone_tree(out),
                compare.clone_tree(self.fe.state)))
        self.window_steps += 1
        return [seconds]

    def release(self) -> None:
        self.fe = None

    def numbers(self, use_tf32: bool = False) -> compare.Numbers:
        return compare.frontend_numbers(self.samples, self.cfg, use_tf32)

    def witness(self, nums: compare.Numbers) -> list:
        """compare.witness of the steps nums.witnessed() names."""
        return [dict(step=j, departed=nums.departed()[j], **compare.witness(
            s.state.o, s.state.m, s.xyz, s.mask, s.out.odom_world, s.out.mapped_pose, self.cfg,
            odometry_clouds=True)) for j, s in ((j, self.samples[j]) for j in nums.witnessed())]
