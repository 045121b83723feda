"""Offline re-processing of several recorded sequences at once:
`multiseq.frame_batch` over the sequences, one vmapped captured step a
frame, each sequence's scan of the frame padded and uploaded from pinned
host memory, the poses read back before the next frame.

The scans are one closed lap of a circle whose circumference is a whole
number of frames; sequence s starts at phase `phase_frames` x s and the
lap wraps, so every sequence drives continuously and the mix is
stationary. The scans are padded once, in set-up, into pinned host memory
(the reading of a recorded sequence), and each frame copies its rows to
the card. The set-up runs the first frames (the first frame's step and
the steady step captured); the window goes on from there, and its
compared frames are drawn from its first lap."""

from __future__ import annotations

import numpy as np
import torch

from benchlib import driving, synthetic
from reference import compare


class Driver:
    def __init__(self, ctx: driving.Context):
        from scaloam_tpu_torch.parallel import multiseq

        self.ctx, self.multiseq = ctx, multiseq
        self.cfg = ctx.slam_config()
        p = ctx.params
        self.lap, self.n_seq, self.phase = p["lap_frames"], p["sequences"], p["phase_frames"]
        course = synthetic.circle_course(self.lap, p["step_m"],
                                         synthetic.lap_radius(self.lap, p["step_m"]))
        scans = driving.make_scans(ctx, course, self.cfg)
        P = self.cfg.sensor.max_points
        xyz = np.zeros((self.lap, P, 3), np.float32)
        mask = np.zeros((self.lap, P), bool)
        for i, s in enumerate(scans):
            n = min(len(s), P)
            xyz[i, :n], mask[i, :n] = s[:n], True
        dev = ctx.device
        pin = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)
        self.host_xyz, self.host_mask = pin(torch.from_numpy(xyz)), pin(torch.from_numpy(mask))
        self.xyz = torch.empty((self.n_seq, P, 3), dtype=torch.float32, device=dev)
        self.mask = torch.empty((self.n_seq, P), dtype=torch.bool, device=dev)
        self.o, self.m = multiseq.init_states(self.n_seq, self.cfg, dev)
        self.spans = [(multiseq, "frame_batch", "frame_batch")]
        self.f, self.window_steps, self.samples = 0, 0, []
        self.failed = 0  # scans whose mapped pose is not finite
        self.sample_at = driving.sample_frames(ctx.rng(1), self.lap, p["samples"])

    def setup(self) -> None:
        for _ in range(self.ctx.params["warm_frames"]):
            self._frame(False)

    def trace_steps(self) -> int:
        return self.ctx.params["trace_frames"]

    def _frame(self, sampled: bool) -> float:
        rows = [(self.f + self.phase * s) % self.lap for s in range(self.n_seq)]
        self.f += 1
        before = (compare.clone_tree(self.o), compare.clone_tree(self.m)) if sampled else None
        with driving.Timer() as t:
            for s, r in enumerate(rows):
                self.xyz[s].copy_(self.host_xyz[r], non_blocking=True)
                self.mask[s].copy_(self.host_mask[r], non_blocking=True)
            self.o, self.m, odom, mapped = self.multiseq.frame_batch(
                self.o, self.m, self.xyz, self.mask, self.cfg)
            poses = driving.pose_to_host(mapped)
        self.failed += int((~np.isfinite(poses).all(axis=1)).sum())
        if sampled:
            self.samples.append(compare.FleetSample(
                before[0], before[1], self.xyz.clone(), self.mask.clone(),
                compare.clone_tree(odom), compare.clone_tree(mapped),
                compare.clone_tree(self.o), compare.clone_tree(self.m)))
        return t.seconds

    def step(self) -> list:
        sampled = self.window_steps < self.lap and self.window_steps in self.sample_at
        seconds = self._frame(sampled)
        self.window_steps += 1
        return [seconds] * self.n_seq

    def release(self) -> None:
        self.o = self.m = None

    def numbers(self, use_tf32: bool = False) -> compare.Numbers:
        return compare.fleet_numbers(self.samples, self.cfg, use_tf32)

    def witness(self, nums: compare.Numbers) -> list:
        """compare.witness of the steps nums.witnessed() names (steps in
        fleet_numbers's order: a sample's sequences)."""
        out = []
        for j in nums.witnessed():
            s, i = self.samples[j // self.n_seq], j % self.n_seq
            row = lambda tree: compare.row(tree, i)
            out.append(dict(step=j, departed=nums.departed()[j], **compare.witness(
                row(s.o_states), row(s.m_states), s.xyz[i], s.mask[i], row(s.odom),
                row(s.mapped), self.cfg)))
        return out
