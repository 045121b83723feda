"""The comparison that decides `correct`: the program's outputs at sampled
frames of the window against the plain reference (reference/slam, a
frozen copy of the port's plain PyTorch path of features, odometry,
mapping and the keyframe gate and prep, each hand kernel as its plain
version, every step eager).

The reference shares the port's algorithm and its rounding choices: it
catches what the hand kernels and the captured steps do to the answer,
not a fault of the algorithm itself. That the port's algorithm is the JAX
package's is held by the port's own tests on the CPU, not here.

The reference follows the program step by step: it starts each sampled
frame from the program's own state just before that frame (cloned into
the reference's types), runs the same entry on the same scan, and the
outputs and the state after the step are compared.

A compared step (one sequence's frame) departs where
- its odometry or mapped pose differs by more than POSE_TOL in a
  component (quaternions sign-aligned, translations in m), or
- an element of the state after the step (odometry, the mapping grids,
  and in the front end the gate and the keyframe cloud) differs by more
  than STATE_TOL (floats) or at all (whole numbers, flags).
The hand kernels sum in another order than their plain versions; where a
correspondence or a voxel is a near-tie, that flips one choice and moves
the step by up to ~1e-3, so a sound run departs on a step now and then
(`witness` shows the flipped choice). The numbers compared:
- departed_steps: the most departed steps of any one sequence, so that a
  fault in one slot of a batch shows as that slot's every sampled step;
- feature_mismatch: elements of the selected feature clouds (points,
  rings, relative times, masks) that differ at all, over every step.

The control (tests/test_control.py) puts this reference in the program's
place, computed with TF32 on, the precision below the float32 with TF32
off that the program states.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple

import torch

from reference.slam import config as rconfig
from reference.slam import types as rtypes
from reference.slam.models import frontend as rfrontend
from reference.slam.models import mapping as rmapping
from reference.slam.models import odometry as rodometry
from reference.slam.models import pipeline as rpipeline
from reference.slam.ops import correspond as rcorrespond
from reference.slam.ops import features as rfeatures
from reference.slam.ops import gn as rgn
from reference.slam.ops import gridmap as rgridmap
from reference.slam.ops import voxel as rvoxel

POSE_TOL = 3e-5  # m: a step whose pose is further off than this departs
STATE_TOL = 1e-3  # m: a map point or pose entry further off than this differs

_TYPES = {c.__name__: c for c in (
    rtypes.Pose, rtypes.LidarScan, rtypes.FeatureCloud, rtypes.RangeImage, rtypes.ScanFeatures,
    rodometry.OdometryState, rmapping.MappingState, rgridmap.GridMap, rpipeline.GateState,
    rfrontend.FrontendState)}


def to_reference(tree):
    """A tree of the program's NamedTuples and tensors as the reference's
    NamedTuples of the same names, field by field (tensors cloned)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TYPES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"the reference has no type {type(tree).__name__}")
        missing = [f for f in cls._fields if f not in tree._fields]
        if missing:
            raise TypeError(f"{type(tree).__name__} lacks the reference's fields {missing}")
        return cls(*(to_reference(getattr(tree, f)) for f in cls._fields))
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def reference_config(program_cfg):
    """The program's SlamConfig as the reference's."""
    return rconfig.from_dict(dataclasses.asdict(program_cfg))


def clone_tree(tree):
    """A copy of a tree of NamedTuples with every tensor cloned (the
    program's state is donated: its tensors change in place)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(clone_tree(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls and convolutions in TF32 while active, if `on`."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- the numbers -------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def pose_gap(a, b) -> float:
    """Largest |difference| of a pose's components (quaternions sign-aligned)."""
    qa, qb = a.quat.detach().double().cpu(), b.quat.detach().double().cpu()
    sign = torch.where((qa * qb).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    dq = (qa * sign - qb).abs().max()
    dt = (a.trans.detach().double().cpu() - b.trans.detach().double().cpu()).abs().max()
    return float(torch.nan_to_num(torch.maximum(dq, dt), nan=math.inf))


def mismatch(a, b, tol: float = 0.0) -> int:
    """Elements of two trees that differ by more than `tol` (floats) or at
    all (whole numbers, flags); a leaf of another shape counts whole."""
    n = 0
    for x, y in zip(_leaves(a), _leaves(b)):
        if not isinstance(x, torch.Tensor):
            n += int(bool(x) != bool(y)) if isinstance(x, bool) else int(x != y)
            continue
        if x.shape != y.shape:
            n += max(x.numel(), y.numel())
            continue
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.is_floating_point():
            d = (x.double() - y.double()).abs()
            n += int(((d > tol) | (torch.isnan(x) != torch.isnan(y))).sum())
        else:
            n += int((x != y).sum())
    return n


class Numbers:
    """Each compared step's readings (printed on standard error) and the
    numbers they give."""

    def __init__(self):
        self.per_step: Dict[str, list] = {
            "sequence": [], "pose_gap": [], "state_mismatch": [], "feature_mismatch": []}

    def record(self, sequence: int, gap: float, o_prog, m_prog, o_ref, m_ref, extra=()) -> None:
        """One step: its pose gap, and its odometry and mapping states
        after the step (with `extra`: pairs of further state, program's
        then reference's)."""
        self.per_step["sequence"].append(sequence)
        self.per_step["pose_gap"].append(gap)
        self.per_step["feature_mismatch"].append(mismatch(
            tuple(o_prog.last_corner) + tuple(o_prog.last_surf),
            tuple(o_ref.last_corner) + tuple(o_ref.last_surf)))
        self.per_step["state_mismatch"].append(mismatch(
            (tuple(o_prog), tuple(m_prog)) + tuple(extra[0::2]),
            (tuple(o_ref), tuple(m_ref)) + tuple(extra[1::2]), STATE_TOL))

    def departed(self) -> list:
        return [g > POSE_TOL or s > 0
                for g, s in zip(self.per_step["pose_gap"], self.per_step["state_mismatch"])]

    def witnessed(self) -> list:
        """The steps `witness` looks at: every departed one, and the first
        two others to set beside them."""
        departed = self.departed()
        return ([j for j, d in enumerate(departed) if d]
                + [j for j, d in enumerate(departed) if not d][:2])

    def values(self) -> Dict[str, int]:
        worst = collections.Counter(q for q, d in zip(self.per_step["sequence"], self.departed())
                                    if d)
        return {"departed_steps": max(worst.values(), default=0),
                "feature_mismatch": sum(self.per_step["feature_mismatch"])}


# -- the entries -------------------------------------------------------------


class FrontendSample(NamedTuple):
    """One frame of FrontEnd.step: the state before (program's types),
    the padded scan, the output and the state after."""

    state: tuple
    xyz: torch.Tensor
    mask: torch.Tensor
    out: tuple
    after: tuple


def frontend_numbers(samples, program_cfg, use_tf32: bool = False) -> Numbers:
    """The numbers over FrontEnd.step samples (reference: frontend_step)."""
    cfg = reference_config(program_cfg)
    nums = Numbers()
    for s in samples:
        with tf32(use_tf32):
            after, out = rfrontend.frontend_step(to_reference(s.state),
                                                 rtypes.LidarScan(s.xyz, s.mask), cfg)
        gap = max(pose_gap(s.out.odom_world, out.odom_world),
                  pose_gap(s.out.mapped_pose, out.mapped_pose))
        nums.record(0, gap, s.after.o, s.after.m, after.o, after.m,
                    extra=(tuple(s.after.gate), tuple(after.gate),
                           (s.out.fire, s.out.kf_xyz, s.out.kf_mask, s.out.kf_ext),
                           (out.fire, out.kf_xyz, out.kf_mask, out.kf_ext)))
    return nums


class FleetSample(NamedTuple):
    """One batched frame of multiseq.frame_batch: stacked states before,
    the padded scans [n, P, 3] / [n, P], the poses and the states after."""

    o_states: tuple
    m_states: tuple
    xyz: torch.Tensor
    mask: torch.Tensor
    odom: tuple
    mapped: tuple
    o_after: tuple
    m_after: tuple


def row(tree, i: int):
    """Sequence i of stacked states (host leaves as they are)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(row(x, i) for x in tree))
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


def _frame(o, m, xyz, mask, cfg, odom_pose=None, odometry_clouds: bool = False):
    """One sequence's frame through the reference's features -> odometry
    -> mapping, with `odom_pose` in place of the odometry's own where
    given; mapping takes the frame's less-sharp and less-flat clouds as the
    batched step wires them, or with `odometry_clouds` odometry's clouds
    after the step, as the front end does: (o, o_out, m, m_out)."""
    feats = rfeatures.extract_features(rtypes.LidarScan(xyz, mask), cfg)
    o, o_out = rodometry.odometry_step(o, feats, cfg)
    corner, surf = (o.last_corner, o.last_surf) if odometry_clouds else (feats.less_sharp,
                                                                         feats.less_flat)
    m, m_out = rmapping.mapping_step(m, o_out.world if odom_pose is None else odom_pose,
                                     corner, surf, cfg)
    return o, o_out, m, m_out


def fleet_numbers(samples, program_cfg, use_tf32: bool = False) -> Numbers:
    """The numbers over frame_batch samples, each sequence a step."""
    cfg = reference_config(program_cfg)
    nums = Numbers()
    for s in samples:
        for i in range(s.xyz.shape[0]):
            with tf32(use_tf32):
                o, o_out, m, m_out = _frame(to_reference(row(s.o_states, i)),
                                                 to_reference(row(s.m_states, i)),
                                                 s.xyz[i], s.mask[i], cfg)
            gap = max(pose_gap(row(s.odom, i), o_out.world),
                      pose_gap(row(s.mapped, i), m_out.pose))
            o_prog = row(s.o_after, i)._replace(initialized=o.initialized)
            nums.record(i, gap, o_prog, row(s.m_after, i), o, m)
    return nums


# -- the witness of a departed step -------------------------------------------

# The reference's discrete choices and which of their outputs hold what
# was chosen: odometry's candidate search and re-rank, mapping's
# candidates and re-rank.
CHOICES = ((rvoxel, "knn2_payload", (1,)), (rcorrespond, "ring_constrained_nn2_pts", (1, 3)),
           (rodometry, "_pick1", (1,)), (rgridmap, "knn_grid", (1,)),
           (rvoxel, "argmin_topk", (1,)))


@contextlib.contextmanager
def _recording(into: list):
    """Appends what each of CHOICES picked to `into` while active."""
    saved = [(mod, name, getattr(mod, name), picks) for mod, name, picks in CHOICES]

    def wrap(fn, picks):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            into.extend(out[k].detach().cpu() for k in picks)
            return out
        return recorded

    for mod, name, fn, picks in saved:
        setattr(mod, name, wrap(fn, picks))
    try:
        yield
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)


def _flipped(a: list, b: list) -> int:
    """Elements that two runs' recorded choices differ in."""
    if len(a) != len(b):
        return -1
    return sum(int((x != y).sum()) if x.shape == y.shape else max(x.numel(), y.numel())
               for x, y in zip(a, b))


@contextlib.contextmanager
def _solves_moved(direction: float, ulps: int):
    """Every Gauss-Newton solve of the reference (odometry's passes,
    mapping's) returns its translation `ulps` ulps towards `direction`:
    the size of what another summation order does to a solve."""
    solve = rgn.gauss_newton

    def moved(*args, **kwargs):
        p = solve(*args, **kwargs)
        t = p.trans
        for _ in range(ulps):
            t = torch.nextafter(t, t + direction)
        return rtypes.Pose(p.quat, t)

    rgn.gauss_newton = moved
    try:
        yield
    finally:
        rgn.gauss_newton = solve


def witness(o_state, m_state, xyz, mask, prog_odom, prog_mapped, program_cfg,
            odometry_clouds: bool = False) -> dict:
    """Why a step departs, from the program's odometry and mapping states
    before it, its scan and its two poses: the reference's step as
    compared (a), and again with its input moved by rounding (b), in five
    ways: mapping fed the program's odometry pose (`odometry_pose`), and
    every GN solve's translation one or eight ulps up or down
    (`solves_up1`, `solves_down1`, `solves_up8`, `solves_down8`). For
    each b: `jump` (a against b, of both poses), `gap_b` (the program
    against b) and `flipped` (elements of the picks of CHOICES that differ
    from a's). A near-tie shows as a b whose jump is of the departure's
    size with picks flipped, most plainly where its gap_b is back at
    rounding."""
    cfg = reference_config(program_cfg)

    def run(odom_pose=None):
        o, m = to_reference(o_state), to_reference(m_state)
        picks = []
        with _recording(picks):
            _, o_out, _, m_out = _frame(o, m, xyz, mask, cfg, odom_pose, odometry_clouds)
        return o_out.world, m_out.pose, picks

    def gap(odom, mapped, odom_b, mapped_b):
        return max(pose_gap(odom, odom_b), pose_gap(mapped, mapped_b))

    odom_a, mapped_a, picks_a = run()
    out = dict(odometry_gap=pose_gap(prog_odom, odom_a), gap=gap(prog_odom, prog_mapped, odom_a,
                                                                 mapped_a))
    variants = {"odometry_pose": lambda: run(prog_odom)}
    for ulps in (1, 8):
        for name, direction in (("up", math.inf), ("down", -math.inf)):
            def moved(direction=direction, ulps=ulps):
                with _solves_moved(direction, ulps):
                    return run()
            variants[f"solves_{name}{ulps}"] = moved
    for name, variant in variants.items():
        odom_b, mapped_b, picks_b = variant()
        out[name] = dict(jump=gap(odom_a, mapped_a, odom_b, mapped_b),
                         gap_b=gap(prog_odom, prog_mapped, odom_b, mapped_b),
                         flipped=_flipped(picks_a, picks_b))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number with no limit fails)."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
