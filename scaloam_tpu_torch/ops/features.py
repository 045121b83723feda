"""Curvature feature extraction (counterpart of scaloam_tpu/ops/features.py).

Per scan: NaN / near-range removal, ring id per lidar model, azimuth
unwrap to relative scan time, the [n_scans, W] range image, 11-point
curvature, neighbor-suppression reach, greedy selection (kernel K1, see
ops/kernels/selection.py) and the five output clouds.

The port follows the Pallas selection semantics: subregions pick in order
within a round, and a pick's band removes points from the later
subregions' pools at once. The reference's XLA branch (all subregions in
parallel), which differs at subregion boundaries by design, has no
counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from scaloam_tpu_torch.config import SlamConfig
from scaloam_tpu_torch.ops import f32, voxel
from scaloam_tpu_torch.ops.kernels import f32ops, selection
from scaloam_tpu_torch.types import FeatureCloud, LidarScan, RangeImage, ScanFeatures

_DEG = 180.0 / math.pi
_PI = math.pi


def _cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum in the reference's addition order.

    The JAX reference runs jnp.cumsum on the CPU, where XLA rewrites it into
    blocks of 16: a left-to-right sum inside each block, plus the exclusive
    prefix of the block totals, computed the same way recursively. The
    curvature is a difference of two such sums, so its rounding, and with
    it every threshold and argmax of the selection, depends on this order;
    keeping it makes the selection match the reference exactly."""
    x = x.movedim(dim, -1)
    return _blocked_prefix(x).movedim(-1, dim)


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def _blocked_prefix(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    n = x.shape[-1]
    if n <= base:
        return _sequential_prefix(x)
    m = -(-n // base)
    xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (m * base - n,))], dim=-1)
    within = _sequential_prefix(xp.reshape(x.shape[:-1] + (m, base)))
    totals = _blocked_prefix(within[..., base - 1], base)
    excl = torch.cat([totals.new_zeros(totals.shape[:-1] + (1,)), totals[..., :-1]], dim=-1)
    return (within + excl[..., None]).reshape(x.shape[:-1] + (m * base,))[..., :n]


# ---------------------------------------------------------------------------
# Ring id per lidar model
# ---------------------------------------------------------------------------


def _ring_id(xyz: torch.Tensor, lidar_type: str, n_scans: int):
    """Vertical angle -> (ring id, valid). C++ int() truncates toward zero."""
    x, y, z = xyz.unbind(-1)
    # The top HDL-64 beam sits exactly on the 2 degree bound, so the last
    # ulp of the angle decides validity there: form sqrt(x^2 + y^2) as the
    # reference's compiled code does (one fused multiply-add, correctly
    # rounded square root).
    hyp = torch.sqrt(f32.fma_f32(x, x, y * y).double()).float()
    # atan2 as the reference's C library rounds it: beams of the synthetic
    # OS1-64 sit exactly on its ring bounds, where the last ulp decides.
    rad = f32ops.atan2(z, hyp)
    angle = rad * _DEG

    def trunc(v):
        return torch.trunc(v).to(torch.int32)

    # Where the angle feeds one sum, the reference's compiled code forms
    # angle + c as one fused multiply-add of the radians.
    if lidar_type == "VLP16":
        sid = trunc(f32.fma_f32(rad, _DEG, 15.0) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL32":
        sid = trunc(f32.fma_f32(rad, _DEG, 92.0 / 3.0) * 3.0 / 4.0)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    elif lidar_type == "HDL64":
        upper = trunc((2.0 - angle) * 3.0 + 0.5)
        lower = n_scans // 2 + trunc((-8.83 - angle) * 2.0 + 0.5)
        sid = torch.where(angle >= -8.83, upper, lower)
        ok = (angle <= 2.0) & (angle >= -24.33) & (sid >= 0) & (sid <= 50)
    elif lidar_type == "OS1-64":
        sid = trunc(f32.fma_f32(rad, _DEG, 22.5) / 2.0 + 0.5)
        ok = (sid >= 0) & (sid <= n_scans - 1)
    else:
        raise ValueError(f"unknown lidar_type {lidar_type}")
    return torch.clamp(sid, 0, n_scans - 1), ok


# ---------------------------------------------------------------------------
# Azimuth unwrap -> relative time
# ---------------------------------------------------------------------------


def _first_true(b: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none)."""
    return torch.argmax(b.to(torch.int32))


def _azimuth_scalars(xyz: torch.Tensor, valid: torch.Tensor, flip_valid: torch.Tensor):
    """Scalar side of the sequential halfPassed unwrap: sweep start/end
    azimuths, the index of the first flip and whether any point flips."""
    n = xyz.shape[0]
    ori_raw = -f32ops.atan2(xyz[:, 1], xyz[:, 0])
    first = _first_true(valid)
    last = n - 1 - _first_true(torch.flip(valid, dims=[0]))
    # index_select, not ori_raw[first]: a 0-d index tensor would be read
    # back to the host.
    start_ori = ori_raw.index_select(0, first.reshape(1))[0]
    last_ori = ori_raw.index_select(0, last.reshape(1))[0]
    end_ori = last_ori + 2 * _PI
    d = end_ori - start_ori
    # The reference's compiled code folds (a + c1) +- c2 into a + (c1 +- c2):
    # end_ori -+ 2 pi is last_ori + 0 or last_ori + 4 pi, one rounding.
    end_ori = torch.where(
        d > 3 * _PI, last_ori, torch.where(d < _PI, last_ori + 4 * _PI, end_ori)
    )
    o1 = ori_raw
    o1 = torch.where(o1 < start_ori - _PI / 2, o1 + 2 * _PI, o1)
    o1 = torch.where(o1 > start_ori + 3 * _PI / 2, o1 - 2 * _PI, o1)
    flip = (o1 - start_ori > _PI) & flip_valid
    return start_ori, end_ori, _first_true(flip), torch.any(flip)


def _relative_time_at(x, y, idx, start_ori, end_ori, first_flip, any_flip):
    """Per-point half of the unwrap, evaluable in any order (idx is the
    original stream position, deciding halfPassed)."""
    ori_raw = -f32ops.atan2(y, x)
    o1 = ori_raw
    o1 = torch.where(o1 < start_ori - _PI / 2, o1 + 2 * _PI, o1)
    o1 = torch.where(o1 > start_ori + 3 * _PI / 2, o1 - 2 * _PI, o1)
    o2 = ori_raw + 2 * _PI
    # (ori_raw + 2 pi) + 2 pi, folded as the reference's compiled code folds it
    o2 = torch.where(o2 < end_ori - 3 * _PI / 2, ori_raw + 4 * _PI, o2)
    o2 = torch.where(o2 > end_ori + _PI / 2, o2 - 2 * _PI, o2)
    half_passed = (idx > first_flip) & any_flip
    ori = torch.where(half_passed, o2, o1)
    return (ori - start_ori) / (end_ori - start_ori)


# ---------------------------------------------------------------------------
# Range image build
# ---------------------------------------------------------------------------


def build_range_image(xyz, ring, valid, n_scans: int, width: int, rel_scalars) -> RangeImage:
    """Bucket stream-ordered points into [n_scans, width], preserving stream
    order within a ring: one sort on the unique key ring << 17 | index, then
    every row is a contiguous slice of the sorted stream (one gather)."""
    n = xyz.shape[0]
    if n > (1 << 17):
        raise ValueError("packed sort key holds 17 index bits")
    dev = xyz.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    key = (torch.where(valid, ring, n_scans).to(torch.int32) << 17) | iota
    key_s, order = torch.sort(key)
    ring_s = (key_s >> 17).contiguous()
    idx_s = key_s & ((1 << 17) - 1)
    xs = xyz[order]
    rel_s = _relative_time_at(xs[:, 0], xs[:, 1], idx_s, *rel_scalars)

    # Each ring's start in the sorted stream: the count of keys below it (a
    # left searchsorted; counted, since under vmap searchsorted copies its
    # unbatched values).
    rings = torch.arange(n_scans + 1, dtype=torch.int32, device=dev)
    bounds = torch.sum(ring_s[None, :] < rings[:, None], dim=1)
    counts = torch.clamp(bounds[1:] - bounds[:-1], max=width).to(torch.int32)

    packed = torch.cat([xs, rel_s[:, None]], dim=1)  # [n, 4]
    padded = torch.cat([packed, packed.new_zeros((width, 4))])  # past n: zeros
    cols = torch.arange(width, device=dev)
    grid = padded[bounds[:n_scans, None] + cols[None, :]]  # [S, W, 4]
    mask = cols[None, :] < counts[:, None]
    grid = torch.where(mask[:, :, None], grid, 0.0)
    return RangeImage(xyz=grid[:, :, :3], mask=mask, rel_time=grid[:, :, 3], count=counts)


# ---------------------------------------------------------------------------
# Curvature + suppression reach
# ---------------------------------------------------------------------------


def _curvature(img: torch.Tensor, radius: int = 5) -> torch.Tensor:
    """curv[r, j] = | sum_{|l|<=R} x[r, j+l] - (2R+1) x[r, j] |^2, from a
    prefix sum padded by edge values (edges are masked by the caller)."""
    S, w = img.shape[0], img.shape[1]
    wl = 2 * radius + 1
    csum = _cumsum_f32(torch.cat([img.new_zeros((S, 1, 3)), img], dim=1), dim=1)
    padded = torch.cat(
        [csum[:, :1].expand(S, radius, 3), csum, csum[:, -1:].expand(S, radius, 3)],
        dim=1,
    )
    win = (padded[:, wl:] - padded[:, :-wl])[:, :w]
    # The reference's compiler contracts `win - wl*img` and the squared sum
    # into fused multiply-adds (one rounding each). For planar points the
    # difference cancels to a few ulps of `win`, so the curvature ordering
    # hangs on that rounding: one rounding per fused step (f32).
    return f32ops.sum3_sq(f32.fma_f32(img, -float(wl), win))


def _suppression_reach(img: torch.Tensor, count: torch.Tensor, radius: int, gap_sq: float):
    """How far neighbor suppression extends right/left of each point before
    a range discontinuity."""
    S, w = img.shape[0], img.shape[1]
    dev = img.device
    g = f32ops.sum3_sq(img[:, 1:] - img[:, :-1])  # gap between j and j+1
    in_ring = torch.arange(w - 1, device=dev)[None, :] < (count[:, None] - 1)
    ok = (g <= gap_sq) & in_ring
    pad = ok.new_zeros((S, radius))
    okp = torch.cat([ok, pad], dim=1)  # right lookahead
    right = torch.zeros((S, w), dtype=torch.int32, device=dev)
    run = torch.ones((S, w), dtype=torch.bool, device=dev)
    for l in range(radius):
        run = run & okp[:, l : l + w]
        right = right + run.to(torch.int32)
    okp2 = torch.cat([pad, ok], dim=1)
    left = torch.zeros((S, w), dtype=torch.int32, device=dev)
    run = torch.ones((S, w), dtype=torch.bool, device=dev)
    for l in range(radius):
        run = run & okp2[:, radius - 1 - l : radius - 1 - l + w]
        left = left + run.to(torch.int32)
    return left, right


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


class SelectionInputs(NamedTuple):
    """Everything feature selection reads, and the range image it indexes."""

    ri: RangeImage
    curv: torch.Tensor  # [S, W] f32
    left_ext: torch.Tensor  # [S, W] int32
    right_ext: torch.Tensor  # [S, W] int32
    eligible: torch.Tensor  # [S, W] bool
    sp: torch.Tensor  # [S, NSUB] int32 subregion starts
    ep: torch.Tensor  # [S, NSUB] int32 subregion ends (inclusive)
    ring_sel_ok: torch.Tensor  # [S] bool


def selection_inputs(scan: LidarScan, cfg: SlamConfig) -> SelectionInputs:
    """Steps 1-4 of the extraction: filtering, ring ids, the range image,
    curvature, suppression reach and the subregion bounds."""
    sensor, feat = cfg.sensor, cfg.features
    S, W = sensor.n_scans, sensor.max_points_per_ring
    xyz, mask = scan.xyz, scan.mask
    dev = xyz.device

    # NaN + near-range removal.
    finite = torch.all(torch.isfinite(xyz), dim=-1)
    valid = mask & finite & (f32ops.sum3_sq(xyz) >= sensor.minimum_range**2)

    ring, ring_ok = _ring_id(xyz, sensor.lidar_type, S)
    rel_scalars = _azimuth_scalars(xyz, valid, valid & ring_ok)
    valid = valid & ring_ok
    ri = build_range_image(xyz, ring, valid, S, W, rel_scalars)

    R = feat.curvature_window
    curv = _curvature(ri.xyz, R)
    left_ext, right_ext = _suppression_reach(
        ri.xyz, ri.count, feat.neighbor_suppress_radius, feat.neighbor_suppress_gap_sq
    )
    NSUB = feat.n_subregions
    L = ri.count - (2 * R + 1)  # selectable span length
    j_sub = torch.arange(NSUB, dtype=torch.int32, device=dev)
    sp = (R + (L[:, None] * j_sub[None, :]) // NSUB).to(torch.int32)
    ep = (R + (L[:, None] * (j_sub[None, :] + 1)) // NSUB - 1).to(torch.int32)
    ring_sel_ok = L >= NSUB
    jj = torch.arange(W, device=dev)[None, :]
    eligible = (jj >= R) & (jj <= (R - 1 + L)[:, None]) & ring_sel_ok[:, None]
    return SelectionInputs(ri, curv, left_ext, right_ext, eligible, sp, ep, ring_sel_ok)


def extract_features(scan: LidarScan, cfg: SlamConfig) -> ScanFeatures:
    feat = cfg.features
    si = selection_inputs(scan, cfg)
    corner_idx, corner_ok, flat_idx, flat_ok, labels = selection.select_features(
        si.curv, si.left_ext, si.right_ext, si.eligible, si.sp, si.ep,
        n_sub=feat.n_subregions,
        n_corner=feat.less_sharp_per_subregion,
        n_flat=feat.flat_per_subregion,
        curv_thr=feat.curvature_threshold,
    )
    return _assemble_outputs(cfg, si.ri, corner_idx, corner_ok, flat_idx,
                             flat_ok, labels, si.ring_sel_ok)


def _assemble_outputs(cfg, ri, corner_idx, corner_ok, flat_idx, flat_ok,
                      labels, ring_sel_ok) -> ScanFeatures:
    feat = cfg.features
    img, count = ri.xyz, ri.count
    S, W = img.shape[0], img.shape[1]
    dev = img.device
    rows3 = torch.arange(S, device=dev)[:, None, None]
    dropped = []  # valid rows lost to capacity truncation

    def to_cloud(idx, ok, capacity, first_k=None):
        if first_k is not None:
            idx, ok = idx[:, :, :first_k], ok[:, :, :first_k]
        idx = idx.to(torch.int64)
        g_xyz = img[rows3, idx].reshape(-1, 3)
        g_ring = rows3.to(torch.float32).expand(idx.shape).reshape(-1)
        g_rt = ri.rel_time[rows3, idx].reshape(-1)
        n_ok = torch.sum(ok.to(torch.int32))
        dropped.append(torch.clamp(n_ok - capacity, min=0))
        m, x, r, t = voxel.compact(ok.reshape(-1), capacity, g_xyz, g_ring, g_rt)
        return FeatureCloud(xyz=x, ring=torch.where(m, r, -1.0), rel_time=t, mask=m)

    sharp = to_cloud(corner_idx, corner_ok, feat.max_sharp, first_k=feat.sharp_per_subregion)
    less_sharp = to_cloud(corner_idx, corner_ok, feat.max_less_sharp)
    flat = to_cloud(flat_idx, flat_ok, feat.max_flat)

    # Less-flat: subregion points not labeled corner, voxel-filtered per ring.
    R = feat.curvature_window
    jj = torch.arange(W, device=dev)[None, :]
    sub_range = (jj >= R) & (jj <= (count[:, None] - (R + 2))) & ring_sel_ok[:, None]
    lf_mask = sub_range & ~labels & ri.mask
    dx, dm, dring, de, lf_dropped = voxel.voxel_downsample_rows(
        img, lf_mask, feat.less_flat_voxel_size, feat.max_less_flat,
        extra=ri.rel_time[:, :, None],
    )
    less_flat = FeatureCloud(xyz=dx, ring=torch.where(dm, dring, -1.0), rel_time=de[:, 0], mask=dm)
    overflow = (sum(dropped) + lf_dropped).to(torch.int32)
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, full=ri, overflow=overflow)
