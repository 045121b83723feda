"""Voxel-grid downsampling, compaction and brute-force k-NN
(counterpart of scaloam_tpu/ops/voxel.py).

The reference's one-hot-matmul payload selects, bf16 splits, blocked scans
and TPU tile tuning are not carried over: winners are index gathers and
prefix sums are torch.cumsum. The NN searches rank by the reference's
|q|^2 + |t|^2 - 2 q.t, rounded as the reference's CPU program rounds it
(kernels.f32ops.sq_dist; it may dip below 0 for coincident points, and
callers clamp the winners at 0 as the reference does), since the ranking
of near-ties changes the odometry solve. Sorts are stable so equal keys
keep index order, as the reference's CPU sort does; ties in every top-k
go to the lowest index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scaloam_tpu_torch.ops import f32
from scaloam_tpu_torch.ops.kernels import f32ops

BIG = 1e30  # sentinel distance for masked pairs
_INT32_MAX = 2**31 - 1
_SENTINEL = 2**30  # voxel key of an invalid point: sorts after every real one


def _zero_of(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=a.dtype, device=a.device)


def compact(mask: torch.Tensor, capacity: int, *arrays: torch.Tensor):
    """Stable-compact valid rows to the front, truncated/padded to capacity.
    Returns (new_mask, *compacted_arrays); rows past the valid ones are 0."""
    n = mask.shape[0]
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, iota, n + iota)
    order = torch.argsort(key)  # keys are unique
    pad = max(0, capacity - n)
    new_mask = key[order][:capacity] < n
    if pad:
        new_mask = torch.cat([new_mask, new_mask.new_zeros(pad)])
    outs = []
    for a in arrays:
        got = a[order][:capacity]
        if pad:
            got = torch.cat([got, got.new_zeros((pad,) + got.shape[1:])])
        m = new_mask.reshape(new_mask.shape + (1,) * (got.ndim - 1))
        outs.append(torch.where(m, got, _zero_of(got)))
    return (new_mask,) + tuple(outs)


def _shift_up(a: torch.Tensor, w: int, dim: int, fill=0) -> torch.Tensor:
    """a shifted towards lower indices by w along dim, `fill` at the end."""
    pad_shape = list(a.shape)
    pad_shape[dim] = w
    return torch.cat(
        [a.narrow(dim, w, a.shape[dim] - w),
         torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)],
        dim=dim,
    )


def _window_sums(vals, sn, dim: int, mean_window: int):
    """Segmented sum over the next <= mean_window members of each run by
    log-step doubling (sn[i]: i+1 continues i's run). Returns (acc, cnt)."""
    acc = vals
    cnt = torch.ones(sn.shape, dtype=torch.float32, device=sn.device)
    f = sn
    step = 1
    while step < mean_window:
        acc = acc + torch.where(f[..., None], _shift_up(acc, step, dim), 0.0)
        cnt = cnt + torch.where(f, _shift_up(cnt, step, dim), 0.0)
        if 2 * step < mean_window:
            f = f & _shift_up(f, step, dim, fill=False)
        step *= 2
    return acc, cnt


def _lexsort(keys) -> torch.Tensor:
    """numpy.lexsort's order (the last key is the primary one, ties keep
    index order) by chained stable sorts, least significant key first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def voxel_downsample(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    capacity: int,
    extra: Optional[torch.Tensor] = None,
    group_key: Optional[torch.Tensor] = None,
    priority_center: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Centroid voxel filter with fixed output capacity (the reference's
    generic filter, PCL VoxelGrid semantics).

    Voxels are ordered by (group_key, [Chebyshev cell distance to
    priority_center], x, y, z) and numbered in that order; voxels past
    `capacity` are dropped, so `priority_center` keeps the nearest ones
    when the occupied-voxel count overflows. Invalid points carry the
    sentinel 2**30 in every key and sort last. `extra` [N, E] is
    centroid-averaged alongside.
    Returns (xyz [capacity, 3], mask [capacity], extra [capacity, E] or None)."""
    n = xyz.shape[0]
    coords = torch.where(mask[:, None], f32.cell_of(xyz, voxel_size), _SENTINEL)
    gk = (torch.where(mask, group_key.to(torch.int32), _SENTINEL) if group_key is not None
          else torch.zeros(n, dtype=torch.int32, device=xyz.device))
    keys = [coords[:, 2], coords[:, 1], coords[:, 0]]
    if priority_center is not None:
        cc = f32.cell_of(priority_center, voxel_size)
        dist = torch.amax(torch.abs(coords - cc[None, :]), dim=-1)
        keys.append(torch.where(mask, dist, _SENTINEL))
    order = _lexsort(keys + [gk])
    coords_s, gk_s, mask_s = coords[order], gk[order], mask[order]

    same = torch.all(coords_s[1:] == coords_s[:-1], dim=-1) & (gk_s[1:] == gk_s[:-1])
    new_voxel = ~torch.cat([same.new_zeros(1), same]) & mask_s
    seg = torch.cumsum(new_voxel.to(torch.int64), 0) - 1  # first voxel -> 0
    seg = torch.clamp(torch.where(mask_s, seg, capacity), max=capacity)  # overflow bin

    ones = mask_s.to(torch.float32)
    vals = xyz[order] if extra is None else torch.cat([xyz, extra], dim=1)[order]
    sums = vals.new_zeros((capacity + 1, vals.shape[1])).index_add_(0, seg, vals * ones[:, None])
    counts = ones.new_zeros(capacity + 1).index_add_(0, seg, ones)[:capacity]
    out = sums[:capacity] / torch.clamp(counts, min=1.0)[:, None]
    return out[:, :3], counts > 0, (out[:, 3:] if extra is not None else None)


def voxel_downsample_packed(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    capacity: int,
    extra: Optional[torch.Tensor] = None,
    xy_bits: int = 10,
    z_bits: int = 9,
    shell_bits: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Centroid voxel filter on one packed int32 key [shell | cx | cy | cz]
    (coords centred on the masked centroid and clipped to the bit range).
    Each voxel averages its first 8 points in sort order. shell_bits > 0
    orders voxels by a Chebyshev-distance shell so that the farthest are
    dropped first when the voxel count exceeds `capacity`.
    Returns (xyz [min(capacity, N), 3], mask, extra or None)."""
    n = xyz.shape[0]
    coords = f32.cell_of(xyz, voxel_size)
    denom = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
    center = torch.sum(torch.where(mask[:, None], coords, 0), dim=0) // denom
    c = (coords - center[None, :]).to(torch.int32)

    def clipb(v, bits):
        half = 1 << (bits - 1)
        return torch.clamp(v + half, 0, (1 << bits) - 1)

    key = clipb(c[:, 0], xy_bits)
    key = (key << xy_bits) | clipb(c[:, 1], xy_bits)
    if z_bits > 0:
        key = (key << z_bits) | clipb(c[:, 2], z_bits)
    used_bits = xy_bits * 2 + z_bits
    if shell_bits > 0:
        cheb = torch.clamp(torch.amax(torch.abs(c), dim=-1), min=1)
        base = 1 << (xy_bits - 4)  # first shell radius: 1/8 of half-range
        # The reference's shell, clip(ceil(log2(cheb / base) + 1)), in
        # integers: shell s >= 2 holds cheb > base * 2^(s - 2). Compiled
        # (as its keyframe prep always runs), its float32 log2 lands just
        # above -1 at cheb == base / 2, which so falls in shell 1, not 0.
        shell = (2 * cheb >= base).to(torch.int32)
        for level in range(2, 1 << shell_bits):
            shell = shell + (4 * cheb > base << level).to(torch.int32)
        key = (shell << used_bits) | key
    key = torch.where(mask, key, _INT32_MAX).to(torch.int32)

    key_s, order = torch.sort(key, stable=True)
    mask_s = mask[order]
    vals = xyz[order] if extra is None else torch.cat([xyz, extra], dim=1)[order]
    vals = torch.where(mask_s[:, None], vals, 0.0)

    same = key_s[1:] == key_s[:-1]
    prev_same = torch.cat([same.new_zeros(1), same])
    new_voxel = ~prev_same & mask_s
    sn = torch.cat([same & mask_s[1:], same.new_zeros(1)])
    acc, cnt = _window_sums(vals, sn, 0, 8)

    # Voxel starts in order, then `capacity` rows gathered.
    pos = torch.arange(n, device=xyz.device)
    start_pos = torch.argsort(torch.where(new_voxel, pos, n + pos))[:capacity]
    sp_c = torch.clamp(start_pos, max=n - 1)
    is_real = new_voxel[sp_c] & (start_pos < n)
    cnt_g = torch.clamp(cnt[sp_c], min=1.0)[:, None]
    out = acc[sp_c] / cnt_g
    out_extra = out[:, 3:] if extra is not None else None
    return out[:, :3], is_real, out_extra


def voxel_downsample_rows(
    img: torch.Tensor,  # [S, W, 3] range-image points (azimuth-ordered rows)
    mask: torch.Tensor,  # [S, W]
    voxel_size: float,
    capacity: int,
    extra: Optional[torch.Tensor] = None,  # [S, W, E]
    mean_window: int = 8,
):
    """Per-ring voxel filter on range-image rows: points sharing an (x, y)
    voxel form consecutive runs along a row; each run keeps the mean of its
    first `mean_window` points. When runs exceed `capacity`, each ring gets
    a slot budget proportional to its run count and decimates uniformly.
    Returns (xyz [capacity, 3], mask [capacity], ring [capacity] float,
    extra [capacity, E] or None, dropped int scalar), ring-major."""
    S, W = mask.shape
    n = S * W
    dev = img.device
    c = f32.cell_of(img[:, :, :2], voxel_size)
    same = torch.all(c[:, 1:] == c[:, :-1], dim=-1) & mask[:, 1:] & mask[:, :-1]
    same_as_prev = torch.cat([same.new_zeros((S, 1)), same], dim=1)
    new_run = mask & ~same_as_prev

    vals = img if extra is None else torch.cat([img, extra], dim=-1)
    vals = torch.where(mask[:, :, None], vals, 0.0)
    sn = torch.cat([same_as_prev[:, 1:], same.new_zeros((S, 1))], dim=1)
    acc, cnt = _window_sums(vals, sn, 1, mean_window)

    nr = new_run.to(torch.int64)
    rwr = torch.cumsum(nr, dim=1) - 1  # run number within ring
    runs_r = torch.sum(nr, dim=1)  # [S]
    total = torch.clamp(torch.sum(runs_r), min=1)
    nnz = torch.sum((runs_r > 0).to(torch.int64))
    prop = 1 + ((capacity - nnz) * runs_r) // total
    budget = torch.where(
        total <= capacity, runs_r, torch.where(runs_r > 0, prop, 0)
    )
    dec = torch.where(budget > 0, -(-runs_r // torch.clamp(budget, min=1)), 1)
    offs = torch.cumsum(budget, dim=0) - budget
    keep = new_run & (budget > 0)[:, None] & (rwr % dec[:, None] == 0)
    slot = offs[:, None] + rwr // dec[:, None]
    oidx = torch.where(keep, slot, capacity).reshape(-1)
    ring_ch = torch.arange(S, dtype=torch.float32, device=dev)[:, None].expand(S, W)

    key_s, order = torch.sort(oidx, stable=True)
    av = acc.reshape(n, -1)[order]
    cnt_s = cnt.reshape(-1)[order]
    ring_s = ring_ch.reshape(-1)[order]
    if n < capacity:
        pad = capacity - n
        key_s = torch.cat([key_s, key_s.new_full((pad,), capacity)])
        av = torch.cat([av, av.new_zeros((pad, av.shape[1]))])
        cnt_s = torch.cat([cnt_s, cnt_s.new_zeros(pad)])
        ring_s = torch.cat([ring_s, ring_s.new_zeros(pad)])
    got = key_s[:capacity] < capacity
    mean_o = av[:capacity] / torch.clamp(cnt_s[:capacity], min=1.0)[:, None]
    out_extra = mean_o[:, 3:] if extra is not None else None
    dropped = torch.sum(runs_r) - torch.sum(keep.to(torch.int64))
    return mean_o[:, :3], got, ring_s[:capacity], out_extra, dropped


def argmin_topk(d: torch.Tensor, k: int, payload: Optional[torch.Tensor] = None):
    """Ascending top-k of d [Q, M] by k iterated argmins (ties to the lowest
    index; an exhausted row repeats index 0 like the reference). payload
    [Q, M, C] rows ride along. Returns (vals [Q, k], rows [Q, k, C] or None)."""
    dd = d
    vals, rows = [], []
    for _ in range(k):
        j = torch.argmin(dd, dim=1, keepdim=True)
        vals.append(torch.gather(dd, 1, j)[:, 0])
        if payload is not None:
            C = payload.shape[2]
            rows.append(torch.gather(payload, 1, j[:, :, None].expand(-1, 1, C))[:, 0])
        dd = dd.scatter(1, j, BIG)  # out of place: vmap batches it
    return (
        torch.stack(vals, dim=1),
        torch.stack(rows, dim=1) if payload is not None else None,
    )


# ---------------------------------------------------------------------------
# Brute-force 2-NN (the KD-tree replacement)
# ---------------------------------------------------------------------------


def tile_top2(d: torch.Tensor, base: int):
    """Smallest two entries per row of d [Q, tile] by double argmin.
    Returns (d1, i1, d2, i2) with indices offset by base."""
    j1 = torch.argmin(d, dim=1, keepdim=True)
    v1 = torch.gather(d, 1, j1)[:, 0]
    d = d.scatter(1, j1, BIG)  # out of place: vmap batches it
    j2 = torch.argmin(d, dim=1, keepdim=True)
    v2 = torch.gather(d, 1, j2)[:, 0]
    return v1, base + j1[:, 0], v2, base + j2[:, 0]


def merge_top2(best, tile):
    """Merge two per-row ascending (d, idx) pairs into the overall smallest
    two; on equal distances the earlier candidate list wins."""
    b1d, b1i, b2d, b2i = best
    v1d, v1i, v2d, v2i = tile
    t = v1d < b1d
    f1d = torch.where(t, v1d, b1d)
    f1i = torch.where(t, v1i, b1i)
    l1d = torch.where(t, b1d, v1d)
    l1i = torch.where(t, b1i, v1i)
    o2d = torch.where(t, v2d, b2d)
    o2i = torch.where(t, v2i, b2i)
    s = l1d < o2d
    return f1d, f1i, torch.where(s, l1d, o2d), torch.where(s, l1i, o2i)


def empty_top2(q: int, device):
    """Initial running top-2: BIG distances and index -1 (no winner yet;
    its payload row reads as zeros)."""
    d = torch.full((q,), BIG, dtype=torch.float32, device=device)
    i = torch.full((q,), -1, dtype=torch.int64, device=device)
    return d, i, d, i


def fit_tile(n: int, tile: int) -> int:
    """Largest tile <= `tile` by halving that divides n."""
    while n % tile != 0:
        tile //= 2
    return tile


def gather_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [T, C] at idx [...]; index -1 gives a zero row."""
    got = rows[torch.clamp(idx, min=0)]
    return torch.where((idx >= 0)[..., None], got, _zero_of(got))


def knn(query, query_mask, target, target_mask, k: int, tile: int = 2048):
    """Exact k-NN by brute force over target tiles, ranked by |q|^2 + |t|^2
    - 2 q.t. Returns (d [Q, k] ascending squared distances, clamped at 0 and
    BIG for masked queries; idx [Q, k] int64 target indices). Ties go to the
    lowest index; a slot no valid target fills keeps index 0."""
    tile = fit_tile(target.shape[0], tile)
    Q = query.shape[0]
    dev = query.device
    best_d = torch.full((Q, k), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=dev)
    if k == 2:
        best = (best_d[:, 0], best_i[:, 0], best_d[:, 1], best_i[:, 1])
    for t0 in range(0, target.shape[0], tile):
        d = f32ops.sq_dist(query, target[t0 : t0 + tile])
        d = torch.where(target_mask[None, t0 : t0 + tile], d, BIG)
        if k == 1:
            v, j = torch.min(d, dim=1)  # first index among equal minima
            upd = v < best_d[:, 0]
            best_d = torch.where(upd, v, best_d[:, 0])[:, None]
            best_i = torch.where(upd, t0 + j, best_i[:, 0])[:, None]
        elif k == 2:
            best = merge_top2(best, tile_top2(d, t0))
        else:
            # Running top-k: the tile's k smallest, then the k smallest of
            # (running, tile) with the running list first; stable sorts keep
            # the lower position on ties.
            tv, tj = torch.sort(d, dim=1, stable=True)
            cat_d = torch.cat([best_d, tv[:, :k]], dim=1)
            cat_i = torch.cat([best_i, t0 + tj[:, :k]], dim=1)
            nd, nj = torch.sort(cat_d, dim=1, stable=True)
            best_d, best_i = nd[:, :k], torch.gather(cat_i, 1, nj[:, :k])
    if k == 2:
        best_d = torch.stack([best[0], best[2]], dim=1)
        best_i = torch.stack([best[1], best[3]], dim=1)
    best_d = torch.where(query_mask[:, None], torch.clamp(best_d, min=0.0), BIG)
    return best_d, best_i


def nn1(query, query_mask, target, target_mask, tile: int = 2048):
    """1-NN: ([Q] squared distance, [Q] index)."""
    d, i = knn(query, query_mask, target, target_mask, k=1, tile=tile)
    return d[:, 0], i[:, 0]


def pad_to_multiple(xyz: torch.Tensor, mask: torch.Tensor, multiple: int):
    """Pad the point dim up to a multiple with masked rows."""
    pad = (-xyz.shape[0]) % multiple
    if pad == 0:
        return xyz, mask
    return (
        torch.cat([xyz, xyz.new_zeros((pad, xyz.shape[1]))]),
        torch.cat([mask, mask.new_zeros(pad)]),
    )


def knn2_payload(query, query_mask, target, target_mask, payload, tile: int = 8192):
    """2-NN over target tiles; returns (d [Q, 2] ascending squared
    distances, BIG for masked queries; P [Q, 2, C] the winners' payload
    rows). The [Q, tile] distance block is the only large temporary."""
    tile = fit_tile(target.shape[0], tile)
    best = empty_top2(query.shape[0], query.device)
    for t0 in range(0, target.shape[0], tile):
        d = f32ops.sq_dist(query, target[t0 : t0 + tile])
        d = torch.where(target_mask[None, t0 : t0 + tile], d, BIG)
        best = merge_top2(best, tile_top2(d, t0))
    b1d, b1i, b2d, b2i = best
    d = torch.stack([b1d, b2d], dim=1)
    d = torch.where(query_mask[:, None], torch.clamp(d, min=0.0), BIG)
    return d, gather_rows(payload, torch.stack([b1i, b2i], dim=1))
