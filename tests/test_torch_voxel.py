"""PyTorch port vs JAX reference: voxel filters, compaction, brute-force
2-NN, the ring-constrained companion search and the torus grid map.

Same numpy inputs (made from a seed) go through both on the CPU. Masks,
counts and grid bookkeeping must match exactly; coordinates within 1e-5
(filters, averaging the same points in the same order) or 1e-6 (grid
writes, copies). Both 2-NN searches rank by |q|^2 + |t|^2 - 2 q.t, but
the port's f32 matmul may round differently from XLA's, so a near-tie may
still pick another candidate: winners must agree for >= 99% of valid
queries and, where they differ, be equally near within 1e-3 m^2."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaloam_tpu.ops import correspond as jcorr, gridmap as jgrid, voxel as jvox
from scaloam_tpu_torch.ops import correspond as tcorr, gridmap as tgrid, voxel as tvox
from torch_threads import two_threads  # noqa: F401  (autouse)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("capacity", [300, 700])
def test_compact(capacity):
    rng = np.random.default_rng(capacity)
    n = 500
    mask = rng.uniform(size=n) < 0.6
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    ring = rng.integers(0, 64, n).astype(np.float32)
    idx = rng.integers(0, 1000, n).astype(np.int32)
    want = jvox.compact(jnp.asarray(mask), capacity, *map(jnp.asarray, (xyz, ring, idx)))
    got = tvox.compact(torch.tensor(mask), capacity, *map(torch.tensor, (xyz, ring, idx)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))


def _ring_image(rng, S=8, W=240):
    """Azimuth-ordered rows: consecutive points ~5 cm apart along arcs with
    range jumps, so 0.2 m voxels hold runs of several points."""
    az = np.cumsum(rng.uniform(0.002, 0.006, size=(S, W)), axis=1)
    r = 10 + np.cumsum(np.where(rng.uniform(size=(S, W)) < 0.03, rng.normal(0, 2, (S, W)), 0.0), axis=1)
    img = np.stack([r * np.cos(az), r * np.sin(az), np.broadcast_to(np.arange(S)[:, None] * 0.3, (S, W))], -1)
    mask = rng.uniform(size=(S, W)) < 0.9
    rel = rng.uniform(size=(S, W, 1))
    return img.astype(np.float32), mask, rel.astype(np.float32)


@pytest.mark.parametrize("capacity", [2048, 120])
def test_voxel_downsample_rows(capacity):
    rng = np.random.default_rng(1)
    img, mask, rel = _ring_image(rng)
    want = jvox.voxel_downsample_rows(jnp.asarray(img), jnp.asarray(mask), 0.2, capacity, extra=jnp.asarray(rel))
    got = tvox.voxel_downsample_rows(torch.tensor(img), torch.tensor(mask), 0.2, capacity, extra=torch.tensor(rel))
    wx, wm, wr, we, wd = map(_np, want)
    gx, gm, gr, ge, gd = map(_np, got)
    np.testing.assert_array_equal(gm, wm)
    assert int(gd) == int(wd)
    assert (int(wd) > 0) == (capacity < 1000)  # the small capacity overflows
    np.testing.assert_allclose(gx[wm], wx[wm], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gr[wm], wr[wm])
    np.testing.assert_allclose(ge[wm], we[wm], atol=1e-5, rtol=0)


def _cloud(rng, n=3000):
    centers = rng.uniform(-30, 30, size=(40, 3))
    pts = centers[rng.integers(0, 40, n)] + rng.normal(0, 1.5, (n, 3))
    return pts.astype(np.float32), rng.uniform(size=n) < 0.9


# The reference's filters as its pipeline runs them, compiled: an eager call
# divides by the leaf size and evaluates log2 where the compiled program
# multiplies by the reciprocal and folds the log.
_jit_packed = jax.jit(jvox.voxel_downsample_packed, static_argnums=(2, 3),
                      static_argnames=("xy_bits", "z_bits", "shell_bits"))
_jit_rows = jax.jit(jvox.voxel_downsample_rows, static_argnums=(2, 3))


@pytest.mark.parametrize("capacity,shell,extra", [
    (2048, 0, False), (2048, 2, True), (300, 2, True), (300, 0, False),
])
def test_voxel_downsample_packed(capacity, shell, extra):
    rng = np.random.default_rng(capacity + shell)
    xyz, mask = _cloud(rng)
    ext = rng.uniform(0, 64, (xyz.shape[0], 1)).astype(np.float32) if extra else None
    want = _jit_packed(
        jnp.asarray(xyz), jnp.asarray(mask), 0.4, capacity,
        extra=None if ext is None else jnp.asarray(ext), xy_bits=10, z_bits=9, shell_bits=shell)
    got = tvox.voxel_downsample_packed(
        torch.tensor(xyz), torch.tensor(mask), 0.4, capacity,
        extra=None if ext is None else torch.tensor(ext), xy_bits=10, z_bits=9, shell_bits=shell)
    wm, gm = _np(want[1]), _np(got[1])
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(_np(got[0])[wm], _np(want[0])[wm], atol=1e-5, rtol=0)
    if extra:
        np.testing.assert_allclose(_np(got[2])[wm], _np(want[2])[wm], atol=1e-5, rtol=0)


def _check_winners(q, qmask, want_pts, got_pts, want_d, got_d):
    """Per slot: same winner for >= 99% of valid queries; a different winner
    is a near-tie (distances within 1e-3 m^2)."""
    q = q[qmask].astype(np.float64)
    for s in range(2):
        wp, gp = want_pts[qmask, s], got_pts[qmask, s]
        same = np.all(wp == gp, axis=-1)
        assert same.mean() >= 0.99, (s, same.mean())
        dw = np.sum((wp - q) ** 2, -1)
        dg = np.sum((gp - q) ** 2, -1)
        np.testing.assert_allclose(dg, dw, atol=1e-3, rtol=0)
    big = want_d >= 1e29
    np.testing.assert_array_equal(got_d >= 1e29, big)
    np.testing.assert_allclose(got_d[~big], want_d[~big], atol=1e-3, rtol=0)


@pytest.mark.parametrize("tile", [1024, 4096])
def test_knn2_payload(tile):
    rng = np.random.default_rng(tile)
    tgt, tmask = _cloud(rng, 4096)
    q = tgt[rng.integers(0, 4096, 400)] + rng.normal(0, 0.3, (400, 3)).astype(np.float32)
    qmask = rng.uniform(size=400) < 0.9
    payload = np.concatenate([tgt, rng.integers(0, 64, (4096, 1)), np.arange(4096)[:, None]], 1).astype(np.float32)
    wd, wp = jvox.knn2_payload(*map(jnp.asarray, (q, qmask, tgt, tmask, payload)), tile=tile)
    gd, gp = tvox.knn2_payload(*map(torch.tensor, (q, qmask, tgt, tmask, payload)), tile=tile)
    _check_winners(q, qmask, _np(wp)[..., :3], _np(gp)[..., :3], _np(wd), _np(gd))


@pytest.mark.parametrize("want_same", [True, False])
def test_ring_constrained_nn2_pts(want_same):
    rng = np.random.default_rng(int(want_same))
    tgt, tmask = _cloud(rng, 4096)
    tring = rng.integers(0, 16, 4096).astype(np.float32)
    qi = rng.integers(0, 4096, 400)
    q = tgt[qi] + rng.normal(0, 0.3, (400, 3)).astype(np.float32)
    qmask = rng.uniform(size=400) < 0.9
    args = (q, qmask, tring[qi], qi.astype(np.int32), tgt, tmask, tring)
    want = jcorr.ring_constrained_nn2_pts(*map(jnp.asarray, args), 2.5, tile=1024, want_same=want_same)
    got = tcorr.ring_constrained_nn2_pts(*map(torch.tensor, args), 2.5, tile=1024, want_same=want_same)
    ds, ps, do, po = map(_np, want)
    gds, gps, gdo, gpo = map(_np, got)
    _check_winners(q, qmask, po, gpo, do, gdo)
    if want_same:
        _check_winners(q, qmask, ps, gps, ds, gds)
    else:
        np.testing.assert_array_equal(gps, ps)
        np.testing.assert_array_equal(gds, ds)


def test_gridmap_insert_sequence_with_aliasing():
    """The insert sequence of tests/test_gridmap.py, including the batches
    that wrap the torus: counts, stored cell coords and totals exact."""
    rng = np.random.default_rng(0)
    jg = jgrid.init_grid(16 * 16 * 8, 4)
    tg = tgrid.init_grid(16 * 16 * 8, 4, "cpu")
    for it in range(8):
        pts = rng.uniform(-14, 14, (256, 3)).astype(np.float32)
        if it >= 4:
            pts += np.array([40.0, 0, 0], np.float32)  # wrap the torus
        m = rng.random(256) < 0.9
        jg = jgrid.insert(jg, jnp.asarray(pts), jnp.asarray(m), 16, 16, 8, 2.0, 0.4)
        tg = tgrid.insert(tg, torch.tensor(pts), torch.tensor(m), 16, 16, 8, 2.0, 0.4)
        np.testing.assert_array_equal(_np(tg.count), _np(jg.count))
        np.testing.assert_array_equal(_np(tg.cell_coord), _np(jg.cell_coord))
        assert int(tg.total) == int(jg.total)
        np.testing.assert_allclose(_np(tg.pts), _np(jg.pts), atol=1e-6, rtol=0)


@pytest.mark.parametrize("reach", [1.0, 2.0])
def test_knn_grid(reach):
    """8-cell (reach 1 m, the mapping layout) and 27-cell (reach 2 m) paths:
    the same k distances."""
    rng = np.random.default_rng(int(reach))
    pts = rng.uniform(2.0, 12.0, size=(600, 3)).astype(np.float32)
    q = rng.uniform(3.0, 11.0, size=(80, 3)).astype(np.float32)
    qmask = rng.uniform(size=80) < 0.9
    jg = jgrid.insert(jgrid.init_grid(16 * 16 * 8, 16), jnp.asarray(pts), jnp.ones(600, bool), 16, 16, 8, 2.0, 0.05)
    tg = tgrid.insert(tgrid.init_grid(16 * 16 * 8, 16, "cpu"), torch.tensor(pts), torch.ones(600, dtype=torch.bool), 16, 16, 8, 2.0, 0.05)
    wd, wp = jgrid.knn_grid(jg, jnp.asarray(q), jnp.asarray(qmask), 16, 16, 8, 2.0, reach, 8)
    gd, gp = tgrid.knn_grid(tg, torch.tensor(q), torch.tensor(qmask), 16, 16, 8, 2.0, reach, 8)
    np.testing.assert_allclose(_np(gd), _np(wd), atol=1e-4, rtol=0)
    near = _np(wd) < reach * reach
    np.testing.assert_allclose(_np(gp)[near], _np(wp)[near], atol=1e-6, rtol=0)


def test_argmin_topk_ties_go_to_lowest_index():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 4, (50, 40)).astype(np.float32)
    payload = rng.normal(size=(50, 40, 3)).astype(np.float32)
    wv, wr = jvox.argmin_topk(jnp.asarray(d), 6, jnp.asarray(payload))
    gv, gr = tvox.argmin_topk(torch.tensor(d), 6, torch.tensor(payload))
    np.testing.assert_array_equal(_np(gv), _np(wv))
    np.testing.assert_array_equal(_np(gr), _np(wr))


def _key_boundaries(voxel, lo, hi):
    """float32 values in [lo, hi] where floor(x / voxel) and the
    reference's floor(x * (1 / voxel)) (XLA folds a division by a constant
    into a multiplication) put x in different voxels."""
    f = np.float32
    k = np.arange(int(lo / voxel), int(hi / voxel) + 1)
    base = (k * f(voxel)).astype(f)
    c = np.concatenate([np.nextafter(base, f(np.inf)), base, np.nextafter(base, f(-np.inf))])
    return c[np.floor(c / f(voxel)) != np.floor(c * (f(1) / f(voxel)))].astype(f)


def test_voxel_filters_key_points_like_the_reference():
    """Points on voxel boundaries, where a division by the leaf size and
    the reference's multiplication by its reciprocal disagree, each between
    two neighbours a quarter leaf away: the row filter (0.2 m) and the
    packed filter (0.4 m) group them with the reference's neighbour."""
    rng = np.random.default_rng(2)
    S, W = 4, 96
    b = rng.choice(_key_boundaries(0.2, 5.0, 40.0), (S, W // 3))
    x = np.stack([b - 0.05, b, b + 0.05], -1).reshape(S, W)  # azimuth-ordered triplets
    img = np.stack([x, np.full((S, W), 3.1), np.broadcast_to(np.arange(S)[:, None] * 0.3, (S, W))],
                   -1).astype(np.float32)
    mask = np.ones((S, W), bool)
    want = _jit_rows(jnp.asarray(img), jnp.asarray(mask), 0.2, 512)
    got = tvox.voxel_downsample_rows(torch.tensor(img), torch.tensor(mask), 0.2, 512)
    for w, g in zip(map(_np, want[:3]), map(_np, got[:3])):
        np.testing.assert_array_equal(g, w)
    b = rng.choice(_key_boundaries(0.4, -40.0, 40.0), 200)
    y, z = rng.uniform(-20, 20, 200), rng.uniform(-2, 2, 200)
    xyz = np.concatenate([np.stack([b + d, y, z], -1) for d in (-0.1, 0.0, 0.1)]).astype(np.float32)
    kw = dict(xy_bits=10, z_bits=9, shell_bits=2)
    want = _jit_packed(jnp.asarray(xyz), jnp.ones(600, bool), 0.4, 1024, **kw)
    got = tvox.voxel_downsample_packed(torch.tensor(xyz), torch.ones(600, dtype=torch.bool), 0.4,
                                       1024, **kw)
    for w, g in zip(map(_np, want[:2]), map(_np, got[:2])):
        np.testing.assert_array_equal(g, w)


def test_keyframe_shells_like_the_reference():
    """Voxel centres on a square grid around the centroid: the ring at
    Chebyshev distance 32 (= base / 2 for xy_bits 10) lies in the compiled
    reference's shell 1, which orders the output and decides what a full
    capacity keeps."""
    c = np.arange(-40, 41)
    cx, cy = np.meshgrid(c, c, indexing="ij")
    xyz = np.stack([(cx.ravel() + 0.5) * 0.4, (cy.ravel() + 0.5) * 0.4, np.full(cx.size, 0.2)],
                   -1).astype(np.float32)
    mask = np.ones(len(xyz), bool)
    inner = int(np.sum(np.maximum(np.abs(cx), np.abs(cy)) <= 31))
    kw = dict(xy_bits=10, z_bits=9, shell_bits=2)
    for capacity in (len(xyz), inner + 40):
        want = _jit_packed(jnp.asarray(xyz), jnp.asarray(mask), 0.4, capacity, **kw)
        got = tvox.voxel_downsample_packed(torch.tensor(xyz), torch.tensor(mask), 0.4, capacity,
                                           **kw)
        for w, g in zip(map(_np, want[:2]), map(_np, got[:2])):
            np.testing.assert_array_equal(g, w)


def _mirror_ties(rng, n_q, n_far):
    """Queries, each with two targets mirrored about it (equidistant in
    exact arithmetic: float32 rounding decides the order) among far ones."""
    q = rng.uniform(20, 80, (n_q, 3)).astype(np.float32)
    e = rng.normal(0, 0.3, (n_q, 3)).astype(np.float32)
    tgt = np.concatenate([q + e, q - e, rng.uniform(-100, 100, (n_far, 3))]).astype(np.float32)
    return q, tgt


@pytest.mark.parametrize("seed", [0, 1])
def test_two_nn_ranks_near_ties_like_the_reference(seed):
    """Mirrored near-ties: knn2_payload and the ring-constrained search
    return the reference's winners and squared distances exactly (its
    |q|^2 + |t|^2 - 2 q.t is rounded as fused multiply-add chains; a BLAS
    matmul and plain sums order them otherwise)."""
    rng = np.random.default_rng(seed)
    q, tgt = _mirror_ties(rng, 512, 1024)
    T = len(tgt)
    tmask = np.ones(T, bool)
    qmask = np.ones(len(q), bool)
    payload = np.concatenate([tgt, np.arange(T)[:, None]], 1).astype(np.float32)
    want = jvox.knn2_payload(*map(jnp.asarray, (q, qmask, tgt, tmask, payload)), tile=1024)
    got = tvox.knn2_payload(*map(torch.tensor, (q, qmask, tgt, tmask, payload)), tile=1024)
    for w, g in zip(map(_np, want), map(_np, got)):
        np.testing.assert_array_equal(g, w)
    tring = (np.arange(T) % 3).astype(np.float32)
    args = (q, qmask, np.ones(len(q), np.float32), np.full(len(q), T - 1, np.int32), tgt, tmask,
            tring)
    want = jcorr.ring_constrained_nn2_pts(*map(jnp.asarray, args), 2.5, tile=512)
    got = tcorr.ring_constrained_nn2_pts(*map(torch.tensor, args), 2.5, tile=512)
    for w, g in zip(map(_np, want), map(_np, got)):
        np.testing.assert_array_equal(g, w)


def test_grid_map_ranks_and_dedups_near_ties_like_the_reference():
    """Map points mirrored about each query (equidistant in exact
    arithmetic) and new points about one dedup radius from stored ones:
    knn_grid's winners and distances and insert's dedup decisions are the
    compiled reference's (its squared distances are fused multiply-add
    chains)."""
    rng = np.random.default_rng(4)
    q = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    e = rng.normal(0, 0.25, (300, 3)).astype(np.float32)
    pts = np.concatenate([q + e, q - e]).astype(np.float32)
    args = (16, 16, 8, 4.0)
    insert = jax.jit(jgrid.insert, static_argnums=(3, 4, 5, 6, 7))
    knn = jax.jit(jgrid.knn_grid, static_argnums=(3, 4, 5, 6, 7, 8))
    jg = insert(jgrid.init_grid(16 * 16 * 8, 64), jnp.asarray(pts), jnp.ones(600, bool), *args, 0.01)
    tg = tgrid.insert(tgrid.init_grid(16 * 16 * 8, 64, "cpu"), torch.tensor(pts),
                      torch.ones(600, dtype=torch.bool), *args, 0.01)
    qm = np.ones(300, bool)
    want = knn(jg, jnp.asarray(q), jnp.asarray(qm), *args, 1.0, 4)
    got = tgrid.knn_grid(tg, torch.tensor(q), torch.tensor(qm), *args, 1.0, 4)
    for w, g in zip(map(_np, want), map(_np, got)):
        np.testing.assert_array_equal(g, w)
    d = rng.normal(size=(600, 3))
    near = (pts + 0.4 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jg2 = insert(jg, jnp.asarray(near), jnp.ones(600, bool), *args, 0.4)
    tg2 = tgrid.insert(tg, torch.tensor(near), torch.ones(600, dtype=torch.bool), *args, 0.4)
    np.testing.assert_array_equal(_np(tg2.count), _np(jg2.count))
    np.testing.assert_array_equal(_np(tg2.pts), _np(jg2.pts))
