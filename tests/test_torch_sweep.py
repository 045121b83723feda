"""Odometry's 2-NN sweep op (ops/kernels/sweep_top2.py) on the CPU, where
it runs its plain version: equal, bit for bit, to the former composition
that models/odometry.py `_sweep_candidates` ran before the op
(voxel.knn2_payload over a payload of the target's points, ring and index,
then correspond.ring_constrained_nn2_pts from the 1-NN's payload row), in
the points and in the any class's indices, on the cases of
tests/sweep_cases.py: a small cloud whose size is no multiple of the
tiles, duplicate points and equal distances within and across tiles,
ring differences of exactly 0.5 and `nearby`, a tile all masked and a
tile with one target passing, every target masked. The kernel is held to
the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from scaloam_tpu_torch.ops import correspond, voxel
from scaloam_tpu_torch.ops.kernels import sweep_top2
from sweep_cases import SMALL, sweep_case
from torch_threads import two_threads  # noqa: F401  (autouse)


def _tensors(c):
    return (torch.tensor(c["query"]), torch.tensor(c["target"]), torch.tensor(c["mask"]),
            torch.tensor(c["ring"]))


def _former_sweep(q, q_mask, t, t_mask, ring, nearby, want_same, tile_any, tile_ring):
    """`_sweep_candidates`'s sweep as it was: the candidate points and the
    any class's payload indices (0 where none)."""
    iota = torch.arange(t.shape[0], dtype=torch.float32)
    payload = torch.cat([t, ring[:, None], iota[:, None]], dim=1)
    _, P = voxel.knn2_payload(q, q_mask, t, t_mask, payload, tile=tile_any)
    any_pts = P[:, :, :3].contiguous()
    _, p_same, _, p_other = correspond.ring_constrained_nn2_pts(
        q, q_mask, P[:, 0, 3], P[:, 0, 4].to(torch.int64), t, t_mask, ring, nearby,
        tile=tile_ring, want_same=want_same)
    pts = (any_pts, p_same, p_other) if want_same else (any_pts, p_other)
    return pts, P[:, :, 4]


@pytest.mark.parametrize("want_same", [True, False])
@pytest.mark.parametrize("name", SMALL)
def test_sweep_plain_is_the_former_composition(name, want_same):
    c = sweep_case(name)
    q, t, m, r = _tensors(c)
    q_mask = torch.tensor(np.random.default_rng(1).uniform(size=q.shape[0]) < 0.9)
    before = sweep_top2.sweep_top2.launches
    idx, pts = sweep_top2.sweep_top2(q, t, m, r, c["nearby"], want_same, c["tile_any"],
                                     c["tile_ring"])
    assert sweep_top2.sweep_top2.launches == before  # the CPU runs the plain version
    want_pts, want_any = _former_sweep(q, q_mask, t, m, r, c["nearby"], want_same,
                                       c["tile_any"], c["tile_ring"])
    assert idx.shape == (2 + want_same, q.shape[0], 2) and idx.dtype == torch.int64
    assert len(pts) == len(want_pts)
    for got, want in zip(pts, want_pts):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.clamp(idx[0], min=0).to(torch.float32), want_any)
    if name == "empty":
        assert bool((idx == -1).all()) and not bool(pts.any())


def test_sweep_vmap_folds_the_batch_on_the_cpu():
    """Under torch.func.vmap the op takes the batch as its problems: equal
    to a call a problem."""
    cases = [sweep_case("ties", seed=s) for s in range(3)]
    args = [torch.stack(a) for a in zip(*map(_tensors, cases))]
    c = cases[0]
    got = torch.func.vmap(lambda *a: sweep_top2.sweep_top2(
        *a, c["nearby"], True, c["tile_any"], c["tile_ring"]))(*args)
    for b in range(3):
        one = sweep_top2.sweep_top2(*(a[b] for a in args), c["nearby"], True, c["tile_any"],
                                    c["tile_ring"])
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1])
