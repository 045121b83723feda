"""The kernels' cost functions against hand counts at one kitti_hdl64
frame's shapes (64 rings x 2304 columns, 131,072 points, the feature and
map capacities of the preset), and the bytes bounding the kernels whose
operations depend on the data."""

import pytest
import torch

from benchlib import peaks, registry

C = registry.costs()
T = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")


def test_selection_at_one_frame():
    args = (T(64, 2304), T(64, 2304), T(64, 2304), T(64, 2304), T(64, 6), T(64, 6), 6, 20, 4, 0.1)
    n_bytes, n_ops = C["select_features"].cost(args)
    assert n_bytes == 64 * 2304 * 14 + 2 * 384 * 4 + 384 * 24 * 5 == 2_113_536
    assert n_ops == 3 * 24 * 64 * 2304
    assert n_bytes / peaks.HBM_BYTES_PER_S > n_ops / peaks.F32_OPS_PER_S


def test_entry_a_at_one_frame():
    Nc, Ns = 768, 1536
    args = (T(1, Nc, 3), T(1, Nc, 2, 3), T(1, Nc, 2, 3), T(1, Nc), T(1, Ns, 3), T(1, Ns, 2, 3),
            T(1, Ns, 2, 3), T(1, Ns, 2, 3), T(1, Ns), T(1, 4), T(1, 3), 2, 4, 25.0, 0.1, 1e-6)
    n_bytes, n_ops = C["associate_and_solve"].cost(args)
    assert n_bytes == 768 * 61 + 1536 * 85 + 56 + 8 == 177_472
    assert n_ops == 2 * (768 * 55 + 1536 * 105)
    # a frame's valid factors (a full-width kitti_hdl64 frame: 363 corner, 1157 surf)
    full = n_ops + 2 * 4 * (363 * 300 + 1157 * 140)
    assert n_bytes / peaks.HBM_BYTES_PER_S > full / peaks.F32_OPS_PER_S
    batched = C["associate_and_solve"].cost((T(8, Nc, 3),) + args[1:4] + (T(8, Ns, 3),) + args[5:])
    assert batched == (8 * n_bytes, 8 * n_ops)


def test_entry_b_at_one_frame():
    Nc, Ns = 2048, 6656
    args = (T(1, 4), T(1, 3), T(1, Nc, 3), T(1, Nc, 3), T(1, Nc, 3), T(1, Nc), T(1, Ns, 3),
            T(1, Ns, 3), T(1, Ns), T(1, Ns), 4, 0.1, 1e-6)
    assert C["gn_solve_prepared"].cost(args) == (2048 * 37 + 6656 * 29 + 56, 0)


def test_ring_azimuth_and_f32ops():
    assert C["ring_azimuth"].cost((T(131072, 3), "HDL64", 64)) == (131072 * 21, 131072 * 83)
    assert C["sq_dist"].cost((T(1, 1536, 3), T(1, 8192, 3))) == (
        (1536 + 8192) * 12 + 1536 * 8192 * 4, 1536 * 8192 * 8 + (1536 + 8192) * 5)
    assert C["sum3_sq"].cost((T(6656, 8, 16, 3),)) == (851968 * 16, 851968 * 5)


@pytest.mark.parametrize("name", sorted(C))
def test_every_cost_is_whole_and_positive(name):
    assert C[name].KERNELS and all(k.endswith("_kernel") for k in C[name].KERNELS)
