"""The port's generic voxel filter, map-cloud extraction and public names
against the JAX reference, on the CPU.

- `voxel_downsample` on the same seeded numpy inputs: plain, with a
  `group_key`, with a `priority_center` and a capacity below the
  occupied-voxel count (the same voxels must survive), and with an `extra`
  payload. Masks equal, centroids and payload means within 1e-5 (both
  average the same points in the same order).
- `gridmap.extract_points` and `mapping.map_points` on a mapping state
  carried across with `convert.mapping_state_from_numpy`, at capacities
  above and below the map's size: rows and their order equal.
- Every public top-level function of `scaloam_tpu` has a twin of the
  same name in `scaloam_tpu_torch`, apart from the TPU workarounds listed
  in `DROPPED`; `LidarScan` and `FeatureCloud` carry `capacity`.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from scaloam_tpu import config as jconfig
from scaloam_tpu.models import mapping as jmap
from scaloam_tpu.ops import gridmap as jgrid, voxel as jvox
from scaloam_tpu.types import FeatureCloud as JCloud, LidarScan as JScan
from scaloam_tpu_torch import config as tconfig, convert
from scaloam_tpu_torch.models import mapping as tmap
from scaloam_tpu_torch.ops import gridmap as tgrid, voxel as tvox
from scaloam_tpu_torch.types import FeatureCloud as TCloud, LidarScan as TScan

REPO = pathlib.Path(__file__).resolve().parents[1]

# Reference functions the port leaves out on purpose, each with its reason
# (the port rules in ROADMAP.md: the semantics are carried, not the TPU
# workarounds).
DROPPED = {
    "cumsum_blocked": "blocked prefix sum shaped for the TPU's scan lowering; torch.cumsum",
    "cummax_blocked": "blocked running max shaped for the TPU; torch.cummax",
    "exact_onehot_select": "one-hot matmul payload select for the MXU; index gathers",
    "split3_f32": "three-way bf16 split for exact MXU matmuls; the port's matmuls are f32",
    "pack_corner": "sublane-shaped input pack of the Pallas GN kernel; K2 takes the tensors",
    "pack_surf": "sublane-shaped input pack of the Pallas GN kernel; K2 takes the tensors",
    "add_keyframe_jit": "jax.jit wrapper; the port calls posegraph.add_keyframe",
    "add_loop_jit": "jax.jit wrapper; the port calls posegraph.add_loop",
    "append_descriptor_jit": "jax.jit wrapper; the port calls scancontext.append_descriptor",
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _voxel_case(case):
    """(inputs as numpy, keyword arguments) of one voxel_downsample case."""
    rng = np.random.default_rng(len(case))
    n = 3000
    mask = rng.uniform(size=n) < 0.9
    kw = {}
    if case == "plain":
        xyz, vs, cap = rng.uniform(-5, 5, (n, 3)), 1.0, 2048
    elif case == "group_key":
        xyz, vs, cap = rng.uniform(-3, 3, (n, 3)), 1.0, 1024
        kw["group_key"] = rng.integers(0, 4, n).astype(np.int32)
    elif case == "priority_center":
        xyz, vs, cap = rng.uniform(-20, 20, (n, 3)), 2.0, 600
        kw["priority_center"] = np.array([3.3, -4.1, 0.7], np.float32)
    else:
        xyz, vs, cap = rng.uniform(-8, 8, (n, 3)), 1.0, 512
        kw["extra"] = rng.normal(size=(n, 2)).astype(np.float32)
    return xyz.astype(np.float32), mask, vs, cap, kw


@pytest.mark.parametrize("case", ["plain", "group_key", "priority_center", "extra"])
def test_voxel_downsample_matches_reference(case):
    xyz, mask, vs, cap, kw = _voxel_case(case)
    want = jvox.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), vs, cap,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tvox.voxel_downsample(torch.tensor(xyz), torch.tensor(mask), vs, cap,
                                **{k: torch.tensor(v) for k, v in kw.items()})
    m = _np(want[1])
    np.testing.assert_array_equal(_np(got[1]), m)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=1e-5, rtol=0)
    if case == "extra":
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-5, rtol=0)
    else:
        assert got[2] is None and want[2] is None
    occupied = len({tuple(c) for c in np.floor(xyz[mask] / vs).astype(int)})
    if case == "priority_center":
        assert occupied > cap and m.sum() == cap  # the filter overflowed
    elif case == "group_key":
        assert m.sum() > occupied  # voxels split by group
    elif case == "plain":
        assert m.sum() == occupied


def _map_cfg():
    cfg = jconfig.kitti_hdl64()
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, cell_size=4.0, grid_xy=8, grid_z=4, corner_cell_cap=8,
        surf_cell_cap=16, max_corner_map=700, max_surf_map=4096))


@pytest.fixture(scope="module")
def map_state():
    """A JAX mapping state whose grids hold three batches of seeded points
    (stale cells, aliasing and full cells included), on the host."""
    cfg = _map_cfg()
    m = cfg.mapping
    rng = np.random.default_rng(7)
    state = jmap.init_state(cfg)
    grids = []
    for grid, res in ((state.corner_grid, m.line_resolution), (state.surf_grid, m.plane_resolution)):
        for _ in range(3):
            xyz = rng.uniform(-20, 20, (1500, 3)).astype(np.float32)
            grid = jgrid.insert(grid, jnp.asarray(xyz), jnp.asarray(rng.uniform(size=1500) < 0.9),
                                m.grid_xy, m.grid_xy, m.grid_z, m.cell_size, res)
        grids.append(grid)
    state = state._replace(corner_grid=grids[0], surf_grid=grids[1])
    return cfg, jax.tree.map(np.array, state)


@pytest.mark.parametrize("capacity", [300, 20000])
def test_extract_points_matches_reference(map_state, capacity):
    _, host = map_state
    total = int(host.surf_grid.total)
    assert 300 < total < 20000
    want = jgrid.extract_points(jax.tree.map(jnp.asarray, host.surf_grid), capacity)
    got = tgrid.extract_points(convert.mapping_state_from_numpy(host, "cpu").surf_grid, capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert int(_np(got[1]).sum()) == min(total, capacity)


def test_map_points_matches_reference(map_state):
    """max_corner_map truncates the corner map; max_surf_map holds the surf map."""
    cfg, host = map_state
    assert int(host.corner_grid.total) > cfg.mapping.max_corner_map
    assert int(host.surf_grid.total) < cfg.mapping.max_surf_map
    want = jmap.map_points(jax.tree.map(jnp.asarray, host), cfg)
    got = tmap.map_points(convert.mapping_state_from_numpy(host, "cpu"),
                          tconfig.from_dict(dataclasses.asdict(cfg)))
    for w, g in zip(want, got):
        for wa, ga in zip(w, g):
            np.testing.assert_array_equal(_np(ga), _np(wa))
    assert got[0][0].shape == (cfg.mapping.max_corner_map, 3)
    assert got[1][0].shape == (cfg.mapping.max_surf_map, 3)


def _public_functions(package):
    names = set()
    for path in (REPO / package).rglob("*.py"):
        for node in ast.parse(path.read_text(), filename=str(path)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
                names.add(node.name)
    return names


def test_every_reference_function_has_a_port_twin():
    missing = _public_functions("scaloam_tpu") - _public_functions("scaloam_tpu_torch")
    assert missing == set(DROPPED), sorted(missing ^ set(DROPPED))


def test_scan_and_cloud_capacity():
    pts = np.ones((5, 3), np.float32)
    assert TScan.from_numpy(pts, 12, "cpu").capacity == JScan.from_numpy(pts, 12).capacity == 12
    assert TCloud.empty(7, "cpu").capacity == JCloud.empty(7).capacity == 7
