"""The port's numpy-only host utilities against the reference's copies, on
the CPU: io/native_loader.py (the C++ scan reader and filters, built into
build/native/, and its numpy fallback), utils/mapmerge.py, utils/metrics.py
and utils/viz.py. Outputs are equal (the same code on the same inputs)."""

import json
import os

import numpy as np
import pytest

from scaloam_tpu.io import native_loader as jnl
from scaloam_tpu.utils import mapmerge as jmerge
from scaloam_tpu_torch.io import artifacts, native_loader as tnl, pcd as pcd_io
from scaloam_tpu_torch.utils import mapmerge as tmerge, metrics, viz
from torch_threads import two_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(tmp_path, rng):
    pts = rng.normal(size=(3000, 4)).astype(np.float32)
    bin_path, pcd_path = str(tmp_path / "scan.bin"), str(tmp_path / "scan.pcd")
    pts.tofile(bin_path)
    pcd_io.write_pcd(pcd_path, pts[:500], binary=True)
    return pts, bin_path, pcd_path


@pytest.mark.parametrize("fn", ["read_bin", "read_pcd", "voxel_filter", "range_filter"])
def test_native_loader_matches_reference(fn, tmp_path, rng):
    pts, bin_path, pcd_path = _files(tmp_path, rng)
    args = {"read_bin": (bin_path,), "read_pcd": (pcd_path,),
            "voxel_filter": (pts[:, :3] * 5, 1.0), "range_filter": (pts[:, :3] * 10, 5.0)}[fn]
    got, want = getattr(tnl, fn)(*args), getattr(jnl, fn)(*args)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_native_loader_builds_beside_the_package_and_falls_back(tmp_path, rng, monkeypatch):
    """With g++ the library lands in build/native/ (never in native/);
    without it every entry point takes the numpy fallback."""
    if tnl.native_available():
        path = tnl._lib_path()
        assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
        assert os.path.exists(path)
    pts, bin_path, pcd_path = _files(tmp_path, rng)
    native = (tnl.read_bin(bin_path), tnl.read_pcd(pcd_path), tnl.range_filter(pts[:, :3] * 10, 5.0),
              tnl.voxel_filter(pts[:, :3] * 5, 1.0))
    monkeypatch.setattr(tnl, "_load_lib", lambda: None)
    plain = (tnl.read_bin(bin_path), tnl.read_pcd(pcd_path), tnl.range_filter(pts[:, :3] * 10, 5.0),
             tnl.voxel_filter(pts[:, :3] * 5, 1.0))
    for a, b in zip(native[:3], plain[:3]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    # the voxel centroids agree as sets (the two list them in another order)
    sort = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_allclose(sort(native[3]), sort(plain[3]), atol=1e-4, rtol=0)
    assert [p for p, _ in tnl.PrefetchLoader([bin_path] * 3, depth=2)] == [bin_path] * 3


def test_mapmerge_matches_reference(tmp_path, rng):
    d = str(tmp_path / "session")
    w = artifacts.SessionWriter(d)
    poses = np.tile(np.eye(4), (4, 1, 1))
    for k in range(4):
        poses[k, :3, 3] = [k * 2.0, 0.5 * k, 0]
        cloud = np.concatenate([rng.normal(size=(200, 3)) * 5, rng.uniform(0, 60, (200, 1))], 1)
        w.save_keyframe(k, cloud.astype(np.float32), np.abs(rng.normal(size=(20, 60))), time=0.1 * k)
    w.save_poses(poses, poses, loop_edges=[])
    kw = dict(node_skip=1, min_range=1.0, max_range=12.0, voxel_size=0.5)
    got = tmerge.merge_map(d, output_path=str(tmp_path / "map.pcd"), **kw)
    np.testing.assert_array_equal(got, jmerge.merge_map(d, **kw))
    assert got.shape[1] == 4 and len(got) > 100
    np.testing.assert_allclose(pcd_io.read_pcd(str(tmp_path / "map.pcd")), got, atol=1e-6)


def test_metrics_and_viz(tmp_path):
    m = metrics.Metrics()
    m.inc("keyframes")
    m.inc("keyframes", 2)
    m.set("dropped", 4)
    assert m.get("keyframes") == 3.0 and json.loads(m.json_line()) == {"dropped": 4.0,
                                                                      "keyframes": 3.0}
    traj = np.tile(np.eye(4), (5, 1, 1))
    traj[:, 0, 3] = np.arange(5)
    out = str(tmp_path / "map.html")
    viz.export_map_html(out, np.random.default_rng(0).normal(size=(50, 3)), poses=traj)
    html = open(out).read()
    assert html.startswith("<!DOCTYPE html>") and "__DATA__" not in html
    png = str(tmp_path / "traj.png")
    if viz.plot_trajectories(png, {"est": traj}, loops=[(4, 0)]):
        assert os.path.getsize(png) > 0
