"""Mesh helpers over torch.distributed (counterpart of
scaloam_tpu/parallel/mesh.py).

JAX's shard_map drives every device from one controller; here each rank
is one process on one device, and a DeviceMesh names the axes of the
world's ranks. An array the reference places as `P(KF_AXIS)` is held as
shards: rank r of the `kf` axis owns the contiguous rows [r * shard,
(r + 1) * shard) of the array padded to a multiple of the axis size
(`shard_rows`). A `P()` array is a full copy on every rank. `psum` becomes
an all_reduce over the axis's process group, `all_gather` an all_gather
over it, and `axis_index` the rank's coordinate on the axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

KF_AXIS = "kf"  # keyframe / factor / map-cell sharding axis
SEQ_AXIS = "seq"  # sequence axis of the multi-sequence front end


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "scaloam_tpu_torch.parallel.distributed.initialize first")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n: Optional[int] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh ("kf",) over all n ranks of the world. Every rank of the
    world is on the mesh, so n, when given, must equal the world size.
    device_type defaults to `cuda` when a GPU is present, else `cpu`."""
    world = _world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"make_mesh: {n} ranks requested in a world of {world}")
    return init_device_mesh(_device_type(device_type), (n,), mesh_dim_names=(KF_AXIS,))


def make_mesh2d(n_seq: int, n_kf: Optional[int] = None,
                device_type: Optional[str] = None) -> DeviceMesh:
    """2-D mesh (seq, kf): the multi-sequence front end shards over
    SEQ_AXIS while the backend's growth axes (keyframes, descriptors,
    factors) shard over KF_AXIS of the same mesh."""
    world = _world_size()
    if n_kf is None:
        n_kf = world // n_seq
    if n_kf < 1:
        raise ValueError(
            f"make_mesh2d: {n_seq} sequences over {world} ranks leaves no room for "
            f"the kf axis (need n_seq <= world size)")
    if n_seq * n_kf > world:
        raise ValueError(f"make_mesh2d: requested {n_seq}x{n_kf} mesh exceeds the "
                         f"{world} ranks of the world")
    if n_seq * n_kf < world:
        raise ValueError(f"make_mesh2d: a {n_seq}x{n_kf} mesh leaves ranks of the "
                         f"{world}-rank world off the mesh")
    return init_device_mesh(_device_type(device_type), (n_seq, n_kf),
                            mesh_dim_names=(SEQ_AXIS, KF_AXIS))


def pad_to_shards(n: int, n_shards: int) -> int:
    return -(-n // n_shards) * n_shards


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on the axis (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def shard_rows(mesh: DeviceMesh, x: torch.Tensor, axis: str = KF_AXIS, fill=0) -> torch.Tensor:
    """This rank's rows of a replicated x: x padded with `fill` to a
    multiple of the axis size, then the rank's contiguous slice (a view
    where no padding falls into it)."""
    n = axis_size(mesh, axis)
    rows = pad_to_shards(x.shape[0], n) // n
    lo = axis_index(mesh, axis) * rows
    part = x[lo:lo + rows]
    if part.shape[0] < rows:
        part = torch.cat([part, part.new_full((rows - part.shape[0],) + x.shape[1:], fill)])
    return part


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """[n, ...]: every rank's x on the axis, stacked in axis order."""
    out = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, x.contiguous(), group=axis_group(mesh, axis))
    return torch.stack(out)
