"""Multi-process initialisation (counterpart of
scaloam_tpu/parallel/distributed.py).

One process per device. Each process calls, before anything else of the
parallel layer:

    from scaloam_tpu_torch.parallel import distributed
    distributed.initialize()            # a launcher's environment (torchrun, SLURM, Open MPI)
    mesh = distributed.global_mesh()

or names the rendezvous itself: `initialize("tcp://host:port", world_size,
rank)` or a `file://` store shared by the ranks. The backend is NCCL when a
GPU is present and gloo otherwise; a caller may name gloo for CUDA tensors,
which is how several ranks share one card (NCCL refuses two ranks of one
communicator on the same GPU). The sharded functions (parallel/pgo.py,
sc_retrieval.py, gridmap.py) take any mesh: their all_reduce / all_gather
run over its process groups.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from scaloam_tpu_torch.parallel import mesh as mesh_mod

# Environment variables by which a launcher announces a multi-process run:
# torchrun / torch.distributed.elastic, SLURM, Open MPI.
_CLUSTER_MARKERS = ("TORCHELASTIC_RUN_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE",
                    "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
# (rank, world size) variable pairs of those launchers, in order of preference.
_RANK_WORLD_VARS = (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"),
                    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"))

_initialized = False


def _cluster_env_present() -> bool:
    return any(k in os.environ for k in _CLUSTER_MARKERS)


def _launcher_rank_world():
    for r, w in _RANK_WORLD_VARS:
        if r in os.environ and w in os.environ:
            return int(os.environ[r]), int(os.environ[w])
    return None, None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """torch.distributed.init_process_group with the reference's contract.

    No-ops: a second call from this module while its process group
    stands (after destroy_process_group a call initialises anew), and an
    explicit single-process
    run (world_size 1 or None, rank 0 or None, no init_method) where no
    launcher's environment is present. Anything else initialises or
    RAISES: an unreachable or malformed rendezvous, a missing rank, a
    process group initialised elsewhere. A requested multi-process run is
    never degraded to one process, since every collective would then see a
    world of the wrong size. `timeout` is in seconds. With NCCL the rank's
    card (LOCAL_RANK, else rank modulo the card count) becomes the current
    device before the group is made."""
    global _initialized
    if _initialized and dist.is_initialized():
        return
    if (world_size in (None, 1) and init_method is None and rank in (None, 0)
            and not _cluster_env_present()):
        return
    if rank is None or world_size is None:
        env_rank, env_world = _launcher_rank_world()
        rank = env_rank if rank is None else rank
        world_size = env_world if world_size is None else world_size
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", (rank or 0) % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    _initialized = True


def global_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """One-axis ("kf",) mesh over every rank of the world."""
    return mesh_mod.make_mesh(None, device_type)
