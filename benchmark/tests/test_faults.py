"""The comparison catches each fault a cell's timed path can have: a run
through the harness's `run` (its look for a card skipped: the CPU's plain
path at a small size, with each cell's own limits and samples) with the
path broken underneath, and `correct` comes out false. The cells run on
one card, so no exchange between cards can be left out."""

import pytest
import torch

import harness
from small import small_cell

from scaloam_tpu_torch.models import frontend
from scaloam_tpu_torch.parallel import multiseq
from scaloam_tpu_torch.types import Pose


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nudged(p: Pose) -> Pose:
    return Pose(p.quat, p.trans + 1e-3)


def _run(name, frames, steps):
    cell, config = small_cell(name, frames)
    return harness.run(cell, config, 2**31 + 11, 0.0, 0, torch.device("cpu"), [], steps=steps)


def _state_unchanged_frontend(monkeypatch):
    step = frontend.frontend_step
    monkeypatch.setattr(frontend, "frontend_step", lambda s, scan, cfg: (s, step(s, scan, cfg)[1]))


def _answer_altered_frontend(monkeypatch):
    step = frontend.frontend_step

    def altered(s, scan, cfg):
        s, out = step(s, scan, cfg)
        return s, out._replace(mapped_pose=_nudged(out.mapped_pose))

    monkeypatch.setattr(frontend, "frontend_step", altered)


def _state_unchanged_fleet(monkeypatch):
    step = multiseq.frame_batch

    def same(o, m, xyz, mask, cfg, mesh=None):
        return (o, m) + tuple(step(o, m, xyz, mask, cfg)[2:])

    monkeypatch.setattr(multiseq, "frame_batch", same)


def _half_batch_fleet(monkeypatch):
    """The first half of the sequences stepped; the rest keep their states
    and take the mean of the stepped half's poses."""
    step = multiseq.frame_batch

    def half(o, m, xyz, mask, cfg, mesh=None):
        n = xyz.shape[0] // 2
        rows = lambda t, sl: type(t)(*(rows(x, sl) for x in t)) if isinstance(t, tuple) else (
            t[sl] if isinstance(t, torch.Tensor) else t)
        cat = lambda a, b: type(a)(*(cat(x, y) for x, y in zip(a, b))) if isinstance(a, tuple) else (
            torch.cat([a, b]) if isinstance(a, torch.Tensor) else a)
        o1, m1, odom, mapped = step(rows(o, slice(0, n)), rows(m, slice(0, n)), xyz[:n], mask[:n],
                                    cfg)
        mean = lambda p: Pose(p.quat.mean(0, keepdim=True).expand(xyz.shape[0] - n, 4),
                              p.trans.mean(0, keepdim=True).expand(xyz.shape[0] - n, 3))
        return (cat(o1, rows(o, slice(n, None))), cat(m1, rows(m, slice(n, None))),
                cat(odom, mean(odom)), cat(mapped, mean(mapped)))

    monkeypatch.setattr(multiseq, "frame_batch", half)


def _one_sequence_unmapped_fleet(monkeypatch):
    """Mapping left out for one sequence of the batch: its mapping state
    stays as it was; every other output as computed."""
    step = multiseq.frame_batch

    def skipped(o, m, xyz, mask, cfg, mesh=None):
        o1, m1, odom, mapped = step(o, m, xyz, mask, cfg)
        keep = lambda new, old: type(new)(*(keep(a, b) for a, b in zip(new, old))) if isinstance(
            new, tuple) else (torch.cat([new[:1], old[1:2], new[2:]])
                              if isinstance(new, torch.Tensor) and new.dim() else new)
        return o1, keep(m1, m), odom, mapped

    monkeypatch.setattr(multiseq, "frame_batch", skipped)


def _answer_altered_fleet(monkeypatch):
    step = multiseq.frame_batch

    def altered(o, m, xyz, mask, cfg, mesh=None):
        o, m, odom, mapped = step(o, m, xyz, mask, cfg)
        return o, m, odom, _nudged(mapped)

    monkeypatch.setattr(multiseq, "frame_batch", altered)


@pytest.mark.parametrize("name,frames,steps,fault", [
    ("mulran_os1_64.frontend", 6, 6, _state_unchanged_frontend),
    ("mulran_os1_64.frontend", 6, 6, _answer_altered_frontend),
    ("kitti_hdl64.fleet8", 6, 12, _state_unchanged_fleet),
    ("kitti_hdl64.fleet8", 6, 12, _half_batch_fleet),
    ("kitti_hdl64.fleet8", 6, 12, _one_sequence_unmapped_fleet),
    ("kitti_hdl64.fleet8", 6, 12, _answer_altered_fleet),
], ids=lambda x: getattr(x, "__name__", str(x)))
def test_a_broken_path_is_not_correct(monkeypatch, name, frames, steps, fault):
    fault(monkeypatch)
    result = _run(name, frames, steps)
    assert result["correct"] is False, result["compared"]
