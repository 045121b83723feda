"""The readers of the program's own spans (benchlib/program.py, the
metrics entry_device_ms_per_scan, boundary_mb_per_scan,
boundary_host_ms_per_scan, idle_in_program_ms_per_scan and their
`.stream` twins) on hand-made records, and the device trace's reading
with the program's `slam.*` ranges in it."""

from typing import NamedTuple, Optional

import pytest
import torch

from benchlib import program, registry, trace
from harness import Run

READ = registry.metrics()
NEW = ("entry_device_ms_per_scan", "boundary_mb_per_scan", "boundary_host_ms_per_scan",
       "idle_in_program_ms_per_scan")


class Rec(NamedTuple):
    id: int
    name: str
    parent: Optional[int]
    request: int
    start_ns: int
    host_ns: int
    device_ms: Optional[float]
    counts: dict


def _rec(name, start_ms, host_ms, device_ms=None, parent=None, **counts):
    counts = {k.replace("__", "."): v for k, v in counts.items()}
    return Rec(0, name, parent, 0, int(start_ms * 1e6), int(host_ms * 1e6), device_ms, counts)


@pytest.mark.parametrize("name", NEW)
def test_a_stream_metric_reads_as_its_twin(name):
    twin, code = READ[name + ".stream"].read.__code__, READ[name].read.__code__
    assert (twin.co_code, twin.co_names) == (code.co_code, code.co_names)


def _fleet_records():
    """Two batched frames of 8 scans, each: a key and a replay of the step
    with its three parts, inside the entry span."""
    recs = []
    for f in range(2):
        t = 100.0 * f
        recs += [
            _rec("compiled.key", t + 1.0, 0.5, compiled__leaves=70),
            _rec("compiled.copy_in", t + 2.0, 0.25, compiled__copy_in_bytes=3e8),
            _rec("compiled.launch", t + 3.0, 0.125, compiled__keep_bytes=2.5e8),
            _rec("compiled.outputs", t + 4.0, 0.25, compiled__write_back_bytes=2.5e8,
                 compiled__clone_bytes=1e6),
            _rec("compiled.replay:parallel.multiseq._frame_batch", t + 1.6, 3.0),
            _rec("multiseq.frame_batch", t, 36.0, device_ms=34.0, scans=8),
        ]
    return recs


def test_the_program_readers_on_made_up_records(monkeypatch):
    recs = _fleet_records()
    monkeypatch.setattr(program, "records", lambda: recs)
    run = Run(scans=16)
    assert READ["entry_device_ms_per_scan"].read(run) == pytest.approx(68.0 / 16)
    assert READ["boundary_mb_per_scan"].read(run) == pytest.approx(2 * 801.0 / 16)
    # key, copies in and outputs; not the launch, nor the replay span around them
    assert READ["boundary_host_ms_per_scan"].read(run) == pytest.approx(2 * 1.0 / 16)
    # the front end's step: one scan a span
    recs = [_rec("frontend.step", 0.0, 12.0, device_ms=11.0, scans=1),
            _rec("frontend.step", 20.0, 14.0, device_ms=13.0, scans=1)]
    monkeypatch.setattr(program, "records", lambda: recs)
    assert READ["entry_device_ms_per_scan.stream"].read(run) == pytest.approx(12.0)
    assert READ["boundary_mb_per_scan.stream"].read(run) is None  # no replay
    assert READ["boundary_host_ms_per_scan.stream"].read(run) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    t = trace.Trace(window=(0.0, 1.0), busy=[], kernels=[], spans=[])
    monkeypatch.setattr(program, "records", lambda: None)
    for name in NEW:
        assert READ[name].read(Run(scans=4, trace=t)) is None
        assert READ[name + ".stream"].read(Run(scans=4, trace=t)) is None
    monkeypatch.undo()
    from scaloam_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "records")
    assert program.records() is None


def test_idle_time_is_split_by_the_innermost_program_span(monkeypatch, capsys):
    # window 0-100 ms; the device busy 0-10, 30-60, 90-100 ms: idle 10-30
    # and 60-90 ms
    t = trace.Trace(window=(0.0, 0.1), busy=[(0.0, 0.01), (0.03, 0.06), (0.09, 0.1)],
                    kernels=[], spans=[])
    recs = [_rec("frontend.step", 5.0, 40.0),  # 5-45 ms
            _rec("scan.upload", 12.0, 6.0, scan__upload_bytes=1e6),  # 12-18
            _rec("frontend.gate_read", 20.0, 15.0),  # 20-35
            _rec("compiled.key", 62.0, 4.0, compiled__leaves=70),  # 62-66
            _rec("compiled.launch", 70.0, 3.0)]  # 70-73
    split = program.idle_by_span(t, program.ranges(recs))
    assert split == pytest.approx({"frontend.step": 0.002 + 0.002, "scan.upload": 0.006,
                                   "frontend.gate_read": 0.010, "compiled.key": 0.004,
                                   "compiled.launch": 0.003, None: 0.002 + 0.021})
    monkeypatch.setattr(program, "records", lambda: recs)
    got = READ["idle_in_program_ms_per_scan.stream"].read(Run(scans=2, trace=t))
    assert got == pytest.approx((4 + 6 + 10 + 4) / 2)  # the launch's 3 ms left out
    err = capsys.readouterr().err
    assert "frontend.gate_read 5.0000" in err and "under no program span 11.5000" in err
    assert "compiled.launch 1.5000" in err  # printed in the split
    assert "scan.upload 3.0000 (scan.upload_bytes 500000)" in err
    assert "compiled.key 2.0000 (compiled.leaves 35)" in err


class _Event:
    """A kineto event as trace.read sees one."""

    def __init__(self, name, start_ns, dur_ns, device, corr=0, linked=0):
        self._v = (name, start_ns, dur_ns, device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_the_trace_reads_the_same_with_the_programs_ranges():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    base = [_Event("bench.window", 0, 1_000_000, cpu),
            _Event("bench.step:scaloam_tpu_torch.models.frontend", 100_000, 400_000, cpu),
            _Event("bench.span:frontend_step", 50_000, 600_000, cpu),
            _Event("cudaGraphLaunch", 150_000, 10_000, cpu, corr=7),
            _Event("cudaMemcpyAsync", 120_000, 5_000, cpu, corr=8),
            _Event("void k<64>(float const*)", 200_000, 50_000, cuda, corr=9, linked=7),
            _Event("Memcpy DtoD (Device -> Device)", 130_000, 20_000, cuda, corr=8),
            _Event("bench.step:scaloam_tpu_torch.models.frontend", 200_000, 50_000, cuda)]
    program_ranges = [_Event("slam.frontend.step", 60_000, 580_000, cpu),
                      _Event("slam.compiled.key", 70_000, 20_000, cpu),
                      _Event("slam.compiled.replay:models.frontend._step_body", 100_000,
                             300_000, cpu),
                      _Event("slam.compiled.launch", 140_000, 30_000, cpu)]
    without, with_ = trace.read(base), trace.read(base[:4] + program_ranges + base[4:])
    for field in ("window", "busy", "kernels", "spans"):
        assert getattr(with_, field) == getattr(without, field), field
    assert [k.name for k in with_.kernels] == ["void k<64>(float const*)"]


def test_the_programs_ranges_stay_off_the_device_timeline(card):
    """On the card: the spans' profiler ranges are host operator ranges,
    never device events, so busy time and kernels hold only the work."""
    from scaloam_tpu_torch.utils import timing

    x = torch.ones((1 << 20,), device=card)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with timing.span("outer", scans=1, device=True):
                with timing.span("inner"):
                    y = (x * 2.0).sum()
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    from torch.autograd import DeviceType

    assert not [e.name() for e in events
                if e.device_type() == DeviceType.CUDA and e.name().startswith("slam.")]
    assert {"slam.outer", "slam.inner"} <= {e.name() for e in events}
    got = trace.read(events)
    assert got.kernels and not [k for k in got.kernels if k.name.startswith("slam.")]
    recs = {r.name: r for r in timing.records()}
    assert recs["outer"].device_ms > 0 and float(y) == 2.0 * (1 << 20)
