"""The metric arithmetic: a percentile over every scan, rates over the
whole window, the idle share and the roofline share from made-up traces."""

import pytest

from benchlib import peaks, probes, registry, stats, trace
from harness import Run

READ = registry.metrics()


def test_p95_is_over_every_scan():
    lat = [0.010] * 95 + [0.050] * 4 + [0.200]
    run = Run(latencies=lat, scans=100, window_s=2.0, setup_s=7.5)
    assert READ["scan_ms_p95"].read(run) == pytest.approx(10.0)
    lat = [0.010] * 94 + [0.050] * 5 + [0.200]
    assert READ["scan_ms_p95"].read(Run(latencies=lat)) == pytest.approx(50.0)
    assert READ["scan_ms_p50"].read(run) == pytest.approx(10.0)


def test_rate_is_over_the_whole_window():
    run = Run(latencies=[0.01] * 300, scans=300, window_s=30.5, setup_s=1.0)
    assert READ["scans_per_s"].read(run) == pytest.approx(300 / 30.5)
    assert READ["setup_s"].read(run) == 1.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


@pytest.mark.parametrize("name", ["scans_per_s", "scan_ms_p95", "scan_ms_p50",
                                  "frontend_ms_per_scan", "device_idle_pct",
                                  "kernel_roofline_pct.frontend"])
def test_a_stream_metric_reads_as_its_twin(name):
    """The stream family reads what the batch family reads; only its cells
    and bounds differ."""
    twin, code = READ[name + ".stream"].read.__code__, READ[name].read.__code__
    assert (twin.co_code, twin.co_names) == (code.co_code, code.co_names)


def _trace(busy, window=(0.0, 10.0), kernels=(), spans=()):
    return trace.Trace(window=window, busy=list(busy), kernels=list(kernels), spans=list(spans))


def test_idle_share_from_a_timeline():
    t = _trace([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 11.0), (-1.0, 0.5)])
    assert t.busy_s() == pytest.approx(0.5 + 3.0 + 1.0 + 0.5)
    assert READ["device_idle_pct"].read(Run(trace=t)) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_the_host_span():
    t = _trace([(0.0, 1.0), (4.0, 9.0)], spans=[(0.5, 4.2, "frame_batch")])
    gaps = trace.idle_gaps(t)
    assert gaps[0] == ["frame_batch", pytest.approx(3.0)]
    assert gaps[1] == ["harness", pytest.approx(1.0)]


def test_spans_per_scan():
    spans = {"frontend_step": {"calls": 4, "device_ms": 8.0, "host_ms": 9.0},
             "harness": {"calls": 4, "device_ms": 6.0, "host_ms": 7.0}}
    assert READ["frontend_ms_per_scan"].read(Run(spans=spans, scans=4)) == pytest.approx(2.0)
    spans = {"frame_batch": {"calls": 2, "device_ms": 9.0, "host_ms": 10.0}}
    assert READ["frontend_ms_per_scan"].read(Run(spans=spans, scans=16)) == pytest.approx(9 / 16)
    assert READ["frontend_ms_per_scan"].read(Run(spans={}, scans=4)) is None


class _Shaped:
    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def test_roofline_share_from_launch_records_and_a_trace():
    costs = registry.costs()
    launches = probes.Launches(costs)
    b1, o1 = costs["ring_azimuth"].cost((_Shaped(1000, 3), "HDL64", 64))
    launches.per_entry[1] = ("scaloam_tpu_torch.ops.features", {"ring_azimuth": [1, b1, o1]}, None)
    launches.replays[1] = 2
    k = lambda t0: trace.Kernel("void ring_azimuth_kernel<64>(float const*)", t0, t0 + 1e-6,
                                "scaloam_tpu_torch.ops.features")
    run = Run(launches=launches, costs=costs, trace=_trace([], kernels=[k(0.0), k(1.0)]))
    share = READ["kernel_roofline_pct.frontend"].read(run)
    assert share == pytest.approx(100 * 2 * peaks.bound_s(b1, o1) / 2e-6)
    # a launch the records do not hold: no share
    run.trace = _trace([], kernels=[k(0.0), k(1.0), k(2.0)])
    assert READ["kernel_roofline_pct.frontend"].read(run) is None


def test_kernel_names_match_whole():
    assert trace.kernel_matches("void ring_azimuth_kernel<64>(float const*)", "ring_azimuth_kernel")
    assert trace.kernel_matches("select_kernel(float const*, int)", "select_kernel")
    assert not trace.kernel_matches("ring_azimuth_kernel(float)", "azimuth_kernel")
