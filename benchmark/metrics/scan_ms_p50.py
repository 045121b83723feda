"""Layer: entry points. The median of every scan's latency in the traced
window, on the harness's host clock; moves scans_per_s."""

from benchlib import stats


def read(run):
    return stats.median_ms(run.latencies)
