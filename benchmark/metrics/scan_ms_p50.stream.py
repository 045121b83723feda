"""Layer: entry points. As scan_ms_p50, in the cells paced by one stream;
moves scans_per_s.stream."""

from benchlib import stats


def read(run):
    return stats.median_ms(run.latencies)
