"""Layer: device. As device_idle_pct, in the cells paced by one stream;
moves scans_per_s.stream."""

from benchlib import stats


def read(run):
    return stats.idle_pct(run.trace)
