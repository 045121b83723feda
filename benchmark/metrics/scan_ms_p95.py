"""The 95th percentile of every scan's latency in the window, in the cells
whose pace the card sets: from handing the host scans to the entry until
the mapped poses are on the host."""

from benchlib import stats


def read(run):
    return stats.percentile(run.latencies, 95) * 1e3
