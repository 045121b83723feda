"""The 95th percentile of every scan's latency in the window, in the cells
paced by one stream's latency on the host: from handing the host scan to
the entry until its mapped pose is on the host, what a robot waits for
against the sensor's period."""

from benchlib import stats


def read(run):
    return stats.percentile(run.latencies, 95) * 1e3
