"""Scans completed in the window over the window's whole time, in the
cells paced by one stream's latency on the host (a scan at a time, whose
spread is the shared host's, so the metric has a bound of its own): how
long a recorded sequence takes to map."""

from benchlib import stats


def read(run):
    return stats.rate(run.scans, run.window_s)
