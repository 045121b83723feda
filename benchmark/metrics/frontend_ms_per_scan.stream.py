"""Layer: front-end stages. As frontend_ms_per_scan, in the cells paced by
one stream; moves scans_per_s.stream."""

from benchlib import stats


def read(run):
    return stats.front_ms_per_scan(run.spans, run.scans)
