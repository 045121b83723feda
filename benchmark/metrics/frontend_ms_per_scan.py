"""Layer: front-end stages. The stream time between the CUDA events around
the calls into the front end, over the scans they carried; moves
scans_per_s."""

from benchlib import stats


def read(run):
    return stats.front_ms_per_scan(run.spans, run.scans)
