"""Scans completed in the window over the window's whole time (summed over
the sequences a step carries), in the cells whose pace the card sets: how
long a fleet's logs take to map."""

from benchlib import stats


def read(run):
    return stats.rate(run.scans, run.window_s)
