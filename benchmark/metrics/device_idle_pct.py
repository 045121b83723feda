"""Layer: device. The share of the traced window with no kernel or copy on
the card, from the torch.profiler timeline; moves scans_per_s."""

from benchlib import stats


def read(run):
    return stats.idle_pct(run.trace)
