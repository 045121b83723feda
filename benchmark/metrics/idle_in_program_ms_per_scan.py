"""Layer: entry points. The traced window's time with nothing on the card
during which one of the program's spans is open on the host (not the
graph's launch, whose host time the profiler inflates), over the window's
scans (its split by innermost span goes to standard error); moves
scans_per_s."""

from benchlib import program


def read(run):
    return program.idle_in_program_ms_per_scan(run.trace, program.records(), run.scans)
