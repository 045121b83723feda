"""Layer: entry points. As idle_in_program_ms_per_scan, in the cells paced
by one stream; moves scans_per_s.stream."""

from benchlib import program


def read(run):
    return program.idle_in_program_ms_per_scan(run.trace, program.records(), run.scans)
