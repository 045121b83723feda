"""Layer: compile boundary. As boundary_host_ms_per_scan, in the cells
paced by one stream; moves scans_per_s.stream."""

from benchlib import program


def read(run):
    return program.boundary_host_ms_per_scan(program.records())
