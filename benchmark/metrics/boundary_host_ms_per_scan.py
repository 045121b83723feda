"""Layer: compile boundary. The host time of the captured steps' calls in
the window (key, copies in, outputs; not the graph's launch, whose host
time the profiler inflates), over the scans the entry spans carried;
moves scans_per_s."""

from benchlib import program


def read(run):
    return program.boundary_host_ms_per_scan(program.records())
