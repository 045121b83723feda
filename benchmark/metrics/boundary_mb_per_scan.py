"""Layer: compile boundary. The bytes the window's replays of captured
steps moved at their boundary (copied into the input buffers, into them
again inside the graph, written back into the caller's state, cloned into
fresh outputs; 1 MB = 1e6 B), over the scans the entry spans carried;
moves scans_per_s."""

from benchlib import program


def read(run):
    return program.boundary_mb_per_scan(program.records())
