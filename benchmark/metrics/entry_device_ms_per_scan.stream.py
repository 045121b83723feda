"""Layer: front-end stages. As entry_device_ms_per_scan, in the cells paced
by one stream; moves scans_per_s.stream."""

from benchlib import program


def read(run):
    return program.entry_device_ms_per_scan(program.records())
