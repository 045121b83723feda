"""Layer: front-end stages. The stream time between the CUDA events of the
program's own entry spans (`frontend.step`, `multiseq.frame_batch`), over
the scans they carried: the inside twin of frontend_ms_per_scan; moves
scans_per_s."""

from benchlib import program


def read(run):
    return program.entry_device_ms_per_scan(program.records())
