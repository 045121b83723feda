"""Set-up: from the process's start to the window's, loading, building,
making the scans and warming every step the traffic uses."""


def read(run):
    return run.setup_s
