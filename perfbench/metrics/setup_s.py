"""Set-up: process start to the first timed query (data, the index's
fit and layout, the warm-up of the cell's shapes)."""


def read(run):
    return run.setup_s
