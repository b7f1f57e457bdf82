"""The facade's set-up: host clock around ``open_index`` (the method's
fit and the index), ended by a synchronise."""


def read(run):
    return run.parts.get("open_s")
