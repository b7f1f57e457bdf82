"""The engine's set-up: host clock around the warm-up searches of the
cell's own shapes (the corpus's device layout, the graphs' capture and
first replays), ended by a synchronise."""


def read(run):
    return run.parts.get("warm_s")
