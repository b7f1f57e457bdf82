"""The engine's set-up: the device layout of the corpus, the summed
``backend.layout`` spans between the run's fit and its traced window,
in s."""
from perfbench import program_spans


def read(run):
    spans = program_spans.setup(run, ("backend.layout",))
    if spans is None:
        return None
    return sum(s.duration_ns for s in spans) / 1e9
