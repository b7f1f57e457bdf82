"""The facade's set-up: the method's fit in ``open_index``, the run's
``open.fit`` span (host PCA), in s."""
from perfbench import program_spans


def read(run):
    spans = program_spans.recorded()
    if run.trace is None or not spans:
        return None
    fit = program_spans.fit_span(run, spans)
    return None if fit is None else fit.duration_ns / 1e9
