"""Engine: the share of the candidate rows' dimensions the screen read,
in %: 100 x the ``dims_read`` counters over the ``dims_total`` counters
of the program's ``session.search`` spans in the traced window (a full
scan reads 100)."""
from perfbench import program_spans


def read(run):
    spans = program_spans.hot(run, "session.search")
    if not spans:
        return None
    total = sum(s.counters.get("dims_total", 0) for s in spans)
    if total <= 0:
        return None
    return 100.0 * sum(s.counters.get("dims_read", 0) for s in spans) / total
