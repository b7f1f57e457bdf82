"""The engine's set-up: the block walks' warm-up walks and CUDA graph
captures, the summed self time of the ``engine.warmup`` and
``engine.capture`` spans between the run's fit and its traced window, in
s.  A kernel build inside them (``kernels.build``, a child span) is not
counted, so a first run's compile does not widen it."""
from perfbench import program_spans


def read(run):
    spans = program_spans.recorded()
    mine = program_spans.setup(run, ("engine.warmup", "engine.capture"))
    if mine is None:
        return None
    kids = program_spans.children(spans)
    return sum(program_spans.self_ns(s, kids) for s in mine) / 1e9
