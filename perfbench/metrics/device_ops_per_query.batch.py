"""Engine: device kernels (copies and fills of memory apart) in the
traced window over the queries it answered (torch.profiler)."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.traced_work.get("queries"):
        return None
    return len(run.trace.kernels()) / run.traced_work["queries"]
