"""Batch throughput: queries answered in the window over its seconds
(host clock; the last batch ends the window)."""


def read(run):
    r = run.result
    if "queries" not in r or not r["elapsed_s"]:
        return None
    return r["queries"] / r["elapsed_s"]
