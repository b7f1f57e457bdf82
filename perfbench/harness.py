"""Runs one cell of ``BENCHMARK.json`` and builds its result line.

Set-up makes the corpus and the query pool on the device from the seed,
opens the program's index on them (``repro_torch.api.open_index``) and
warms the cell's own shapes; the window then drives the traffic for the
given seconds.  After the window the program's state is freed and every
answer it gave is held against the plain reference (``check.py``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from perfbench import check, data, devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded once the window has closed:
#: the JAX package beside the port, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """A driver or a reader, loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """Everything one cell is made of, found by name."""

    def __init__(self, name: str):
        bench = load_benchmark()
        self.name = name
        self.workload = find(bench["workloads"], name, "workload")
        entry = find(bench["configs"], self.workload["config"], "config")
        self.config = json.loads((ROOT / entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.driver = load_module(HERE / "traffic" / f"{self.traffic['kind']}.py")
        self.limits = json.loads(
            (HERE / "checks" / f"{name}.json").read_text())["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py")


class Run:
    """The state of one run, which the drivers fill and the readers read."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.config = cell.config
        self.traffic = cell.traffic
        self.k = int(cell.traffic["k"])
        #: keyword arguments of every search (an IVF index's ``nprobe``)
        self.search = cell.config.get("search", {})
        self.session = self.service = None
        self.result: dict = {}          # what the window measured
        self.traced_work: dict = {}     # what the traced part did
        self.trace = None
        self.parts: dict = {}           # set-up's parts, seconds
        self.setup_s = None
        self.numbers: dict = {}         # the comparison's numbers
        self._answers: list = []
        self.not_done = 0               # requests never answered
        self.uncertified = 0            # answers without a certificate

    def answer(self, qidx, ids, dists, uncertified=None) -> None:
        """Keep answers for the check; ``uncertified`` is the result's
        per-query ``uncertified_mask`` (``None``: no certificate given,
        so every answer counts as uncertified)."""
        qidx = np.asarray(qidx)
        self._answers.append((qidx, np.asarray(ids), np.asarray(dists)))
        self.uncertified += (len(qidx) if uncertified is None
                             else int(np.count_nonzero(uncertified)))

    def answers(self) -> tuple:
        if not self._answers:
            return (np.zeros(0, np.int64), np.zeros((0, self.k), np.int64),
                    np.zeros((0, self.k), np.float32))
        return tuple(np.concatenate(a) for a in zip(*self._answers))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def open_session(run: Run, X: np.ndarray):
    """The program's entry: fit the configuration's method and build its
    index on the corpus, with the configuration's ``method_params`` and
    ``index_params`` where it has them (an IVF index's ``n_list``)."""
    from repro_torch.api import SchedulePolicy, open_index
    cfg = run.config
    return open_index(X, index=cfg["index"], method=cfg["method"],
                      schedule=SchedulePolicy(**cfg["policy"]),
                      method_params=cfg.get("method_params"),
                      index_params=cfg.get("index_params"),
                      device=run.device)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, *,
            device="cuda", t_start: float | None = None,
            config_override: dict | None = None) -> tuple:
    """Set-up, the window and, with ``trace``, the traced part of one run
    of ``cell``; then the program's state is freed.  Returns ``(run, X,
    peak)``: the run, the corpus as the program got it and the device's
    peak of allocated bytes.  ``config_override`` replaces sizes of the
    configuration (tests run cells at a small size on the CPU that way)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    if config_override:
        cell.config = cell.config | config_override
    run = Run(cell, seed, device)
    dev = torch.device(device)
    cfg, p = run.config, run.traffic

    t0 = time.perf_counter()
    Xd, Qd = data.make(cfg, seed, dev, pool=p.get("pool", "in_distribution"),
                       severity=float(p.get("ood_severity", 1.0)))
    X, run.pool = Xd.cpu().numpy(), Qd.cpu().numpy()
    del Xd, Qd
    run.parts["data_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    with devtrace.span("open"):
        run.session = open_session(run, X)
    _sync(dev)
    run.parts["open_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cell.driver.warm(run)
    _sync(dev)
    run.parts["warm_s"] = time.perf_counter() - t0
    run.setup_s = time.perf_counter() - t_start

    cell.driver.window(run, seconds)
    if trace:
        traces: list = []
        with devtrace.traced(traces, dev):
            cell.driver.traced(run)
        run.trace = traces[0]
    cell.driver.finish(run)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    run.service = run.session = None       # free the program's state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run, X, peak


def compare(run: Run, X: np.ndarray, *, answers: tuple | None = None) -> dict:
    """The comparison's numbers for the run's answers, against the
    reference computed on the run's device, with the run's counts of
    requests never answered and answers served uncertified.  Given
    ``answers`` (a control put in the program's place), those are judged
    instead, and both counts are 0."""
    import torch
    dev = torch.device(run.device)
    if answers is None:
        answers, counts = run.answers(), check.delivery(run.not_done,
                                                        run.uncertified)
    else:
        counts = check.delivery(0, 0)
    qidx, ids, dists = answers
    return check.compare(torch.as_tensor(X).to(dev),
                         torch.as_tensor(run.pool).to(dev),
                         qidx, ids, dists, k=run.k) | counts


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            **kwargs) -> tuple:
    """One run of ``cell``: returns ``(result line, check lines)``."""
    run, X, peak = measure(cell, seed, seconds, trace, **kwargs)
    run.numbers = compare(run, X)
    correct = check.judge(run.numbers, cell.limits)
    return line(run, correct, peak, trace), check_lines(run)


def metrics(run: Run, trace: bool) -> dict:
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run, peak: int) -> dict:
    import torch
    dev = torch.device(run.device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
    return info


def attempted_failed(run: Run) -> tuple:
    reqs = run.result.get("requests")
    if reqs is not None:
        return len(reqs), sum(r["status"] != "done" for r in reqs)
    return run.numbers["answers_checked"], 0


def line(run: Run, correct: bool, peak: int, trace: bool) -> dict:
    attempted, failed = attempted_failed(run)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics(run, trace),
           "device": device_info(run, peak)}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": run.numbers[name], "limit": limit}
                     for name, limit in run.cell.limits.items()}
    out["checks"]["answers_checked"] = run.numbers["answers_checked"]
    return out


def check_lines(run: Run) -> list:
    return [f"check {name} {run.numbers[name]!r} limit {limit!r}"
            for name, limit in run.cell.limits.items()] + [
        f"check answers_checked {run.numbers['answers_checked']}"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
