"""The harness finds every part of a cell by name, and BENCHMARK.json
keeps the shape the benchmark's contract gives it."""
import json
import re

import pytest

from perfbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("closed_batch", "poisson_serve")
    for fn in ("warm", "window", "traced", "finish"):
        assert callable(getattr(c.driver, fn))
    assert set(c.limits) == {"rank_gap", "dist_err", "not_done",
                             "uncertified"}
    assert c.limits["not_done"] == c.limits["uncertified"] == 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    mod = harness.Cell(CELLS[0]).reader(metric)
    assert callable(mod.read)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such.cell")


@pytest.mark.parametrize("cell", CELLS)
def test_config_and_mix_parameters_reach_the_program(monkeypatch, cell):
    """An IVF cell is data only: the configuration's ``index_params`` and
    ``method_params`` reach ``open_index``, and its ``search`` keywords
    every search."""
    import repro_torch.api as api
    seen = {}

    def spy(X, **kw):
        seen.update(kw)
        return "session"
    monkeypatch.setattr(api, "open_index", spy)
    c = harness.Cell(cell)
    c.config = c.config | {"index": "ivf", "index_params": {"n_list": 8},
                           "method_params": {"a": 1},
                           "search": {"nprobe": 4, "ef": 32}}
    run = harness.Run(c, 1, "cpu")
    assert harness.open_session(run, None) == "session"
    assert seen["index"] == "ivf" and seen["index_params"] == {"n_list": 8}
    assert seen["method_params"] == {"a": 1}
    assert run.search == {"nprobe": 4, "ef": 32}
