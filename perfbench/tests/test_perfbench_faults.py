"""A run of the harness, past its look for a card, with the timed path
broken underneath: ``correct`` has to come out false for each fault a
search cell can have, and true on the unbroken path.  On the CPU at a
small size, through the port's own CPU backend."""
import numpy as np
import pytest

from perfbench import harness

SMALL = {"n": 6000, "queries": 120}
SEED = 2 ** 31 + 11


def _alter(res, state):
    """An answer altered where it is produced: one id of the first query
    replaced by its neighbour row."""
    res.ids[0, 4] = (res.ids[0, 4] + 1) % state["n"]
    return res


def _half(res, state):
    """Half of the batch left out: the second half of the real rows
    answered with the first half's answers (a serving step pads its batch
    with replays of its last query; those rows are not real)."""
    h = state["rows"] // 2
    res.ids[h:2 * h] = res.ids[:h].copy()
    res.dists[h:2 * h] = res.dists[:h].copy()
    return res


def _stale(res, state):
    """A step that returns its state unchanged: every call after the
    first hands back the first call's answers."""
    first = state.setdefault("first", (res.ids.copy(), res.dists.copy()))
    if first[0].shape == res.ids.shape:
        res.ids[:], res.dists[:] = first
    return res


def _uncertified(res, state):
    """An answer served without its certificate: the first query's bit of
    ``uncertified_mask`` set (the answer itself unchanged)."""
    mask = np.zeros(res.ids.shape[0], bool)
    mask[0] = True
    res.stats.extra["uncertified_mask"] = mask
    return res


def _lost(res, state):
    """A request that never comes back: the third call fails, so its
    requests end ``failed`` (the serving front keeps serving)."""
    state["calls"] = state.get("calls", 0) + 1
    if state["calls"] == 3:
        raise RuntimeError("planted fault: a lost step")
    return res


FAULTS = {"alter": _alter, "half": _half, "stale": _stale}
#: faults of the guarantee, each held at 0; a lost answer exists only
#: where a front keeps serving past a failed step
GUARANTEE = {"uncertified": _uncertified, "lost": _lost}
ALL = FAULTS | GUARANTEE


def _run(monkeypatch, cell_name, fault, traffic=None):
    from repro_torch.api.session import SearchSession
    cell = harness.Cell(cell_name)
    if traffic:
        cell.traffic = cell.traffic | traffic
    if fault is not None:
        search = SearchSession.search
        state = {"n": SMALL["n"]}

        def broken(self, Q, k=10, **kw):
            Q = np.atleast_2d(Q)
            pad = int((Q == Q[-1]).all(1)[::-1].cumprod().sum())
            state["rows"] = Q.shape[0] - pad + 1
            return ALL[fault](search(self, Q, k, **kw), state)
        monkeypatch.setattr(SearchSession, "search", broken)
    res, checks = harness.execute(cell, SEED, 0.6, False, device="cpu",
                                  config_override=SMALL)
    assert res["checks"]["answers_checked"] > 0
    return res


CASES = [("gist1m.batch100", None), ("deep10m.batch100", None),
         ("gist1m.serve", {"rate_per_s": 400.0, "drain_s": 30.0})]


@pytest.mark.parametrize("cell,traffic", CASES, ids=[c for c, _ in CASES])
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, traffic, fault):
    res = _run(monkeypatch, cell, fault, traffic)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,traffic,fault", [
    *[(c, t, "uncertified") for c, t in CASES],
    ("gist1m.serve", CASES[-1][1], "lost")],
    ids=[f"{c}-uncertified" for c, _ in CASES] + ["gist1m.serve-lost"])
def test_guarantee_fault_is_not_correct(monkeypatch, cell, traffic, fault):
    """An answer served uncertified, or a request that never ended
    answered, makes ``correct`` false although every answer that came is
    right."""
    res = _run(monkeypatch, cell, fault, traffic)
    assert res["correct"] is False, res["checks"]
    assert res["checks"][GUARANTEE_NUMBER[fault]]["value"] > 0
    assert res["checks"]["rank_gap"]["value"] <= \
        res["checks"]["rank_gap"]["limit"]


GUARANTEE_NUMBER = {"uncertified": "uncertified", "lost": "not_done"}


def test_ivf_cell_is_data_only(monkeypatch):
    """A configuration with an IVF index and a probe width runs through
    the harness unchanged and is judged (every list probed: exact)."""
    cell = harness.Cell("gist1m.batch100")
    ivf = {"index": "ivf", "index_params": {"n_list": 8},
           "search": {"nprobe": 8}}
    res, _ = harness.execute(cell, SEED, 0.6, False, device="cpu",
                             config_override=SMALL | ivf)
    assert res["correct"] is True, res["checks"]
