"""The port's snapshots and crash-safe delta WAL (repro_torch.api.
persistence, DESIGN.md §7) against the reference package's.

1. Every case of tests/test_wal.py, on the port's torch backend on the
   CPU and on its host backend (the reference runs them on its host
   backend), plus tests/test_api.py's save/load round trip and
   tests/test_serving_search.py's save/load with a non-empty delta.
2. Across packages: the WAL frames one package writes are the frames the
   other reads, byte for byte, torn tails included; the same save, add,
   crash and load script gives the reference's ids exactly and distances
   within rtol 1e-4; a snapshot the reference wrote is refused by the
   port with ``IndexLoadError`` and imports neither the reference nor
   jax; a snapshot holds no tensor, and loads onto the card unless the
   caller asks for the CPU.
"""
import os
import pickle
import struct
import subprocess
import sys
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import SchedulePolicy as JaxPolicy
from repro.api import SearchSession as JaxSession
from repro.api import open_index as jax_open_index
from repro.api.persistence import DeltaWAL as JaxWAL
from repro.testing import faults as jax_faults
from repro_torch.api import (DeltaWAL, IndexLoadError, SchedulePolicy,
                             SearchSession, open_index)
from repro_torch.api.persistence import wal_path
from repro_torch.testing import SimulatedCrash, faults

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["torch", "host"]


def _data(n=600, d=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(64, d)).astype(np.float32),
            rng.normal(size=(6, d)).astype(np.float32))


def _snap(tmp_path):
    return str(tmp_path / "idx.bin")


def _open(X=None, backend="torch", **kw):
    """open_index on the port's ``backend``: the torch backend on the CPU."""
    return open_index(X, backend=backend, device="cpu", **kw)


def _load(p, **kw):
    return SearchSession.load(p, device="cpu", **kw)


# ------------------------------------------------------------ happy path ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_save_arms_wal_and_reload_replays(tmp_path, backend):
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)        # build + save: WAL armed
    assert sess.wal is not None and os.path.exists(wal_path(p))
    sess.add(extra[:20])
    sess.add(extra[20:40])
    re = _load(p)
    assert re.backend_name == backend
    assert re.n == sess.n == X.shape[0] + 40
    a, b = sess.search(Q, 5), re.search(Q, 5)
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.dists, b.dists)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kill_after_add_loses_no_acknowledged_insert(tmp_path, backend):
    """Snapshot, acknowledged adds, simulated kill (drop the session — the
    WAL write already happened inside add()), reload; recall against a
    brute-force oracle over the FULL corpus must be exactly 1.0."""
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra)                          # acknowledged
    del sess                                 # "kill -9": no save() ran
    re = _load(p)
    full = np.concatenate([X, extra])
    assert re.n == full.shape[0]
    res = re.search(Q, 10)
    d2 = ((Q[:, None] - full[None]) ** 2).sum(-1)
    oracle = np.argsort(d2, 1)[:, :10]
    recall = np.mean([len(set(res.ids[i]) & set(oracle[i])) / 10
                      for i in range(Q.shape[0])])
    assert recall == 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_replay_is_idempotent(tmp_path, backend):
    """Double replay == single replay: loading twice (each load replays)
    and replaying the armed log against an already-caught-up session both
    apply nothing new."""
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:16])
    one = _load(p)
    two = _load(p)
    assert one.n == two.n == X.shape[0] + 16
    assert one.wal.replay(one) == 0          # explicit second replay: no-op
    assert one.n == X.shape[0] + 16


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_clears_the_log(tmp_path, backend):
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:16])
    assert os.path.getsize(wal_path(p)) > 0
    sess.save(p)                             # snapshot absorbs the deltas
    assert os.path.getsize(wal_path(p)) == 0
    assert _load(p).n == X.shape[0] + 16


# ------------------------------------------------------------ torn writes ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_write_never_acknowledges_and_recovers(tmp_path, backend):
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:10])                     # good frame before the tear
    with faults.inject(torn_frame_keep=0.5):
        with pytest.raises(SimulatedCrash):
            sess.add(extra[10:20])           # never acknowledged
    assert sess.n == X.shape[0] + 10         # nor applied
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        re = _load(p)
    assert any("torn" in str(x.message) for x in w)
    assert re.n == X.shape[0] + 10           # good frame kept, tear dropped


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("keep", [0.0, 0.1, 0.9])
def test_torn_tail_any_length_is_dropped(tmp_path, keep, backend):
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    with faults.inject(torn_frame_keep=keep):
        with pytest.raises(SimulatedCrash):
            sess.add(extra[:8])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        re = _load(p)
    assert re.n == X.shape[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_recovery_truncates_so_later_appends_survive(tmp_path, backend):
    """A torn tail must not poison the log: after a recovering load the
    next append lands on a frame boundary and survives the next load."""
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    with faults.inject(torn_frame_keep=0.4):
        with pytest.raises(SimulatedCrash):
            sess.add(extra[:8])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        re = _load(p)                        # truncates the torn tail
    re.add(extra[8:12])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        again = _load(p)
        assert not [x for x in w if "torn" in str(x.message)]
    assert again.n == X.shape[0] + 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_corrupt_middle_frame_stops_replay_at_it(tmp_path, backend):
    """Bit-rot in an earlier frame drops it AND everything after (order
    matters for n_before bookkeeping) — with a warning, never a crash."""
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:8])
    sess.add(extra[8:16])
    wp = wal_path(p)
    raw = bytearray(open(wp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF               # flip a bit mid-file
    open(wp, "wb").write(bytes(raw))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        re = _load(p)
    assert any("CRC" in str(x.message) or "torn" in str(x.message) for x in w)
    assert X.shape[0] <= re.n < X.shape[0] + 16


# --------------------------------------------------------------- loading ----
def _with_trailer(body: bytes) -> bytes:
    """Append a VALID integrity trailer, as save_session would."""
    return body + b"SNAP" + struct.pack("<QI", len(body), zlib.crc32(body))


def test_load_errors_are_typed_and_name_the_path(tmp_path):
    missing = str(tmp_path / "nope.bin")
    with pytest.raises(IndexLoadError, match="does not exist") as ei:
        _load(missing)
    assert ei.value.path == missing
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00 this is not a snapshot")
    with pytest.raises(IndexLoadError, match="integrity trailer"):
        _load(str(bad))                      # foreign file: no SNAP trailer
    notdict = tmp_path / "notdict.bin"
    notdict.write_bytes(_with_trailer(pickle.dumps([1, 2, 3])))
    with pytest.raises(IndexLoadError, match="not a session snapshot"):
        _load(str(notdict))
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(_with_trailer(b"\x80\x05 not a pickle"))
    with pytest.raises(IndexLoadError, match="not a readable"):
        _load(str(garbage))


# ----------------------------------------------------- snapshot integrity ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_bitflip_is_detected_before_unpickling(tmp_path, backend):
    """A flipped bit anywhere in the pickle payload must fail the crc32
    check with a typed error — never reach the unpickler."""
    X, _, _ = _data()
    p = _snap(tmp_path)
    _open(X, backend, path=p)
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0x01               # single bit, mid-payload
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IndexLoadError, match="checksum mismatch") as ei:
        _load(p)
    assert ei.value.path == p


@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_truncation_is_detected(tmp_path, backend):
    """Losing the tail (trailer gone or payload short) is a typed load
    error, whichever byte the cut lands on."""
    X, _, _ = _data()
    p = _snap(tmp_path)
    _open(X, backend, path=p)
    raw = open(p, "rb").read()
    for keep in (len(raw) - 1, len(raw) - 8, len(raw) // 2, 3):
        open(p, "wb").write(raw[:keep])
        with pytest.raises(IndexLoadError,
                           match="integrity trailer|checksum mismatch"):
            _load(p)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trailer_corruption_is_detected(tmp_path, backend):
    """Bit-rot in the trailer itself (stored crc) also fails closed."""
    X, _, _ = _data()
    p = _snap(tmp_path)
    _open(X, backend, path=p)
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF                          # stored crc32 byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IndexLoadError, match="checksum mismatch"):
        _load(p)


# ------------------------------------------------------- non-finite rows ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_add_rejects_non_finite_rows(tmp_path, backend):
    """add() refuses NaN/Inf rows BEFORE logging them, so poison never
    reaches the WAL through the public path."""
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    poison = extra[:4].copy()
    poison[1, 0] = np.nan
    poison[3, 2] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        sess.add(poison)
    assert sess.n == X.shape[0]              # nothing inserted
    re = _load(p)                            # nothing logged either
    assert re.n == X.shape[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_replay_skips_non_finite_frames_with_warning(tmp_path, backend):
    """A poison frame already ON DISK (written by an older build, or
    bit-rot that kept the CRC valid) is skipped at replay with a warning,
    and clean frames before it still apply."""
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:8])                      # clean frame, n_before=600
    poison = extra[8:12].copy()
    poison[0, 0] = np.nan
    sess.wal.append(poison, sess.n)          # bypass add()'s validation
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        re = _load(p)
    assert any("non-finite" in str(x.message) for x in w)
    assert re.n == X.shape[0] + 8            # clean frame applied, poison not
    clean = np.concatenate([X, extra[:8]])
    oracle = np.argsort(((clean[None] - Q[:, None]) ** 2).sum(-1), 1)[:, :5]
    got = re.search(Q, 5).ids
    assert np.array_equal(np.sort(got, 1), np.sort(oracle, 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_open_index_path_roundtrip_and_ivf(tmp_path, backend):
    """open_index(path=...) loads snapshot+WAL; works for ivf too (replay
    runs the real insert path, so partition lists stay consistent)."""
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, index="ivf", path=p,
                 schedule=SchedulePolicy(d1=16))
    sess.add(extra[:12])
    re = open_index(path=p, device="cpu")
    assert re.index_kind == "ivf" and re.n == X.shape[0] + 12
    assert re.backend_name == backend
    assert np.array_equal(sess.search(Q, 5, nprobe=64).ids,
                          re.search(Q, 5, nprobe=64).ids)
    with pytest.raises(ValueError, match="pass vectors X"):
        open_index()


@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_without_snapshot_is_inert(tmp_path, backend):
    """Sessions never tied to a path keep the behavior without a log."""
    X, extra, _ = _data()
    sess = _open(X, backend)
    assert sess.wal is None
    sess.add(extra[:4])                      # no file side effects
    assert not os.listdir(tmp_path)


# ------------------------------------------------- atomic save crash points --
@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_mid_save_keeps_old_snapshot_and_wal(tmp_path, backend):
    """Kill the process between the tmp write and the atomic rename (the
    worst point): the previous snapshot AND its delta frames must reload
    intact — the failed save loses nothing."""
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p)
    sess.add(extra[:20])                     # acknowledged, in the WAL
    with faults.inject(crash_save=0):
        with pytest.raises(SimulatedCrash, match="rename never happened"):
            sess.save(p)
    re = _load(p)                            # old snapshot + WAL replay
    assert re.n == X.shape[0] + 20
    full = np.concatenate([X, extra[:20]])
    oracle = np.argsort(((Q[:, None] - full[None]) ** 2).sum(-1), 1)[:, :5]
    assert np.array_equal(np.sort(re.search(Q, 5).ids, 1),
                          np.sort(oracle, 1))
    # the tier heals: the next save lands atomically and absorbs the log
    sess.save(p)
    assert os.path.getsize(wal_path(p)) == 0
    assert _load(p).n == X.shape[0] + 20


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_mid_save_before_any_wal_is_clean_slate(tmp_path, backend):
    """Crash on the very first save: no snapshot exists yet, and the load
    error is the typed missing-file one, not a torn hybrid."""
    X, _, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend)
    with faults.inject(crash_save=0):
        with pytest.raises(SimulatedCrash):
            sess.save(p)
    assert not os.path.exists(p)             # only the tmp file remains
    with pytest.raises(IndexLoadError, match="does not exist"):
        _load(p)


# ------------------------------------------------------- segment rotation ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_rotation_splits_segments_and_replays_in_order(tmp_path,
                                                           backend):
    """With ``wal_max_bytes`` set, appends past the cap open numbered
    segments; replay walks them in order and reconstructs the corpus."""
    X, extra, Q = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p,
                 schedule=SchedulePolicy(wal_max_bytes=1))
    for i in range(3):                       # cap=1 byte: every add rotates
        sess.add(extra[10 * i:10 * (i + 1)])
    segs = sess.wal._segments()
    assert segs == [wal_path(p), f"{wal_path(p)}.0001", f"{wal_path(p)}.0002"]
    assert sess.wal.total_bytes() == sum(os.path.getsize(s) for s in segs)
    re = _load(p)
    assert re.n == X.shape[0] + 30
    assert np.array_equal(sess.search(Q, 5).ids, re.search(Q, 5).ids)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_rotation_clear_removes_every_segment(tmp_path, backend):
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p,
                 schedule=SchedulePolicy(wal_max_bytes=1))
    for i in range(3):
        sess.add(extra[8 * i:8 * (i + 1)])
    assert len(sess.wal._segments()) == 3
    sess.save(p)                             # snapshot absorbs + clears
    assert sess.wal._segments() == [wal_path(p)]
    assert os.path.getsize(wal_path(p)) == 0
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("idx.bin.wal.")]
    assert _load(p).n == X.shape[0] + 24


@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_rotation_torn_tail_truncates_only_last_segment(tmp_path,
                                                            backend):
    """A torn frame in the newest segment drops only that unacknowledged
    tail; every rotated-out segment replays whole, and the post-recovery
    append survives."""
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p,
                 schedule=SchedulePolicy(wal_max_bytes=1))
    sess.add(extra[:8])
    sess.add(extra[8:16])
    with faults.inject(torn_frame_keep=0.5):
        with pytest.raises(SimulatedCrash):
            sess.add(extra[16:24])           # tears segment .0002
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        re = _load(p)                        # truncates the torn segment
    assert any("torn" in str(x.message) for x in w)
    assert re.n == X.shape[0] + 16
    re.add(extra[16:20])
    assert _load(p).n == X.shape[0] + 20


@pytest.mark.parametrize("backend", BACKENDS)
def test_wal_bytes_surfaces_in_serving_health(tmp_path, backend):
    X, extra, _ = _data()
    p = _snap(tmp_path)
    sess = _open(X, backend, path=p,
                 schedule=SchedulePolicy(wal_max_bytes=1))
    svc = sess.serve(slots=2, k=5)
    svc.add(extra[:8])
    svc.add(extra[8:16])
    h = svc.health()
    assert h["wal_bytes"] == sess.wal.total_bytes() > 0


def test_frames_roundtrip_unit(tmp_path):
    """DeltaWAL alone: frames come back in order with exact payloads."""
    wal = DeltaWAL(tmp_path / "unit.wal")
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = -np.ones((2, 4), np.float32)
    wal.append(a, 100)
    wal.append(b, 103)
    frames = wal.frames()
    assert [f[0] for f in frames] == [100, 103]
    assert np.array_equal(frames[0][1], a)
    assert np.array_equal(frames[1][1], b)
    wal.clear()
    assert wal.frames() == []


# ------------------------------------------------- test_api / serving ----
@pytest.mark.parametrize("backend", BACKENDS)
def test_save_load_roundtrip(tmp_path, backend):
    """An IVF DADE session round-trips (ids equal, distances within rtol
    1e-6) and the loaded session still takes dynamic adds."""
    X, _, _ = _data(n=2000, d=64, seed=5)
    Q = np.random.default_rng(6).normal(size=(5, 64)).astype(np.float32)
    sess = _open(X, backend, index="ivf", method="DADE",
                 index_params={"n_list": 32})
    before = sess.search(Q, 10, nprobe=8)
    path = os.path.join(tmp_path, "session.bin")
    sess.save(path)
    loaded = _load(path)
    after = loaded.search(Q, 10, nprobe=8)
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_allclose(before.dists, after.dists, rtol=1e-6)
    loaded.add(Q[:3])
    assert loaded.n == X.shape[0] + 3


def test_save_load_with_nonempty_delta(tmp_path):
    """A torch session saved while its delta segment holds rows reloads
    with every row (the layout is rebuilt whole on the first search)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1536, 48)).astype(np.float32)
    Q = rng.normal(size=(12, 48)).astype(np.float32)
    pol = SchedulePolicy(d1=24, query_chunk=4, row_block=256,
                         block_capacity=256)
    sess = _open(X[:1200], "torch", method="PDScanning+", schedule=pol)
    sess.search(Q, 10)
    sess.add(X[1200:])
    assert sess.backend.delta_rows > 0
    before = sess.search(Q, 10)
    sess.save(tmp_path / "idx.bin")
    loaded = _load(tmp_path / "idx.bin", backend="torch")
    after = loaded.search(Q, 10)
    assert loaded.n == X.shape[0]
    np.testing.assert_array_equal(before.ids, after.ids)


# --------------------------------------------------------- cross-package ----
def test_wal_frames_read_across_packages(tmp_path):
    """The reference's DeltaWAL and the port's write the same bytes, and
    each reads the other's frames: equal (n_before, rows), in order."""
    rng = np.random.default_rng(9)
    frames = [(600, rng.normal(size=(5, 16)).astype(np.float32)),
              (605, rng.normal(size=(3, 16)).astype(np.float32)),
              (608, np.arange(32, dtype=np.float32).reshape(2, 16))]
    ref, port = JaxWAL(tmp_path / "ref.wal"), DeltaWAL(tmp_path / "port.wal")
    for n_before, rows in frames:
        ref.append(rows, n_before)
        port.append(rows, n_before)
    assert (tmp_path / "ref.wal").read_bytes() == \
        (tmp_path / "port.wal").read_bytes()
    for got in (DeltaWAL(ref.path).frames(), JaxWAL(port.path).frames()):
        assert [f[0] for f in got] == [f[0] for f in frames]
        for (_, a), (_, b) in zip(got, frames):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cut", [1, 11, 0.5, -1])
def test_torn_tail_gives_the_same_prefix_in_both(tmp_path, cut):
    """A log cut at the same byte length inside its last frame: both
    readers keep the same valid prefix (and warn)."""
    rng = np.random.default_rng(10)
    wal = DeltaWAL(tmp_path / "a.wal")
    wal.append(rng.normal(size=(4, 8)).astype(np.float32), 10)
    first = os.path.getsize(wal.path)
    wal.append(rng.normal(size=(6, 8)).astype(np.float32), 14)
    size = os.path.getsize(wal.path)
    keep = {1: first + 1, 11: first + 11, 0.5: (first + size) // 2,
            -1: size - 1}[cut]
    raw = open(wal.path, "rb").read()[:keep]
    open(wal.path, "wb").write(raw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mine = DeltaWAL(wal.path).frames()
        theirs = JaxWAL(wal.path).frames()
    assert len(w) == 2
    assert [f[0] for f in mine] == [f[0] for f in theirs] == [10]
    np.testing.assert_array_equal(mine[0][1], theirs[0][1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_add_crash_load_matches_reference(tmp_path, backend):
    """One script through both packages: open with a path, two adds, a
    third add torn mid-frame (never acknowledged), drop, load: the same
    rows, the reference's ids exactly and distances within rtol 1e-4."""
    X, extra, Q = _data(n=1200, d=24, seed=4)
    kw = dict(d1=24, query_chunk=4, row_block=256, block_capacity=256)

    def script(open_fn, faults_mod, load_fn, p, **okw):
        sess = open_fn(X[:1000], method="PDScanning+", path=p, **okw)
        sess.add(X[1000:1100])
        sess.add(X[1100:1150])
        with faults_mod.inject(torn_frame_keep=0.5):
            with pytest.raises(faults_mod.SimulatedCrash):
                sess.add(X[1150:])
        del sess
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            re = load_fn(p)
        return re.n, re.search(Q, 10)

    n_ref, rj = script(jax_open_index, jax_faults, JaxSession.load,
                       str(tmp_path / "ref.bin"),
                       backend="jax" if backend == "torch" else "host",
                       schedule=JaxPolicy(**kw))
    n_port, rt = script(_open, faults, _load, str(tmp_path / "port.bin"),
                        backend=backend, schedule=SchedulePolicy(**kw))
    assert n_ref == n_port == 1150
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4)


def test_reference_snapshot_is_refused_without_importing_it(tmp_path):
    """A snapshot the reference wrote pickles its own classes; the port
    refuses it with IndexLoadError and, in a process of its own, imports
    neither the reference nor jax doing so."""
    X, _, _ = _data()
    p = str(tmp_path / "ref.bin")
    jax_open_index(X, path=p)
    code = (
        "import sys\n"
        "from repro_torch.api import IndexLoadError, SearchSession\n"
        "try:\n"
        f"    SearchSession.load({p!r}, device='cpu')\n"
        "except IndexLoadError as exc:\n"
        "    print('refused:', exc.cause)\n"
        "print('imported:', any(m == 'jax' or m == 'repro' or "
        "m.startswith(('jax.', 'repro.')) for m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "refused:" in out.stdout and "reference package" in out.stdout
    assert "imported: False" in out.stdout


def _tensors(obj, seen=None) -> int:
    """Count torch tensors reachable from ``obj`` (containers, dataclasses
    and object attributes)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        return sum(_tensors(k, seen) + _tensors(v, seen)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return sum(_tensors(v, seen) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return _tensors(vars(obj), seen)
    return 0


@pytest.mark.parametrize("index", ["flat", "ivf"])
def test_snapshot_holds_no_tensor(tmp_path, index):
    """Saved after searches and a delta add (the backend then holds the
    layout and the delta blocks), the payload is numpy state only."""
    X, extra, Q = _data()
    sess = _open(X, "torch", index=index, method="PDScanning+",
                 schedule=SchedulePolicy(d1=16, row_block=256))
    sess.search(Q, 5)
    sess.add(extra[:10])
    sess.search(Q, 5)
    assert sess.backend._delta_blocks is not None
    p = _snap(tmp_path)
    sess.save(p)
    raw = open(p, "rb").read()
    payload = pickle.loads(raw[:-16])
    assert set(payload) == {"version", "method_name", "method_params",
                            "method_state", "index_kind", "index", "policy",
                            "backend"}
    assert payload["backend"] == "torch"
    assert _tensors(payload) == 0


def test_load_defaults_to_the_card(tmp_path):
    """A saved torch session loads onto the CUDA card by default: without
    one the load raises naming CUDA, and device="cpu" loads it there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default load runs on it")
    X, _, Q = _data()
    p = _snap(tmp_path)
    _open(X, "torch", path=p)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchSession.load(p)
    sess = SearchSession.load(p, device="cpu")
    assert sess.backend.device.type == "cpu"
    assert sess.search(Q, 5).ids.shape == (6, 5)
