"""Save/load of fitted sessions, plus the crash-safe delta WAL.

Counterpart of the reference package's ``api/persistence.py``, with the
same on-disk formats.  A snapshot is one pickle of the fitted numpy
state (method state dicts, the index, the policy and the backend's name)
followed by an integrity trailer::

    pickle payload | b"SNAP" | uint64 payload_len | uint32 crc32(payload)

verified *before* unpickling, so a bit-rotted or truncated file fails
loudly as ``IndexLoadError`` instead of unpickling garbage.  It holds no
tensor: no device layout, no block stack and no CUDA graph.
``load_session`` rebuilds the backend on ``device`` (the CUDA card
unless the caller asks for the CPU), which lays the corpus out again on
the first search.

A mesh session's files are written by rank 0 alone, and every rank waits
at a barrier until they are on disk (N ranks renaming one tmp file at
once would corrupt the snapshot); every rank reads them on load.

Dynamic inserts between snapshots are covered by :class:`DeltaWAL`
(DESIGN.md §7): a session saved to ``path`` arms an append-only log at
``path + ".wal"`` and every later ``add()`` writes its rows there —
*before* applying them, fsync'd — as one self-describing frame::

    b"DWAL" | uint32 payload_len | uint32 crc32(payload) | payload

where the payload is an npz archive of ``{n_before, rows}``.  ``n_before``
(the corpus size the frame was logged against) makes replay idempotent:
loading a snapshot replays only frames with ``n_before >= session.n``, so
a double replay — or a replay against a snapshot that already absorbed the
frame via a later ``save()`` — applies nothing twice.  A crash mid-write
leaves a torn tail frame; the reader detects it by length/CRC, drops it
with a warning, and keeps everything before it.  A torn frame was never
acknowledged to the caller (the write happens before ``add()`` returns),
so dropping it loses no acknowledged insert.  ``save()`` clears the log:
the new snapshot supersedes it.

Both the snapshot and the WAL are written *atomically with respect to
crashes* (DESIGN.md §10): ``save_session`` writes a tmp file, fsyncs it,
``os.replace``s it over the target, and fsyncs the parent directory — a
crash at any point leaves either the old snapshot or the new one, never a
half-written hybrid (``testing.FaultPlan(crash_save=...)`` injects the
worst point, after the tmp write and before the rename).  ``clear()``
empties the log the same way.  With ``SchedulePolicy(wal_max_bytes=...)``
set, the log *rotates*: once the active segment reaches the cap, later
appends open numbered segments (``.wal.0001``, ...), replayed in order
with per-segment torn-tail truncation, and ``clear()`` removes them all.

The snapshot is pickled straight into the tmp file and its checksum is
taken over the bytes as they are written, and a load checks the trailer
in a streaming pass before it unpickles from the file: neither side holds
the payload's bytes beside the arrays it encodes (about 7.7 GB for a 1M x
960 PDScanning+ state).  A snapshot written by the reference package
pickles ``repro.*`` classes; unpickling one would import that package and
jax with it, so the loader refuses any class outside the port and raises
``IndexLoadError`` naming the cause.  Load failures raise
:class:`IndexLoadError` naming the path and the likely cause, instead of
leaking pickle/OS internals.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import warnings
import zlib

import numpy as np

from repro_torch.testing import faults

FORMAT_VERSION = 1

_WAL_MAGIC = b"DWAL"
_WAL_HEADER = struct.Struct("<II")     # payload length, crc32(payload)

# snapshot integrity trailer, appended AFTER the pickle payload:
#     payload | b"SNAP" | uint64 payload_len | uint32 crc32(payload)
_SNAP_MAGIC = b"SNAP"
_SNAP_TRAILER = struct.Struct("<QI")   # payload length, crc32(payload)
_CHUNK = 1 << 26                       # streaming checksum read size

#: packages whose classes a snapshot may not name: the reference package
#: (and the jax it imports) stays out of the port's process
_FOREIGN_ROOTS = ("repro", "jax", "jaxlib")


class IndexLoadError(RuntimeError):
    """A saved index could not be loaded.  Carries the offending ``path``
    and a one-line likely cause so serving code can log/alert usefully."""

    def __init__(self, path, cause: str):
        self.path = str(path)
        self.cause = cause
        super().__init__(f"cannot load index from {self.path}: {cause}")


class _ForeignClass(pickle.UnpicklingError):
    """The snapshot names a class of a package the port does not import."""


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a snapshot without importing the reference package."""

    def find_class(self, module, name):
        if module.split(".", 1)[0] in _FOREIGN_ROOTS:
            raise _ForeignClass(f"{module}.{name}")
        return super().find_class(module, name)


class _CrcWriter:
    """A write-only file wrapper that keeps the crc32 and length of what
    passes through it (the snapshot's payload, pickled straight to disk)."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.n = 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        self.n += memoryview(b).nbytes
        return self._f.write(b)


def wal_path(path) -> str:
    """The delta-WAL file tied to snapshot ``path``."""
    return f"{path}.wal"


def _fsync_dir(dirpath) -> None:
    """fsync a directory so a rename/unlink inside it is durable (best
    effort: some filesystems refuse directory fsync — then the rename is
    only as durable as the OS makes it)."""
    fd = os.open(dirpath or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path, write, *, plan=None) -> None:
    """Write a file at ``path`` crash-atomically: ``write(f)`` fills a tmp
    file in the same directory, which is fsync'd, ``os.replace``d over
    ``path`` and followed by a parent-dir fsync.  A crash anywhere leaves
    either the old ``path`` bytes or the new ones — never a torn mix.
    ``plan`` is an optional ``testing.FaultPlan`` whose ``crash_save``
    injects the worst crash point (tmp durable, rename never issued)."""
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    faults.check_save(plan)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


class DeltaWAL:
    """Append-only, CRC-framed, fsync'd log of delta inserts (DESIGN.md §7).

    One instance per snapshot path; ``append`` is called by
    ``SearchSession.add()`` *before* the rows are applied (write-ahead), so
    an acknowledged insert is always on disk.  ``frames()`` yields the
    valid frames of the log, truncating reads at (and warning about) the
    first torn/corrupt frame of each segment.  ``clear()`` empties the log
    atomically after a snapshot.

    With ``max_bytes`` > 0 the log is *segmented*: ``path`` itself is
    segment 0 and appends that find the active segment at or over the cap
    open the next numbered segment (``{path}.0001``, ``{path}.0002``, ...).
    Replay walks segments in order — the per-frame ``n_before`` guard keeps
    it idempotent regardless — so ``health()`` can bound WAL disk usage via
    :meth:`total_bytes` while no single file grows without limit between
    snapshots.

    ``writer=False`` (a mesh rank other than 0) reads the log but never
    writes it: appends, clears and the torn-tail truncation are left to
    the writer.
    """

    def __init__(self, path, *, max_bytes: int = 0, writer: bool = True):
        self.path = str(path)
        self.max_bytes = int(max_bytes or 0)
        self.writer = writer

    # -- segments -------------------------------------------------------------
    def _segments(self) -> list[str]:
        """Existing segment paths in append/replay order: the base path
        (segment 0) first, then numbered rotations sorted numerically."""
        segs: list[str] = []
        if os.path.exists(self.path):
            segs.append(self.path)
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + "."
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            names = []
        numbered = [(int(nm[len(base):]), os.path.join(d, nm))
                    for nm in names
                    if nm.startswith(base) and nm[len(base):].isdigit()]
        segs.extend(p for _, p in sorted(numbered))
        return segs

    def _active_path(self) -> str:
        """The segment the next append lands in (rotating past a full
        one when ``max_bytes`` caps segment size)."""
        segs = self._segments()
        if not segs:
            return self.path
        last = segs[-1]
        if self.max_bytes > 0 and os.path.getsize(last) >= self.max_bytes:
            nxt = 1 if last == self.path else int(last.rsplit(".", 1)[1]) + 1
            return f"{self.path}.{nxt:04d}"
        return last

    # -- write ----------------------------------------------------------------
    def append(self, rows: np.ndarray, n_before: int, *, plan=None) -> None:
        """Frame ``rows`` (inserted when the corpus held ``n_before``
        vectors) and fsync it.  ``plan`` is an optional
        ``testing.FaultPlan`` whose ``torn_frame_keep`` simulates power
        loss mid-write: the frame's byte prefix is written and
        ``SimulatedCrash`` raised, so the caller never acknowledges."""
        if not self.writer:
            return
        buf = io.BytesIO()
        np.savez(buf, n_before=np.int64(n_before),
                 rows=np.ascontiguousarray(rows, np.float32))
        payload = buf.getvalue()
        frame = (_WAL_MAGIC + _WAL_HEADER.pack(len(payload),
                                               zlib.crc32(payload)) + payload)
        out, crash = faults.torn_frame(plan, frame)
        target = self._active_path()
        with open(target, "ab") as f:
            f.write(out)
            f.flush()
            os.fsync(f.fileno())
        if crash:
            raise faults.SimulatedCrash(
                f"injected crash mid-WAL-frame: wrote {len(out)} of "
                f"{len(frame)} bytes to {target}")

    # -- read -----------------------------------------------------------------
    def _scan(self, path=None) -> tuple[list[tuple[int, np.ndarray]],
                                        int, int]:
        """Parse one segment (default: the base): (valid frames, bytes of
        valid prefix, file size).  A torn or corrupt tail warns — never a
        crash — because a torn frame was by construction never
        acknowledged."""
        path = self.path if path is None else str(path)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return [], 0, 0
        out: list[tuple[int, np.ndarray]] = []
        off, hdr = 0, _WAL_HEADER.size
        while off < len(data):
            head = data[off:off + 4 + hdr]
            if len(head) < 4 + hdr or head[:4] != _WAL_MAGIC:
                warnings.warn(
                    f"delta WAL {path}: torn/garbled frame header at "
                    f"byte {off}; dropping the unacknowledged tail "
                    f"({len(data) - off} bytes)", stacklevel=3)
                break
            ln, crc = _WAL_HEADER.unpack(head[4:])
            payload = data[off + 4 + hdr: off + 4 + hdr + ln]
            if len(payload) < ln or zlib.crc32(payload) != crc:
                warnings.warn(
                    f"delta WAL {path}: frame at byte {off} fails "
                    f"length/CRC (torn write); dropping the unacknowledged "
                    f"tail ({len(data) - off} bytes)", stacklevel=3)
                break
            with np.load(io.BytesIO(payload)) as z:
                out.append((int(z["n_before"]), np.asarray(z["rows"],
                                                          np.float32)))
            off += 4 + hdr + ln
        return out, off, len(data)

    def frames(self) -> list[tuple[int, np.ndarray]]:
        """The valid ``(n_before, rows)`` frames across all segments, in
        log order (each segment's torn tail dropped with a warning)."""
        out: list[tuple[int, np.ndarray]] = []
        for seg in self._segments() or [self.path]:
            out.extend(self._scan(seg)[0])
        return out

    def total_bytes(self) -> int:
        """On-disk size of the log, summed over every segment (surfaced in
        ``SearchService.health()`` as ``wal_bytes``)."""
        return sum(os.path.getsize(seg) for seg in self._segments())

    def clear(self) -> None:
        """Empty the log (a fresh snapshot supersedes every frame):
        numbered segments are unlinked, the base segment is emptied via the
        same tmp + ``os.replace`` + dir-fsync dance as the snapshot — a
        crash mid-clear leaves either the old log (harmless: replay is
        idempotent) or the empty one, never a torn file."""
        if not self.writer:
            return
        for seg in self._segments():
            if seg != self.path:
                os.remove(seg)
        _atomic_write(self.path, lambda f: None)

    def replay(self, session) -> int:
        """Apply, segment by segment in order, every frame not already
        reflected in ``session`` (frames with ``n_before < session.n`` are
        skipped — that is what makes a double replay a no-op), then
        truncate each segment's torn tail so the *next* ``append`` lands on
        a frame boundary instead of behind garbage.  Returns rows
        applied."""
        frames: list[tuple[int, np.ndarray]] = []
        for seg in self._segments() or [self.path]:
            seg_frames, valid_end, size = self._scan(seg)
            if valid_end < size and self.writer:   # torn tail: cut the
                # segment back to the last acknowledged frame
                with open(seg, "rb+") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())
            frames.extend(seg_frames)
        applied = 0
        for n_before, rows in frames:
            if n_before < session.n:
                continue               # snapshot or earlier replay has it
            if not np.isfinite(rows).all():
                # a frame that passed CRC but holds NaN/Inf rows was logged
                # by a writer without add()'s finiteness gate (or corrupted
                # in a CRC-colliding way): applying it would poison every
                # distance against those rows, so skip it loudly instead
                warnings.warn(
                    f"delta WAL {self.path}: frame logged at n_before="
                    f"{n_before} contains non-finite rows "
                    f"({rows.shape[0]} rows); skipping it — re-add the "
                    "data through SearchSession.add(), which validates",
                    stacklevel=2)
                continue
            session._apply_add(rows)
            applied += rows.shape[0]
        return applied


def _wal_for(path, session) -> DeltaWAL:
    """The WAL armed for snapshot ``path``, honoring the policy's
    ``wal_max_bytes`` rotation knob (0/absent = single segment); written
    by rank 0 alone on a mesh."""
    return DeltaWAL(wal_path(path),
                    max_bytes=getattr(session.policy, "wal_max_bytes", 0) or 0,
                    writer=_writes(session))


def _writes(session) -> bool:
    """Whether this process writes the session's files: always, but on a
    mesh only rank 0."""
    if session.mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def save_session(session, path) -> None:
    """Pickle a session's fitted method state, index, policy and backend
    name — with a crc32 integrity trailer so a later load can prove the
    bytes are the ones written — then arm the delta WAL at
    ``path + ".wal"`` (clearing any previous log; this snapshot includes
    everything) so later ``add()`` calls are crash-safe.

    The write is crash-atomic (tmp + ``os.replace`` + dir fsync): until
    the rename lands, the previous snapshot AND its un-cleared WAL are
    intact on disk, so a crash mid-save (``FaultPlan(crash_save=...)``)
    loses nothing — the old state reloads, delta frames and all."""
    payload = {
        "version": FORMAT_VERSION,
        "method_name": session.method.name,
        "method_params": session.method.params,
        "method_state": session.method.state,
        "index_kind": session.index_kind,
        "index": session.index,
        "policy": session.policy,
        "backend": session.backend.name,
    }

    def write(f):
        body = _CrcWriter(f)
        pickle.dump(payload, body, protocol=pickle.HIGHEST_PROTOCOL)
        f.write(_SNAP_MAGIC + _SNAP_TRAILER.pack(body.n, body.crc))

    from repro_torch.api.session import _mesh_barrier

    if _writes(session):
        _atomic_write(path, write, plan=faults.active(session.policy))
    session.wal = _wal_for(path, session)
    session.wal.clear()
    _mesh_barrier(session)


def _read_payload(path, f):
    """Check the trailer of the open snapshot ``f`` over its body in a
    streaming pass, then unpickle the body from the file."""
    size = os.fstat(f.fileno()).st_size
    tlen = len(_SNAP_MAGIC) + _SNAP_TRAILER.size
    tail = b""
    if size >= tlen:
        f.seek(size - tlen)
        tail = f.read(tlen)
    if tail[:len(_SNAP_MAGIC)] != _SNAP_MAGIC:
        raise IndexLoadError(
            path, "missing integrity trailer (truncated snapshot, or not "
            "written by save_session)")
    ln, crc = _SNAP_TRAILER.unpack(tail[len(_SNAP_MAGIC):])
    f.seek(0)
    got, left = 0, size - tlen
    while left:
        chunk = f.read(min(_CHUNK, left))
        got = zlib.crc32(chunk, got)
        left -= len(chunk)
    if ln != size - tlen or got != crc:
        raise IndexLoadError(
            path, f"snapshot checksum mismatch (trailer says {ln} payload "
            f"bytes, crc32 {crc:#010x}; file holds {size - tlen} bytes, "
            f"crc32 {got:#010x}) — the snapshot was corrupted "
            "after it was written; restore from a good copy")
    f.seek(0)
    try:
        return _PortUnpickler(f).load()
    except _ForeignClass as exc:
        raise IndexLoadError(
            path, f"the snapshot names {exc}, a class of the reference "
            "package, which this package does not import (it would bring "
            "jax with it); re-save the index from repro_torch") from None
    except (pickle.UnpicklingError, EOFError, AttributeError,
            ImportError, IndexError) as exc:
        raise IndexLoadError(
            path, f"not a readable session snapshot (foreign file? "
            f"unpickling failed with {type(exc).__name__}: {exc})",
        ) from exc


def load_session(path, *, backend: str | None = None, device=None,
                 mesh=None):
    """Rebuild a ``SearchSession`` from :func:`save_session` output on
    ``device`` (default: the CUDA card; ``device="cpu"`` runs the plain
    versions on the CPU), sharded over ``mesh`` when one is given (every
    rank reads), then replay its delta WAL (inserts since the snapshot).
    ``backend`` overrides the saved backend's name.  Raises
    :class:`IndexLoadError` on any unreadable/unsupported snapshot."""
    from repro_torch.api.session import SearchSession, _mesh_barrier
    from repro_torch.core.methods import make_method

    try:
        with open(path, "rb") as f:
            payload = _read_payload(path, f)
    except FileNotFoundError:
        raise IndexLoadError(path, "file does not exist") from None
    if not isinstance(payload, dict) or "method_name" not in payload:
        raise IndexLoadError(
            path, "pickle payload is not a session snapshot")
    if payload.get("version") != FORMAT_VERSION:
        raise IndexLoadError(
            path, f"snapshot format version {payload.get('version')!r} is "
            f"not supported (this build reads version {FORMAT_VERSION}; "
            "re-save with the matching release)")
    m = make_method(payload["method_name"], **payload["method_params"])
    m.state = payload["method_state"]          # fitted state, no refit
    sess = SearchSession(m, payload["policy"],
                         index_kind=payload["index_kind"],
                         index=payload["index"],
                         backend=backend or payload["backend"], device=device,
                         mesh=mesh)
    sess.wal = _wal_for(path, sess)
    sess.wal.replay(sess)
    _mesh_barrier(sess)
    return sess
