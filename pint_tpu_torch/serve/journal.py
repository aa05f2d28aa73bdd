"""Write-ahead request journal for crash-safe serving (the JAX
package's ``serve/journal.py``, same frame format).

The serve engine loses every in-flight request when its process dies;
this journal makes the intake -> result lifecycle durable so a fresh
process can pick up exactly where the dead one stopped. The protocol
is a classic WAL with group commit:

- ``record_intake`` appends one CRC-framed record per accepted
  request (the pickled request itself rides in the record, so replay
  needs no other state).
- ``record_commit`` appends a completion record carrying the final
  status AND the result payload — the commit record IS the delivery
  point: a result exists iff its commit frame is fully on disk.
- appends are buffered; :meth:`sync` flushes and fsyncs once per
  engine flush (group commit), so durability costs one fsync per
  batch, not per request.
- ``replay`` scans the log, returns committed results (never to be
  re-emitted) and pending requests (intake with no commit — to be
  re-run; lane-independent batched fits make the re-run
  bit-identical).

Frame format: ``MAGIC | u32 payload_len | u32 crc32(payload) |
payload`` with a pickled record dict as payload. A torn tail — the
frame a power cut or SIGKILL cut mid-write — fails the length or CRC
check; the scanner stops there, warns, and truncates the file back to
the last good frame (``journal_torn_write`` injects exactly this
tear). Everything before the tear replays normally; the torn record
was never acknowledged, so dropping it is correct, not lossy.

The log is append-only: the one durable-artifact writer that
legitimately does NOT go through ``durable.py``'s atomic temp+rename
helper, because the CRC framing is its torn-write protocol.

A record is pickled with every torch tensor moved to the host first
(:func:`_dumps`), so a fresh process can unpickle the log before it
touches the card — or on a machine without one.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import threading
import warnings
import zlib

import torch

from ..resilience import faultinject

MAGIC = b"PTJR"
_HEADER = struct.Struct("<II")  # payload length, crc32(payload)

JOURNAL_VERSION = 1


class JournalReplay:
    """Result of scanning a journal: what is done, what must re-run."""

    def __init__(self, committed, pending, torn_truncated, records):
        # rid -> last commit record (status, value, telemetry)
        self.committed = committed
        # intake records (with live request objects) lacking a commit
        self.pending = pending
        self.torn_truncated = torn_truncated  # bytes dropped from tail
        self.records = records  # full decoded record stream

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"JournalReplay(committed={len(self.committed)}, "
                f"pending={len(self.pending)}, "
                f"torn_truncated={self.torn_truncated})")


class _HostPickler(pickle.Pickler):
    """Pickles a device tensor as its host copy."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _host_tensor, (obj.detach().cpu(),)
        return NotImplemented


def _host_tensor(t):
    return t


def _dumps(rec):
    """``pickle.dumps(rec)`` with every device tensor written as its
    host copy."""
    buf = io.BytesIO()
    _HostPickler(buf).dump(rec)
    return buf.getvalue()


def _scan_bytes(data):
    """Decode every whole, CRC-valid frame; stop at the first bad one.

    Returns (records, good_offset, torn): ``good_offset`` is the byte
    length of the valid prefix, ``torn`` whether trailing bytes beyond
    it exist (a torn or corrupt tail).
    """
    records = []
    off = 0
    good = 0
    n = len(data)
    while off < n:
        head_end = off + len(MAGIC) + _HEADER.size
        if data[off:off + len(MAGIC)] != MAGIC or head_end > n:
            break
        length, crc = _HEADER.unpack(data[off + len(MAGIC):head_end])
        payload = data[head_end:head_end + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break
        try:
            records.append(pickle.loads(payload))
        except Exception:
            break
        off = head_end + length
        good = off
    return records, good, good < n


class RequestJournal:
    """Append-only CRC-framed journal living in one directory.

    Thread-safe; the engine appends from client threads (intake) and
    the flusher thread (commits), and syncs once per flush.
    """

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, "journal.log")
        self._lock = threading.RLock()
        self._fh = None
        self._dirty = False
        self._intake_ids = set()
        self.appended = 0
        self.commits = 0
        self.syncs = 0
        self.torn_truncated = 0

    # -- tail recovery -------------------------------------------------

    def _recover_tail_locked(self):
        """Truncate a torn/corrupt tail before the first append, so new
        frames never land after garbage (the scanner would stop at the
        garbage and silently hide them)."""
        try:
            with open(self.path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return
        _, good, torn = _scan_bytes(data)
        if torn:
            dropped = len(data) - good
            self.torn_truncated += dropped
            warnings.warn(
                f"journal tail torn at byte {good} ({dropped} trailing "
                f"bytes dropped); truncating and replaying the valid "
                f"prefix of {self.path}")
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
                fh.flush()
                os.fsync(fh.fileno())

    def _ensure_open_locked(self):
        if self._fh is None:
            self._recover_tail_locked()
            self._fh = open(self.path, "ab")
        return self._fh

    # -- appends -------------------------------------------------------

    def _append(self, rec, kill_site=None):
        payload = _dumps(rec)
        frame = MAGIC + _HEADER.pack(len(payload), zlib.crc32(payload)) \
            + payload
        with self._lock:
            fh = self._ensure_open_locked()
            cut = faultinject.fire("journal_torn_write",
                                   rid=rec.get("rid"))
            if cut is not None:
                # land only a prefix of the frame, as a power cut
                # would: flush so the partial bytes genuinely reach
                # the OS, then stop writing this frame
                frac = float(cut.get("frac", 0.5))
                keep = max(1, min(len(frame) - 1,
                                  int(len(frame) * frac)))
                fh.write(frame[:keep])
                fh.flush()
                self._dirty = True
                return
            if kill_site is not None \
                    and faultinject.kill_armed_at(kill_site):
                # stage a mid-frame tear, make it visible to the OS,
                # then die; if the trigger declines, complete the
                # frame so the log stays whole
                half = len(frame) // 2
                fh.write(frame[:half])
                fh.flush()
                faultinject.fire_kill(kill_site, rid=rec.get("rid"))
                fh.write(frame[half:])
            else:
                fh.write(frame)
            self._dirty = True
            self.appended += 1

    def record_intake(self, request):
        """Journal an accepted request (buffered; sync() makes it
        durable). The full request object rides along so replay is
        self-contained."""
        rec = {"v": JOURNAL_VERSION, "t": "intake",
               "rid": request.request_id, "req": request}
        self._append(rec)
        with self._lock:
            self._intake_ids.add(request.request_id)

    def record_commit(self, request_id, status, value=None, reason=None,
                      telemetry=None):
        """Journal a terminal completion — THE delivery point. The
        ``mid_commit`` kill site tears this very frame."""
        rec = {"v": JOURNAL_VERSION, "t": "commit", "rid": request_id,
               "status": status, "value": value, "reason": reason,
               "telemetry": telemetry}
        self._append(rec, kill_site="mid_commit")
        with self._lock:
            self.commits += 1

    def record_marker(self, kind, **detail):
        """Journal a lifecycle marker (e.g. a recovery generation)."""
        self._append({"v": JOURNAL_VERSION, "t": kind, **detail})

    def note_intake(self, request_id):
        """Mark an id as intake-journaled without appending — recovery
        re-submits requests whose intake already rides the log, and
        every terminal outcome of a replayed request (including a
        synchronous rejection) must still be committed."""
        with self._lock:
            self._intake_ids.add(request_id)

    def has_intake(self, request_id):
        """True when this process journaled an intake for the id (so
        its completion must be committed)."""
        with self._lock:
            return request_id in self._intake_ids

    def sync(self):
        """Group commit: flush buffered frames and fsync the log. A
        no-op when nothing was appended since the last sync."""
        with self._lock:
            if self._fh is None or not self._dirty:
                return False
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._dirty = False
            self.syncs += 1
            return True

    def close(self):
        with self._lock:
            if self._fh is not None:
                self.sync()
                self._fh.close()
                self._fh = None

    # -- replay --------------------------------------------------------

    def replay(self):
        """Scan the log: committed results keyed by rid, pending
        intakes in arrival order (deduplicated — a replayed request
        re-journals its intake), torn tail truncated with a warning.
        """
        with self._lock:
            if self._fh is not None:
                self.sync()
            self._recover_tail_locked()
            try:
                with open(self.path, "rb") as fh:
                    data = fh.read()
            except FileNotFoundError:
                data = b""
        records, _, _ = _scan_bytes(data)
        committed = {}
        intakes = {}
        order = []
        for rec in records:
            kind = rec.get("t")
            rid = rec.get("rid")
            if kind == "intake":
                if rid not in intakes:
                    intakes[rid] = rec
                    order.append(rid)
            elif kind == "commit":
                committed[rid] = rec
        pending = [intakes[rid] for rid in order if rid not in committed]
        return JournalReplay(committed, pending, self.torn_truncated,
                             records)

    def counters(self):
        with self._lock:
            return {"appended": self.appended, "commits": self.commits,
                    "syncs": self.syncs,
                    "torn_truncated": self.torn_truncated}
