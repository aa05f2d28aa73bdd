"""Append-only delta segments chained to a streaming lane's base (the
JAX package's ``store/deltas.py``, same file framing and chain rules).

Append traffic — a handful of new TOAs per pulsar per epoch — must not
rewrite a lane's base. This module persists each appended batch as its
own small columnar file (the whitened design rows, residuals and error
weights the incremental GLS delta consumes — kernels/incremental.py),
content-chained to the base::

    chain_0 = <base content signature>     (store/packstore.py)
    chain_i = sha256(chain_{i-1} | rid | payload digest)[:40]

Every segment's manifest embeds its parent chain signature and its
own, so the on-disk lane state is a hash chain rooted at the base.
Verification walks the chain in sequence order: a segment whose parent
does not match the verified predecessor's chain signature — a stale
delta left over from a different base, a reordered or deleted
predecessor — invalidates VISIBLY (warn + delete it and every
successor) and the caller replays the appends or refits from scratch.
A CRC failure anywhere is CORRUPT: same handling. A bad delta can cost
a refit, never correctness.

File framing::

    PTPD | u32 manifest_len | u32 manifest_crc32 | manifest JSON
         | aligned column payloads ...

with the environment identity stamp (packstore.store_identity: format,
torch version, PACK_GEOMETRY_VERSION) checked at load, so a version
bump invalidates old chains visibly instead of silently missing.

Writes are content-addressed and idempotent: a segment's path is a
function of (lane, sequence, chain signature), so replaying an append
request after a crash re-publishes the byte-identical file instead of
forking the chain. The ``append_delta_write`` process-kill site
(resilience/faultinject.py) fires immediately before each atomic
publish.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import warnings
import zlib

import numpy as np

from ..durable import atomic_write_bytes
from ..obs import trace as obs_trace
from ..resilience import faultinject
from .packstore import store_identity

__all__ = ["DeltaStore", "chain_signature", "DELTA_MAGIC",
           "DELTA_FORMAT_VERSION"]

DELTA_MAGIC = b"PTPD"
DELTA_FORMAT_VERSION = 1
_DELTA_HEADER = struct.Struct("<II")  # manifest length, manifest crc
_ALIGN = 64

# the arrays one append segment persists, in manifest order — the
# exact inputs kernels.incremental.delta_gram consumes
_COLS = ("X", "r", "winv")


def _payload_digest(arrays):
    h = hashlib.sha256()
    for name in _COLS:
        arr = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(arr.dtype.str.encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def chain_signature(parent, arrays, rid=""):
    """The chain link for one append segment: hash of the verified
    predecessor's chain signature (the base content signature for the
    first segment), the journaled request id, and this segment's
    column payload. Folding ``rid`` in is what lets a journal replay
    of a persisted-but-uncommitted append be recognized at the chain
    tip while an INTENTIONAL duplicate payload (a different request
    appending identical TOAs) still forms a new link."""
    h = hashlib.sha256()
    h.update(parent.encode())
    h.update(str(rid).encode())
    h.update(_payload_digest(arrays).encode())
    return "delta-" + h.hexdigest()[:40]


def _align_up(n):
    return ((n + _ALIGN - 1) // _ALIGN) * _ALIGN


class DeltaStore:
    """Disk store of append-delta segments, one chained columnar file
    per ``append_toas`` batch.

    Thread-safe: serve lanes append concurrently with the bring-up
    prewarm thread verifying chains — every counter/staging access
    holds ``_lock``. Files are immutable after publish (content
    addressed), so verified reads never race a writer."""

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.RLock()
        self._prewarmed = {}  # lane digest -> verified chain list
        self._prewarm_thread = None
        self.puts = 0
        self.replays = 0  # idempotent re-publish of an existing link
        self.loads = 0
        self.stale = 0
        self.corrupt = 0
        self.prewarm_hits = 0
        self.bytes_written = 0

    # -- keying -------------------------------------------------------

    @staticmethod
    def _lane_digest(lane):
        return hashlib.sha256(str(lane).encode()).hexdigest()[:24]

    def _path(self, lane, seq, chain):
        name = (f"{self._lane_digest(lane)}-{seq:06d}-"
                f"{chain.split('-', 1)[1][:16]}.ptpd")
        return os.path.join(self.directory, name)

    # -- write path ---------------------------------------------------

    def append(self, lane, parent, arrays, rid=""):
        """Persist one append batch atomically; returns
        ``(chain_sig, replayed)``. ``parent`` is the caller's view of
        the current chain tip (the base content signature for the
        first append); ``rid`` the journaled request id.

        Exactly-once: if the lane's newest persisted link was created
        by exactly this request (same rid + payload — a journal
        replay of an append that published its delta but died before
        commit), the publish is skipped and the existing tip is
        returned with ``replayed=True``, so replay can never fork the
        chain or double-apply a delta. The ``append_delta_write``
        kill site fires before the atomic publish, so a crash there
        leaves the previous tip."""
        paths = self._chain_paths(lane)
        last = tip = None
        while paths:
            entry = self._load_verified(paths[-1])
            if entry is not None:
                last, _ = entry
                tip = last["chain"]
                break
            # the newest persisted segment is unreadable: a segment
            # published after it could never verify (its on-disk
            # predecessor is broken), so load_chain would later delete
            # the COMMITTED new link silently — post-commit data loss.
            # Treat it as the broken chain it is: invalidate the
            # unreadable tip visibly and chain to the newest verified
            # predecessor instead.
            self._invalidate_from(paths, len(paths) - 1,
                                  "unreadable chain tip")
            paths.pop()
        seq = len(paths)
        if last is not None:
            if last["chain"] == chain_signature(
                    last["parent"], arrays, last.get("rid", "")) \
                    and last.get("rid", "") == str(rid):
                with self._lock:
                    self.replays += 1
                return last["chain"], True
            if parent != tip:
                # the caller's view of the chain has diverged from disk
                raise ValueError(
                    f"append parent {parent!r} is not the lane chain "
                    f"tip {tip!r}")
        chain = chain_signature(parent, arrays, rid)
        blob = self._encode(lane, seq, parent, chain, arrays, rid)
        path = self._path(lane, seq, chain)
        with obs_trace.span("store.delta_append", lane=str(lane), seq=seq,
                            bytes=len(blob)):
            with self._lock:
                # die before the atomic publish: recovery sees the
                # previous chain tip, never a torn delta
                faultinject.fire_kill("append_delta_write",
                                      lane=str(lane), seq=seq)
                atomic_write_bytes(path, blob)
                self.puts += 1
                self.bytes_written += len(blob)
        return chain, False

    def _encode(self, lane, seq, parent, chain, arrays, rid=""):
        cols = [np.ascontiguousarray(arrays[name]) for name in _COLS]
        descs = []
        off = 0
        for name, arr in zip(_COLS, cols):
            descs.append({"name": name, "dtype": arr.dtype.str,
                          "shape": list(arr.shape), "offset": off,
                          "nbytes": arr.nbytes,
                          "crc32": zlib.crc32(arr.data)})
            off = _align_up(off + arr.nbytes)
        manifest = {
            "identity": dict(store_identity(),
                             delta_format=DELTA_FORMAT_VERSION),
            "lane": str(lane), "seq": seq, "rid": str(rid),
            "parent": parent, "chain": chain,
            "columns": descs,
        }
        mjson = json.dumps(manifest, sort_keys=True).encode()
        head = len(DELTA_MAGIC) + _DELTA_HEADER.size
        base = _align_up(head + len(mjson))
        parts = [DELTA_MAGIC,
                 _DELTA_HEADER.pack(len(mjson), zlib.crc32(mjson)),
                 mjson, b"\x00" * (base - head - len(mjson))]
        pos = 0
        for arr, d in zip(cols, descs):
            parts.append(b"\x00" * (d["offset"] - pos))
            parts.append(arr.tobytes())
            pos = d["offset"] + d["nbytes"]
        return b"".join(parts)

    def reset_lane(self, lane):
        """Drop every persisted segment for ``lane`` — the escalation
        re-root. A full refit merges the appended rows into a NEW base
        (new content signature, new linearization), so the old chain —
        rooted at the surrendered base signature — can never verify
        against the rebuilt lane; left on disk it would wedge every
        subsequent append on the parent-divergence guard. Deletion is
        visible (the standard broken-chain warning), any prewarm
        staging for the lane is discarded, and the next append roots a
        fresh chain at the merged base's signature. Restart durability
        for the merged rows then rests on the caller re-registering the
        lane over its current dataset (the journal replays only
        uncommitted appends)."""
        paths = self._chain_paths(lane)
        if paths:
            self._invalidate_from(
                paths, 0, "lane escalated to a full refit; chain "
                "re-rooted at the merged base")
        digest = self._lane_digest(lane)
        with self._lock:
            for key in [k for k in self._prewarmed if k[0] == digest]:
                del self._prewarmed[key]

    # -- read path ----------------------------------------------------

    def _chain_paths(self, lane):
        prefix = self._lane_digest(lane) + "-"
        try:
            names = sorted(n for n in os.listdir(self.directory)
                           if n.startswith(prefix)
                           and n.endswith(".ptpd"))
        except OSError:
            names = []
        return [os.path.join(self.directory, n) for n in names]

    def load_chain(self, lane, base_signature):
        """The verified delta chain for ``lane`` rooted at
        ``base_signature``: a list of ``(chain_sig, {name: array})``
        in append order. Walks the on-disk segments in sequence
        order, re-deriving each chain signature from the verified
        predecessor; the first broken link (stale parent, identity
        or CRC failure) invalidates that segment AND every successor
        visibly, and the verified prefix is returned."""
        with self._lock:
            staged = self._prewarmed.pop(
                (self._lane_digest(lane), base_signature), None)
            if staged is not None:
                self.loads += 1
                self.prewarm_hits += 1
                return staged
        chain = self._load_chain_verified(lane, base_signature)
        with self._lock:
            self.loads += 1
        return chain

    def _load_chain_verified(self, lane, base_signature):
        out = []
        parent = base_signature
        paths = self._chain_paths(lane)
        for seq, path in enumerate(paths):
            entry = self._load_verified(path)
            if entry is None:
                self._invalidate_from(paths, seq, "unreadable segment")
                break
            manifest, arrays = entry
            if manifest["seq"] != seq or manifest["parent"] != parent:
                self._invalidate_from(
                    paths, seq,
                    f"segment {seq} parent {manifest['parent']!r} != "
                    f"verified tip {parent!r}")
                break
            want = chain_signature(parent, arrays,
                                   manifest.get("rid", ""))
            if manifest["chain"] != want:
                self._invalidate_from(
                    paths, seq,
                    f"segment {seq} chain signature mismatch")
                break
            out.append((manifest["chain"], arrays))
            parent = manifest["chain"]
        return out

    def _load_verified(self, path, count=True):
        """One segment: magic, manifest CRC, identity, column CRCs.
        Returns (manifest, {name: array}) or None (counted corrupt /
        stale unless ``count=False``; the chain walker owns
        deletion)."""
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return None
        head = len(DELTA_MAGIC) + _DELTA_HEADER.size
        if len(raw) < head or raw[:len(DELTA_MAGIC)] != DELTA_MAGIC:
            self._note_bad("corrupt", count)
            return None
        mlen, mcrc = _DELTA_HEADER.unpack(raw[len(DELTA_MAGIC):head])
        mjson = raw[head:head + mlen]
        if len(mjson) != mlen or zlib.crc32(mjson) != mcrc:
            self._note_bad("corrupt", count)
            return None
        try:
            manifest = json.loads(mjson)
        except ValueError:
            self._note_bad("corrupt", count)
            return None
        ident = dict(store_identity(),
                     delta_format=DELTA_FORMAT_VERSION)
        if manifest.get("identity") != ident:
            self._note_bad("stale", count)
            return None
        base = _align_up(head + mlen)
        arrays = {}
        for d in manifest["columns"]:
            lo = base + d["offset"]
            col = raw[lo:lo + d["nbytes"]]
            if len(col) != d["nbytes"] or \
                    zlib.crc32(col) != d["crc32"]:
                self._note_bad("corrupt", count)
                return None
            arrays[d["name"]] = np.frombuffer(
                col, dtype=np.dtype(d["dtype"])
            ).reshape(d["shape"])
        return manifest, arrays

    def _note_bad(self, kind, count=True):
        if not count:
            return
        with self._lock:
            if kind == "stale":
                self.stale += 1
            else:
                self.corrupt += 1

    def _invalidate_from(self, paths, seq, why):
        names = ", ".join(os.path.basename(p) for p in paths[seq:])
        warnings.warn(
            f"delta chain broken at segment {seq} ({why}); deleting "
            f"{names} — appends replay from the journal or the lane "
            f"refits from scratch")
        for path in paths[seq:]:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- prewarm ------------------------------------------------------

    def prewarm(self, lanes, background=True):
        """Verify-and-stage the delta chains for ``lanes`` — an
        iterable of ``(lane, base_signature)`` — alongside the pack
        store's base prewarm, so the first ``load_chain`` after
        bring-up consumes staged, already-CRC'd segments. Returns the
        worker thread (None when inline or nothing to stage)."""
        lanes = list(lanes)
        if not lanes:
            return None
        with self._lock:
            t = self._prewarm_thread
            if t is not None and t.is_alive():
                return t

        def work():
            with obs_trace.span("store.delta_prewarm", lanes=len(lanes)):
                for lane, base in lanes:
                    key = (self._lane_digest(lane), base)
                    with self._lock:
                        if key in self._prewarmed:
                            continue
                    chain = self._load_chain_verified(lane, base)
                    with self._lock:
                        self._prewarmed[key] = chain

        if not background:
            work()
            return None
        t = threading.Thread(target=work, name="ptpd-prewarm",
                             daemon=True)
        with self._lock:
            self._prewarm_thread = t
        t.start()
        return t

    # -- maintenance --------------------------------------------------

    def scan(self):
        """Classify every on-disk segment without staging or deleting:
        returns {"segments", "valid", "corrupt_or_stale", "bytes"}.
        The kill-chaos recover leg asserts ``corrupt_or_stale == 0``
        — a SIGKILL mid-append must never leave a torn delta. Scan is
        a health probe, not traffic: it counts locally (count=False)
        and never touches the shared corrupt/stale counters, so
        increments from a concurrent load_chain/prewarm survive a
        scan running beside them."""
        segments = valid = bad = nbytes = 0
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.endswith(".ptpd")]
        except OSError:
            names = []
        for name in names:
            path = os.path.join(self.directory, name)
            segments += 1
            try:
                nbytes += os.path.getsize(path)
            except OSError:
                pass
            if self._load_verified(path, count=False) is not None:
                valid += 1
            else:
                bad += 1
        return {"segments": segments, "valid": valid,
                "corrupt_or_stale": bad, "bytes": nbytes}

    def counters(self):
        with self._lock:
            return {"puts": self.puts, "replays": self.replays,
                    "loads": self.loads, "stale": self.stale,
                    "corrupt": self.corrupt,
                    "prewarm_hits": self.prewarm_hits,
                    "bytes_written": self.bytes_written}
