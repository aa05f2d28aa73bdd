"""Memory-mapped columnar store of post-barycentering packed arrays
(the JAX package's ``store/packstore.py``, same file format).

The host chain that turns par files and raw TOAs into a fleet's packed
arrays (clock corrections, TDB, posvels, design-matrix prep, segment
packing) is a pure function of its inputs: the par files, the raw TOA
columns, the ephemeris/clock configuration, and the shape-plan
geometry. This store persists that output once, as one CRC-framed
columnar file per fleet bucket, so warm refits and fresh processes
``mmap`` straight into :meth:`PTABatch.from_packed` and skip the host
chain entirely.

File format (the persisted executable tier's framing)::

    PTPK | u32 manifest_len | u32 manifest_crc32 | manifest JSON
         | aligned column payloads ...

The JSON manifest carries the store identity (:func:`store_identity`:
format version, torch and CUDA versions, the card's compute
capability, ``parallel.shapeplan.PACK_GEOMETRY_VERSION``), the content
signature the entry was written under, one descriptor per array column
(dtype, shape, offset, nbytes, crc32), and the offset/crc of a pickled
"meta" region holding the non-array leaves of the pack state (static
config, free_map, plan pack tables' scalars). Columns are 64-byte
aligned. A loaded column is a read-only numpy view over the mapping;
``PTABatch._to_device`` copies each one to the device, so no view ever
reaches an in-place op.

Keying is CONTENT, not filename convention: :func:`content_signature`
hashes the par files, the raw TOA columns (day/sec/freq/error/obs,
weights and flags when present), the ephemeris + clock configuration,
the shape-plan signatures, and the bucketing options. Any divergence —
edited par file, new TOAs, different ephemeris, a torch, CUDA or
pack-geometry version bump — lands on a different signature or
identity, and a file whose embedded signature or identity disagrees
with the request is STALE: warn + delete + rebuild from live prep. A
CRC mismatch anywhere (bitrot, a torn write that somehow bypassed the
atomic rename) is CORRUPT: same handling. A bad store entry can cost
time, never correctness.

Writes go through :func:`durable.atomic_write_bytes` only (never a
truncating ``open``), with the ``store_write`` process-kill fault point
armed immediately before the atomic publish — the kill-chaos harness
proves a SIGKILL there leaves no torn artifact.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import pickle
import struct
import threading
import warnings
import zlib

import numpy as np

from ..durable import atomic_write_bytes
from ..obs import trace as obs_trace
from ..resilience import faultinject

__all__ = [
    "PackStore", "content_signature", "store_identity",
    "encode_state", "decode_state", "EntryCorrupt", "EntryStale",
    "STORE_MAGIC", "STORE_FORMAT_VERSION",
]

STORE_MAGIC = b"PTPK"
STORE_FORMAT_VERSION = 1
_STORE_HEADER = struct.Struct("<II")  # manifest length, manifest crc32
_ALIGN = 64  # column payload alignment inside the file

# sentinel key marking a numpy-column placeholder in the pickled meta
# tree; real pack-state dicts never contain it
_COL_KEY = "__ptpk_column__"


def store_identity():
    """Environment identity stamped into (and checked against) every
    entry: format version, torch version (where the JAX package stamps
    its jax version), CUDA version and the card's compute capability
    (both None without a card), and the packed-geometry version. The
    geometry version guards the silent hazard where a ShapePlan's key
    stays stable while the layout it produces moves."""
    import torch

    from ..parallel.shapeplan import PACK_GEOMETRY_VERSION

    capability = (list(torch.cuda.get_device_capability())
                  if torch.cuda.is_available() else None)
    return {"format": STORE_FORMAT_VERSION,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "capability": capability,
            "pack_geometry": PACK_GEOMETRY_VERSION}


def _digest_toas(h, toas):
    """Fold one TOAs table's raw (pre-prep) content into ``h``: the
    columns the host chain consumes, plus the ephemeris/clock config
    that selects which chain runs. Never touches derived columns
    (tdb, posvels) — the whole point is to compute the key WITHOUT
    running prep."""
    h.update(np.ascontiguousarray(toas.day).tobytes())
    h.update(np.ascontiguousarray(toas.sec).tobytes())
    h.update(np.ascontiguousarray(toas.freq_mhz).tobytes())
    h.update(np.ascontiguousarray(toas.error_us).tobytes())
    h.update("|".join(str(o) for o in toas.obs).encode())
    if toas.weights is not None:
        h.update(np.ascontiguousarray(toas.weights).tobytes())
    h.update(repr((toas.ephem, toas.planets, toas.include_gps,
                   toas.include_bipm, toas.bipm_version,
                   toas.include_site_clock,
                   tuple(toas.commands))).encode())
    # flags feed maskParameter selection; hash the packed parser blob
    # when present (cheap), else each distinct dict once and one index
    # column (a TOA table holds few distinct flag dicts). The items keep
    # their insertion order: equal dicts built in another order land on
    # another signature, a miss, never a wrong hit
    raw = getattr(toas, "_flags_raw", None)
    if raw is not None:
        for part in raw:
            h.update(part if isinstance(part, (bytes, bytearray))
                     else repr(part).encode())
    else:
        flags = getattr(toas, "_flags", None)
        if flags is not None:
            table = {}
            first = table.setdefault
            idx = [first(tuple(f.items()), len(table)) for f in flags]
            h.update(repr(list(table)).encode())
            h.update(np.asarray(idx, np.int64).tobytes())


def content_signature(models, toas_list, plans=None, **build_opts):
    """Hex signature over everything the packed arrays are a function
    of: every model's par-file serialization, every TOA table's raw
    columns and clock/ephemeris config, the shape-plan signatures, and
    the fleet bucketing options. Two fleets with equal signatures would
    build bit-identical pack states; anything else must miss. The pack
    store keys its entries on it, and the streaming lanes
    (``serve/streaming.py``) root their append-delta chains
    (``store/deltas.py``) at it.

    The environment identity (:func:`store_identity`) is deliberately
    NOT part of this hash: it is stamped into each entry and checked
    at load, so a version bump finds the old entry at the same path
    and invalidates it visibly instead of leaving an orphan on disk.
    The identities of the two packages differ (torch and CUDA versions
    here, the jax version there), so an entry this package writes is
    never read by the JAX package, nor the reverse: a shared directory
    is warned about, deleted and rebuilt, never misread."""
    h = hashlib.sha256()
    for m in models:
        h.update(m.as_parfile().encode())
        h.update(b"\x00")
    for t in toas_list:
        _digest_toas(h, t)
        h.update(b"\x00")
    if plans:
        for skey in sorted(plans, key=repr):
            h.update(repr(skey).encode())
            h.update(plans[skey].signature().encode())
    h.update(repr(sorted(build_opts.items())).encode())
    return "pack-" + h.hexdigest()[:40]


def _flatten_state(state):
    """Split a pack_state tree into (meta_tree, columns): numeric
    numpy leaves become indexed column placeholders, everything else
    stays in the (pickled) meta tree. Walks dicts/lists/tuples only —
    pack_state is built from exactly those."""
    columns = []

    def walk(node):
        if isinstance(node, np.ndarray) and node.dtype != object:
            columns.append(np.ascontiguousarray(node))
            return {_COL_KEY: len(columns) - 1}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(state), columns


def _substitute(node, arrays):
    if isinstance(node, dict):
        if _COL_KEY in node and len(node) == 1:
            return arrays[node[_COL_KEY]]
        return {k: _substitute(v, arrays) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_substitute(v, arrays) for v in node)
    return node


def _align_up(n):
    return ((n + _ALIGN - 1) // _ALIGN) * _ALIGN


_HEAD = len(STORE_MAGIC) + _STORE_HEADER.size


class EntryCorrupt(ValueError):
    """A store-format blob fails its magic, length or CRC checks."""


class EntryStale(ValueError):
    """A store-format blob is whole but was written under another
    identity or content signature."""


def encode_state(state, signature, bucket=""):
    """One pack_state tree as a ``PTPK`` blob (the file format of the
    module docstring); returns (blob, number of columns)."""
    meta_tree, columns = _flatten_state(state)
    meta_blob = pickle.dumps(meta_tree)
    descs = []
    # region offsets are relative to the start of the column area
    # (which itself starts aligned after the manifest); computed in
    # two passes because the manifest length shifts the base
    off = _align_up(len(meta_blob))
    for arr in columns:
        descs.append({"dtype": arr.dtype.str,
                      "shape": list(arr.shape),
                      "offset": off, "nbytes": arr.nbytes,
                      "crc32": zlib.crc32(arr.data)})
        off = _align_up(off + arr.nbytes)
    manifest = {
        "identity": store_identity(),
        "signature": signature,
        "bucket": bucket,
        "meta": {"offset": 0, "nbytes": len(meta_blob),
                 "crc32": zlib.crc32(meta_blob)},
        "columns": descs,
    }
    mjson = json.dumps(manifest, sort_keys=True).encode()
    base = _align_up(_HEAD + len(mjson))
    parts = [STORE_MAGIC,
             _STORE_HEADER.pack(len(mjson), zlib.crc32(mjson)),
             mjson, b"\x00" * (base - _HEAD - len(mjson)), meta_blob]
    pos = len(meta_blob)
    for arr, d in zip(columns, descs):
        parts.append(b"\x00" * (d["offset"] - pos))
        parts.append(arr.reshape(-1).view(np.uint8))
        pos = d["offset"] + d["nbytes"]
    return b"".join(parts), len(columns)


def decode_state(view, signature=None):
    """The pack_state tree of a ``PTPK`` blob (bytes or a memoryview,
    e.g. over an mmap), its array leaves read-only views into
    ``view``. Raises :class:`EntryCorrupt` on a bad magic, length or
    CRC, :class:`EntryStale` on a foreign identity or (when
    ``signature`` is given) content signature."""
    view = memoryview(view)
    size = len(view)
    if size < _HEAD:
        raise EntryCorrupt("truncated header")
    if bytes(view[:len(STORE_MAGIC)]) != STORE_MAGIC:
        raise EntryCorrupt("bad magic")
    mlen, mcrc = _STORE_HEADER.unpack(view[len(STORE_MAGIC):_HEAD])
    if _HEAD + mlen > size:
        raise EntryCorrupt("truncated manifest")
    mjson = view[_HEAD:_HEAD + mlen]
    if zlib.crc32(mjson) != mcrc:
        raise EntryCorrupt("manifest CRC mismatch")
    try:
        manifest = json.loads(bytes(mjson))
    except ValueError as e:
        raise EntryCorrupt(f"undecodable manifest ({e!r})") from None
    ident, want = manifest.get("identity"), store_identity()
    if ident != want:
        raise EntryStale(f"identity {ident} != {want}")
    if signature is not None and manifest.get("signature") != signature:
        raise EntryStale("content signature mismatch")
    base = _align_up(_HEAD + mlen)
    md = manifest["meta"]
    meta_raw = view[base + md["offset"]:base + md["offset"] + md["nbytes"]]
    if len(meta_raw) != md["nbytes"] or zlib.crc32(meta_raw) != md["crc32"]:
        raise EntryCorrupt("meta CRC mismatch")
    arrays = []
    for d in manifest["columns"]:
        lo = base + d["offset"]
        col = view[lo:lo + d["nbytes"]]
        if len(col) != d["nbytes"] or zlib.crc32(col) != d["crc32"]:
            raise EntryCorrupt(f"column {len(arrays)} CRC mismatch")
        arrays.append(np.frombuffer(col, dtype=np.dtype(d["dtype"]))
                      .reshape(d["shape"]))
    try:
        meta_tree = pickle.loads(meta_raw)
    except Exception as e:
        raise EntryCorrupt(f"undecodable meta ({e!r})") from None
    return _substitute(meta_tree, arrays)


class PackStore:
    """Disk store of :meth:`PTABatch.pack_state` snapshots, one
    mmap'd columnar file per (content signature, bucket key).

    Thread-safe: the fleet's pipelined prep workers load/put
    concurrently, and the serve bring-up prewarm thread verifies
    entries while the engine constructs — every counter/staging
    access holds ``_lock``. The mmaps themselves are read-only and
    per-call, so verified views never race the prewarm."""

    def __init__(self, directory):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.RLock()
        self._prewarmed = {}  # path -> verified state tree
        self._prewarm_thread = None
        self._mmaps = []  # keep mapped buffers alive for loaded views
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.rebuilds = 0  # miss of any flavor -> caller ran live prep
        self.corrupt = 0
        self.stale = 0
        self.prewarm_hits = 0
        self.bytes_written = 0
        self.bytes_mapped = 0

    # -- keying -------------------------------------------------------

    def _path(self, signature, bucket_key):
        digest = hashlib.sha256(
            (signature + "|" + repr(bucket_key)).encode()
        ).hexdigest()[:32]
        return os.path.join(self.directory, digest + ".ptpk")

    # -- write path ---------------------------------------------------

    def put(self, signature, bucket_key, state):
        """Persist one bucket's pack_state atomically; returns the
        byte size written. The ``store_write`` kill site fires before
        the atomic publish, so a crash there leaves the previous
        entry (or nothing) — never a torn file."""
        blob, ncols = encode_state(state, signature, repr(bucket_key))
        path = self._path(signature, bucket_key)
        with obs_trace.span("store.save", bucket=repr(bucket_key),
                            bytes=len(blob), columns=ncols):
            with self._lock:
                # die before the atomic publish: recovery sees the
                # previous good entry or a plain miss, never a tear
                faultinject.fire_kill("store_write",
                                      bucket=repr(bucket_key))
                atomic_write_bytes(path, blob)
                self.puts += 1
                self.bytes_written += len(blob)
        return len(blob)

    # -- read path ----------------------------------------------------

    def load(self, signature, bucket_key):
        """The verified pack_state for (signature, bucket_key), its
        array leaves read-only numpy views over a shared mmap — or
        None (counted as a rebuild) on miss/stale/corrupt, after
        which the caller runs live prep and normally :meth:`put`\\ s
        the result back."""
        path = self._path(signature, bucket_key)
        with obs_trace.span("store.load", bucket=repr(bucket_key)) as sp:
            self._join_prewarm()
            with self._lock:
                state = self._prewarmed.pop(path, None)
                if state is not None:
                    self.hits += 1
                    self.prewarm_hits += 1
                    sp.set(outcome="prewarm_hit")
                    return state
            state = self._load_verified(path, signature)
            with self._lock:
                if state is None:
                    self.misses += 1
                    self.rebuilds += 1
                    sp.set(outcome="miss")
                else:
                    self.hits += 1
                    sp.set(outcome="hit")
            return state

    def _load_verified(self, path, signature=None, pin=True):
        """mmap + full verification (:func:`decode_state`): magic,
        manifest CRC, identity, (optional) signature, meta CRC, every
        column CRC. Any failure warns, deletes the entry, and returns
        None. ``pin=False`` (scan) skips the keep-alive bookkeeping —
        the mapping then lives only as long as the returned views."""
        try:
            size = os.path.getsize(path)
            fh = open(path, "rb")
        except OSError:
            return None
        try:
            if size < _HEAD:
                self._discard(path, "truncated header")
                return None
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            fh.close()
        view = memoryview(mm)
        try:
            state = decode_state(view, signature)
        except EntryStale as e:
            self._stale(path, str(e))
            state = None
        except EntryCorrupt as e:
            self._discard(path, str(e))
            state = None
        except BaseException:
            view.release()
            mm.close()
            raise
        if state is None:
            view.release()
            mm.close()
            return None
        if pin:
            with self._lock:
                # the views borrow the mapping; pin it for the process
                self._mmaps.append(mm)
                self.bytes_mapped += size
        return state

    # -- prewarm ------------------------------------------------------

    def prewarm(self, background=True):
        """Verify-and-stage every entry BEFORE the first load needs
        one: the per-column CRC pass is the expensive part of a hit,
        and on a background thread it overlaps the rest of bring-up
        (journal scan, program re-capture, intake) the same way
        ``PersistentExecutableCache.prewarm`` hides the re-capture.
        ``load`` joins the worker before touching
        disk, so a half-finished prewarm is never raced. Returns the
        thread, or None when the directory is empty;
        ``background=False`` runs inline (tests)."""
        with self._lock:
            t = self._prewarm_thread
            if t is not None and t.is_alive():
                return t
            try:
                names = sorted(n for n in os.listdir(self.directory)
                               if n.endswith(".ptpk"))
            except OSError:
                names = []
            if not names:
                return None

        def work():
            with obs_trace.span("store.prewarm", entries=len(names)):
                for name in names:
                    path = os.path.join(self.directory, name)
                    with self._lock:
                        if path in self._prewarmed:
                            continue
                    state = self._load_verified(path)
                    if state is not None:
                        with self._lock:
                            self._prewarmed[path] = state

        if not background:
            work()
            return None
        t = threading.Thread(target=work, name="ptpk-prewarm",
                             daemon=True)
        with self._lock:
            self._prewarm_thread = t
        t.start()
        return t

    def _join_prewarm(self):
        # taken WITHOUT self._lock held: the worker needs the lock to
        # publish its entries
        t = self._prewarm_thread
        if t is not None and t.is_alive():
            t.join()

    # -- maintenance --------------------------------------------------

    def scan(self):
        """Classify every on-disk entry without staging it: returns
        {"entries", "valid", "corrupt_or_stale", "bytes"}. The
        kill-chaos recover leg asserts ``corrupt_or_stale == 0`` —
        a SIGKILL mid-write must never leave a torn artifact."""
        entries = valid = bad = nbytes = 0
        before = (self.corrupt, self.stale)
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.endswith(".ptpk")]
        except OSError:
            names = []
        for name in names:
            path = os.path.join(self.directory, name)
            entries += 1
            try:
                nbytes += os.path.getsize(path)
            except OSError:
                pass
            if self._load_verified(path, pin=False) is not None:
                valid += 1
            else:
                bad += 1
        with self._lock:
            # scan is a health probe, not traffic: undo its effect on
            # the corruption counters so telemetry stays causal
            self.corrupt, self.stale = before
        return {"entries": entries, "valid": valid,
                "corrupt_or_stale": bad, "bytes": nbytes}

    def _stale(self, path, why):
        with self._lock:
            self.stale += 1
        warnings.warn(
            f"pack-store entry {os.path.basename(path)} is stale "
            f"({why}); deleting and rebuilding from live prep")
        self._remove(path)

    def _discard(self, path, why):
        with self._lock:
            self.corrupt += 1
        warnings.warn(
            f"pack-store entry {os.path.basename(path)} unusable "
            f"({why}); deleting and rebuilding from live prep")
        self._remove(path)

    @staticmethod
    def _remove(path):
        try:
            os.unlink(path)
        except OSError:
            pass

    def _damage(self, signature, bucket_key, offset=0):
        """Flip one column-area byte in place (fault-injection/test
        helper) — the bitrot the per-column CRCs exist to catch."""
        path = self._path(signature, bucket_key)
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            mlen, _ = _STORE_HEADER.unpack(
                fh.read(_HEAD)[len(STORE_MAGIC):])
            pos = (_align_up(_HEAD + mlen) + offset) % max(size, 1)
            fh.seek(pos)
            byte = fh.read(1)
            fh.seek(pos)
            fh.write(bytes([byte[0] ^ 0xFF]))

    def counters(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "puts": self.puts, "rebuilds": self.rebuilds,
                    "corrupt": self.corrupt, "stale": self.stale,
                    "prewarm_hits": self.prewarm_hits,
                    "bytes_written": self.bytes_written,
                    "bytes_mapped": self.bytes_mapped}
