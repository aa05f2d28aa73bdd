"""Executable cache: LRU of warm program tables keyed by the full
executable signature (slot key + lane count + shape fingerprint, plus
the shape plan's stable signature when the engine serves a planned
width ladder — see ServeEngine._exec_key — so entries built under
different plans never collide). The JAX package's
``serve/excache.py::ExecutableCache``.

PTABatch keeps its programs in a per-instance ``_fns`` dict; serving
builds a fresh PTABatch per flush, which would capture everything
again. A cache entry IS a shared ``_fns`` table: on a hit the new batch
adopts the cached table, and each program in it runs on the data of
the batch that calls it (``graphs.py``: a captured program copies the
caller's tensors into the ones its graphs read), so a warm slot serves
any pulsars of its signature with no new capture. On a miss the new
batch's own table is inserted and whatever it builds becomes warm for
the next same-signature flush — including programs built later through
the same table, e.g. the f64 fallback a degraded mixed fit adds.

Evicting an entry drops the cache's reference to its table; once no
batch holds the table either, its captured programs are freed, and
with the last program on a device its graph memory pool
(``graphs.pool``).

The optional persistent layer (:class:`PersistentExecutableCache`)
extends the same signatures to disk, so a FRESH PROCESS reaches its
first result without a capture on its critical path. The JAX package
persists serialized executables; a captured CUDA graph has no
serialized form (its kernels' arguments are one process's device
addresses, ``fitter.aot_serialize``), so this tier persists what a
fresh process needs to capture the same program table again before
the first lookup: the executable key, the program keys with their
``aot_compile`` options, and the lane-padded batch the programs were
captured on (its ``pack_state()`` in the pack store's columnar format,
with its template model's par text). Any mismatch (CRC, format
version, torch/CUDA version, device, key) warns and captures anew; a
corrupt cache can cost time, never correctness.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
import threading
import warnings
import zlib
from collections import OrderedDict

from ..durable import atomic_write_bytes
from ..obs import clock as obs_clock
from ..obs import trace as obs_trace
from ..resilience import faultinject


class ExecutableCache:
    """Thread-safe: prewarm_concurrent inserts while the engine thread
    serves lookups, so every access to the LRU map and its counters
    holds ``_lock`` (an RLock — prefill re-enters through insert)."""

    def __init__(self, capacity=32, persistent=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._entries = OrderedDict()  # key -> shared _fns table
        self.persistent = persistent  # PersistentExecutableCache or None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefilled = 0
        self.disk_hits = 0

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def keys(self):
        with self._lock:
            return list(self._entries)

    def lookup(self, key):
        """The fns table for key (LRU-refreshed) or None; counts
        hit/miss."""
        with obs_trace.span("excache.lookup", key=key) as sp:
            with self._lock:
                fns = self._entries.get(key)
                if fns is None:
                    self.misses += 1
                    if self.persistent is not None:
                        fns = self.persistent.load(key)
                        if fns is not None:
                            # re-captured from disk: adopt into the LRU
                            # without re-persisting what we just read
                            self.disk_hits += 1
                            self.insert(key, fns, persist=False)
                            sp.set(outcome="disk_hit")
                            return fns
                    sp.set(outcome="miss")
                    return None
                self._entries.move_to_end(key)
                self.hits += 1
                sp.set(outcome="hit")
                return fns

    def insert(self, key, fns, persist=True):
        """Insert (or refresh) a program table, evicting
        least-recently-used entries over capacity. Dropping an entry
        drops the cache's reference to its programs, so evicted CUDA
        graphs are freed once no batch holds them, not just forgotten.
        Writes through to the persistent layer (when one is attached)
        whatever :meth:`PersistentExecutableCache.stage` staged for
        ``key``."""
        with obs_trace.span("excache.insert", key=key):
            with self._lock:
                self._entries[key] = fns
                self._entries.move_to_end(key)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
                if persist and self.persistent is not None:
                    self.persistent.store(key, fns)

    def prefill(self, entries):
        """Warm-start bulk insert of (key, fns) pairs —
        ServeEngine.prewarm_concurrent / prefill_from_fleet drive real
        captures through this for the most common shapes before traffic
        arrives. Returns the number of entries inserted and counts them
        in ``prefilled`` (separate from hit/miss so steady-state
        telemetry stays clean)."""
        with self._lock:
            n = 0
            for key, fns in entries:
                self.insert(key, fns)
                n += 1
            self.prefilled += n
            return n

    def reset_counters(self):
        with self._lock:
            self.hits = self.misses = self.evictions = 0

    def counters(self):
        with self._lock:
            total = self.hits + self.misses
            out = {"hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions,
                   "size": len(self._entries),
                   "prefilled": self.prefilled,
                   "disk_hits": self.disk_hits,
                   "hit_rate": (self.hits / total) if total else None}
            if self.persistent is not None:
                out["disk"] = self.persistent.counters()
            return out


# -- persistent layer --------------------------------------------------

PERSIST_MAGIC = b"PTEX"
PERSIST_FORMAT_VERSION = 1
_PERSIST_HEADER = struct.Struct("<II")  # payload length, crc32


def _device_identity(device):
    """(device name, compute capability) of ``device``: the card's, or
    ("cpu", None)."""
    import torch

    if device.type != "cuda":
        return "cpu", None
    return (torch.cuda.get_device_name(device),
            list(torch.cuda.get_device_capability(device)))


class PersistentExecutableCache:
    """Disk tier of program tables, one identity-stamped file per
    executable signature, re-captured in a fresh process.

    File format (the JAX package's framing): ``PTEX | u32 len | u32
    crc32 | payload`` where the payload is a pickled document
    {"identity", "programs": {program_key: aot_compile options},
    "template_par", "pack"}: ``pack`` is the lane-padded batch's
    ``pack_state()`` as a pack-store blob (``store.packstore``,
    CRC-per-column), ``template_par`` its template model's par text.
    The identity holds the repr of the cache key, the format version,
    the torch and CUDA versions, the device's name and compute
    capability and ``PACK_GEOMETRY_VERSION`` — any mismatch is a STALE
    entry (the ``executable_cache_corrupt`` fault injects the bitrot
    case), handled by warn + delete + capture anew.

    A capture must run its program once on valid data, which is why an
    entry holds a real batch rather than shapes alone. :meth:`prewarm`
    rebuilds each entry's batch (``PTABatch.from_packed``) and captures
    its programs (``aot_compile``) on a background thread while the
    process does the rest of its bring-up (journal scan, state
    restore, intake); :meth:`load` joins that thread and hands out the
    captured table. Tables with no fit program (resid/phase slots run
    eagerly) are not persisted. An entry is written on a cache miss
    only — after a capture, never on a warm flush; ``store_s`` and
    ``bytes_written`` in :meth:`counters` price the writes.

    :meth:`store` keeps the JAX package's ``store(key, fns)``: what it
    writes for ``key`` — the batch and the programs' options, which a
    program table does not hold — is handed over first by
    :meth:`stage` (the serve engine stages each slot it captures).
    """

    def __init__(self, directory, device="cuda"):
        from .. import resolve_device

        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.device = resolve_device(device)
        # the card's index as the constructing thread sees it (a plain
        # "cuda" device names the current card), for the prewarm thread
        self._card = None
        if self.device.type == "cuda":
            import torch

            self._card = (self.device.index if self.device.index is not None
                          else torch.cuda.current_device())
        self._lock = threading.RLock()
        self._prewarmed = {}  # path -> re-captured fns table
        self._staged = {}  # key -> (batch, {program key: options})
        self._prewarm_thread = None
        self.stores = 0
        self.loads = 0
        self.load_misses = 0
        self.corrupt = 0
        self.stale = 0
        self.prewarm_hits = 0
        self.recaptures = 0
        self.bytes_written = 0
        self.store_s = 0.0
        self.recapture_s = 0.0

    def _environment(self):
        """The identity fields every entry must match besides its key."""
        import torch

        from ..parallel.shapeplan import PACK_GEOMETRY_VERSION

        name, capability = _device_identity(self.device)
        return {"format": PERSIST_FORMAT_VERSION,
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "device_name": name, "capability": capability,
                "pack_geometry": PACK_GEOMETRY_VERSION}

    def identity(self, key):
        return {"key_repr": repr(key), **self._environment()}

    def _path(self, key):
        ident = self.identity(key)
        digest = hashlib.sha256(
            "|".join(str(ident[k]) for k in sorted(ident))
            .encode()).hexdigest()[:32]
        return os.path.join(self.directory, digest + ".pex")

    def stage(self, key, batch, programs):
        """Hand over what :meth:`store` persists for ``key``: ``batch``,
        the lane-padded batch the table's programs were captured on, and
        ``programs``, {program key: ``aot_compile`` options} of its fit
        programs (None or empty: nothing to persist)."""
        with self._lock:
            self._staged[key] = (batch, programs)

    def store(self, key, fns):
        """Persist the entry of ``key`` atomically: the fit programs
        :meth:`stage` named (those present in ``fns``), their
        ``aot_compile`` options and the batch they were captured on.
        Returns the number of programs persisted (0 means nothing to
        re-capture — no file is written)."""
        from ..store.packstore import encode_state

        with self._lock:
            batch, programs = self._staged.pop(key, (None, None))
        progs = {pk: dict(opts) for pk, opts in (programs or {}).items()
                 if pk in fns}
        if batch is None or not progs:
            return 0
        t0 = obs_clock.now()
        with obs_trace.span("excache.persist_store", key=key,
                            programs=len(progs)):
            pack, _ = encode_state(batch.pack_state(), repr(key))
            payload = pickle.dumps(
                {"identity": self.identity(key), "programs": progs,
                 "template_par": batch.template.as_parfile(),
                 "pack": pack}, protocol=pickle.HIGHEST_PROTOCOL)
            del pack
            blob = PERSIST_MAGIC + _PERSIST_HEADER.pack(
                len(payload), zlib.crc32(payload)) + payload
            path = self._path(key)
            with self._lock:
                # die before the atomic publish: the entry is simply
                # absent on recovery and gets captured anew
                faultinject.fire_kill("excache_store", key=repr(key))
                atomic_write_bytes(path, blob)
                self.stores += 1
                self.bytes_written += len(blob)
                self.store_s += obs_clock.now() - t0
                hit = faultinject.fire("executable_cache_corrupt",
                                       key=repr(key))
                if hit is not None:
                    self._damage(path, int(hit.get("offset", 0)))
        return len(progs)

    def _damage(self, path, offset=0):
        """Flip one payload byte in place (fault-injection helper) —
        the on-disk bitrot the CRC exists to catch."""
        size = os.path.getsize(path)
        pos = (len(PERSIST_MAGIC) + _PERSIST_HEADER.size
               + offset) % max(size, 1)
        with open(path, "r+b") as fh:
            fh.seek(pos)
            byte = fh.read(1)
            fh.seek(pos)
            fh.write(bytes([byte[0] ^ 0xFF]))

    def _recapture(self, path, doc):
        """The program table of a decoded entry, captured anew on its
        rebuilt batch, or None (warned, entry deleted) when the entry
        cannot be rebuilt."""
        from ..models import get_model
        from ..parallel.pta import PTABatch
        from ..store.packstore import EntryCorrupt, EntryStale, decode_state

        t0 = obs_clock.now()
        try:
            state = decode_state(doc["pack"])
        except EntryStale as e:
            self._stale(path, str(e))
            return None
        except EntryCorrupt as e:
            self._discard(path, f"batch {e}")
            return None
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                template = get_model(doc["template_par"])
            batch = PTABatch.from_packed(template, state,
                                         device=self.device)
            for prog_key, opts in doc["programs"].items():
                batch.aot_compile(**opts)
                if prog_key not in batch._fns:
                    raise KeyError(f"options {opts} build another "
                                   f"program than {prog_key!r}")
        except Exception as e:
            self._discard(path, f"re-capture failed ({e!r})")
            return None
        with self._lock:
            self.recaptures += 1
            self.recapture_s += obs_clock.now() - t0
        return batch._fns

    def _read(self, path):
        """(decoded document or None, absent?)."""
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except FileNotFoundError:
            return None, True
        except OSError:
            return None, False
        return self._decode(path, blob), False

    def prewarm(self, background=True):
        """Start re-capturing every persisted entry into a staging map
        BEFORE the first lookup needs one. Run on a background thread,
        the rebuild and capture overlap the restart work a fresh
        process does anyway (journal scan, state restore, request
        intake, input packing). ``load`` joins the worker before
        consulting disk, so a half-finished prewarm is never raced.

        No-op (returns None) when the directory holds no entries;
        otherwise returns the worker thread (already-finished work is
        not redone). ``background=False`` runs inline, for tests."""
        with self._lock:
            t = self._prewarm_thread
            if t is not None and t.is_alive():
                return t
            try:
                names = sorted(n for n in os.listdir(self.directory)
                               if n.endswith(".pex"))
            except OSError:
                names = []
            if not names:
                return None

        def work():
            if self._card is not None:
                # the re-capture runs on this thread: make the tier's
                # card its current device
                import torch

                torch.cuda.set_device(self._card)
            for name in names:
                path = os.path.join(self.directory, name)
                with self._lock:
                    if path in self._prewarmed:
                        continue
                doc, _ = self._read(path)
                if doc is None:
                    continue
                fns = self._recapture(path, doc)
                if fns is not None:
                    with self._lock:
                        self._prewarmed[path] = fns

        if not background:
            work()
            return None
        t = threading.Thread(target=work, name="pex-prewarm",
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

    def load(self, key):
        """The program table for ``key`` re-captured from disk, or
        None. Every failure mode — missing file, bad magic/CRC, stale
        identity, a batch that fails its checks or its capture — warns
        (except the plain miss) and returns None so the caller captures
        anew."""
        path = self._path(key)
        with obs_trace.span("excache.persist_load", key=key) as sp:
            self._join_prewarm()
            with self._lock:
                self.loads += 1
                fns = self._prewarmed.pop(path, None)
                if fns is not None:
                    self.prewarm_hits += 1
                    sp.set(outcome="prewarm_hit", programs=len(fns))
                    return fns
            doc, absent = self._read(path)
            if doc is None:
                if absent:
                    with self._lock:
                        self.load_misses += 1
                sp.set(outcome="absent" if absent else "corrupt")
                return None
            fns = self._recapture(path, doc)
            sp.set(outcome="hit" if fns is not None else "stale")
            return fns

    def _decode(self, path, blob):
        head = len(PERSIST_MAGIC) + _PERSIST_HEADER.size
        if blob[:len(PERSIST_MAGIC)] != PERSIST_MAGIC or len(blob) < head:
            self._discard(path, "bad magic/truncated header")
            return None
        length, crc = _PERSIST_HEADER.unpack(
            blob[len(PERSIST_MAGIC):head])
        payload = blob[head:head + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            self._discard(path, "CRC mismatch")
            return None
        try:
            doc = pickle.loads(payload)
        except Exception as e:
            self._discard(path, f"undecodable payload ({e!r})")
            return None
        # identity re-derived locally: the sha-keyed filename already
        # partitions on it, but a renamed or stale file must still be
        # refused explicitly
        try:
            ident = doc.get("identity", {})
            got = {k: ident.get(k) for k in self._environment()}
        except AttributeError:
            self._discard(path, "malformed document")
            return None
        want = self._environment()
        if got != want:
            with self._lock:
                self.stale += 1
            warnings.warn(
                f"persisted executable {os.path.basename(path)} is "
                f"stale ({got} != {want}); capturing anew")
            self._remove(path)
            return None
        return doc

    def _stale(self, path, why):
        with self._lock:
            self.stale += 1
        warnings.warn(
            f"persisted executable {os.path.basename(path)} is stale "
            f"({why}); deleting and capturing anew")
        self._remove(path)

    def _discard(self, path, why):
        with self._lock:
            self.corrupt += 1
        warnings.warn(
            f"persisted executable {os.path.basename(path)} unusable "
            f"({why}); deleting and capturing anew")
        self._remove(path)

    @staticmethod
    def _remove(path):
        try:
            os.unlink(path)
        except OSError:
            pass

    def counters(self):
        with self._lock:
            return {"stores": self.stores, "loads": self.loads,
                    "load_misses": self.load_misses,
                    "corrupt": self.corrupt, "stale": self.stale,
                    "prewarm_hits": self.prewarm_hits,
                    "recaptures": self.recaptures,
                    "bytes_written": self.bytes_written,
                    "store_s": self.store_s,
                    "recapture_s": self.recapture_s}
