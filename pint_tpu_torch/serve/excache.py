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

The JAX package's persistent layer (``PersistentExecutableCache``)
waits with the durability queue (ROADMAP §1 item 3): a captured
program has no serialized form (``fitter.aot_serialize`` returns None).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..obs import trace as obs_trace

PERSISTENT_WAITS = ("the persistent executable cache waits with the "
                    "durability queue (ROADMAP §1 item 3): a captured "
                    "program has no serialized form "
                    "(fitter.aot_serialize)")


class ExecutableCache:
    """Thread-safe: prewarm_concurrent inserts while the engine thread
    serves lookups, so every access to the LRU map and its counters
    holds ``_lock`` (an RLock — prefill re-enters through insert)."""

    def __init__(self, capacity=32, persistent=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if persistent is not None:
            raise NotImplementedError(PERSISTENT_WAITS)
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._entries = OrderedDict()  # key -> shared _fns table
        self.persistent = None
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
        ``persist`` is the JAX package's write-through flag; with no
        persistent layer it has nothing to write."""
        with obs_trace.span("excache.insert", key=key):
            with self._lock:
                self._entries[key] = fns
                self._entries.move_to_end(key)
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1

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
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "size": len(self._entries),
                    "prefilled": self.prefilled,
                    "disk_hits": self.disk_hits,
                    "hit_rate": (self.hits / total) if total else None}
