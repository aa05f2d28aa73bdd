"""Dynamic micro-batcher: admit requests into pow2-bucketed slots,
flush on batch-full or a max-latency timer — the prompt-batching
pattern of inference serving applied to timing requests (the JAX
package's ``serve/batcher.py``).

A slot key is everything that must match for two requests to share
one compiled executable: the PTABatch structure signature, the TOA
bucket the request pads into, and the resolved routing
(kind, method, maxiter, precision). The default bucket ladder is the
pow2 convention of PTAFleet.toa_bucket="pow2" (parallel/pta.py) with
a configurable floor; passing a ``plan`` (parallel/shapeplan.py
ShapePlan) replaces it with the plan's optimized width ladder —
smallest planned width that fits, pow2 fallback above the ladder.
Unlike PTAFleet — which pads each offline batch to its own max
count — the serve path pads to the bucket BOUNDARY
(PTABatch(pad_toas=...)), so every flush of a slot presents identical
shapes and the executable cache can do its job. ``pow2_bucket`` is
also the convention ``PTAFleet(toa_bucket="pow2")`` keys its buckets
on (through ``parallel/shapeplan.py::pow2_width``), which is what lets
``ServeEngine.prefill_from_fleet`` adopt a fleet's programs. Serve slots never
segment-pack multiple pulsars into one row (requests arrive one
pulsar at a time and lanes are the batching axis); the plan
contributes its ladder widths and its signature, not its row packing.

The batcher holds no clock of its own: the engine passes timestamps
in, which keeps flush-on-timer deterministic under test clocks.
"""

from __future__ import annotations

import threading

from ..obs import trace as obs_trace


def pow2_bucket(n, floor=256):
    """Smallest power-of-two >= n, starting at ``floor`` (PTAFleet's
    pow2 convention; the floor is configurable so CPU tests and
    benches can keep padding cheap)."""
    b = int(floor)
    while b < n:
        b *= 2
    return b


class MicroBatcher:
    def __init__(self, max_batch=8, max_latency_s=0.05,
                 bucket_floor=256, plan=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_latency_s = float(max_latency_s)
        self.bucket_floor = int(bucket_floor)
        self.plan = plan  # optional shapeplan.ShapePlan width ladder
        self._lock = threading.RLock()
        # key -> list[(request, result, t_submit, trace_id)]
        self._slots = {}

    def bucket_for(self, n):
        """TOA bucket for a request of ``n`` TOAs: the shape plan's
        ladder when one is set (smallest planned width that fits,
        pow2 above the ladder), else the legacy pow2 ladder."""
        if self.plan is not None:
            return int(self.plan.width_for(int(n)))
        return pow2_bucket(n, self.bucket_floor)

    def slot_key(self, request, routing):
        """(structure_key, toa_bucket, kind, method, maxiter,
        precision) — requests with equal keys can share one
        executable."""
        from ..parallel.pta import PTABatch

        kind, method, maxiter, precision = routing
        return (PTABatch.structure_key(request.model),
                self.bucket_for(len(request.toas)),
                kind, method, maxiter, precision)

    def depth(self):
        """Total queued requests across all slots."""
        with self._lock:
            return sum(len(v) for v in self._slots.values())

    def admit(self, key, request, result, now, trace=None):
        """Queue one request; True when the slot just reached
        max_batch and must flush. ``trace`` is the request's lifecycle
        trace id (obs.reqlife) riding the slot into the flush span.
        Submitter threads race the engine's flush loop on ``_slots``,
        hence the lock."""
        with self._lock:
            entries = self._slots.setdefault(key, [])
            entries.append((request, result, now, trace))
            return len(entries) >= self.max_batch

    def admit_bounded(self, key, request, result, now, max_queue,
                      trace=None):
        """Depth-checked admit: one atomic decision under the lock
        that owns ``_slots``, so concurrent submitters cannot both
        pass a stale depth check and overfill the queue (the
        check-then-act race of checking ``depth()`` first and
        admitting second). Returns ``(admitted, full, depth)``:
        admitted False means the queue was already at ``max_queue``
        and the caller must shed; ``depth`` is the queued total AFTER
        this decision (the shed detail's observed depth on refusal,
        the new depth on admit); ``full`` mirrors :meth:`admit`."""
        with self._lock:
            depth = sum(len(v) for v in self._slots.values())
            if depth >= int(max_queue):
                return False, False, depth
            entries = self._slots.setdefault(key, [])
            entries.append((request, result, now, trace))
            return True, len(entries) >= self.max_batch, depth + 1

    def due(self, now):
        """Slot keys whose OLDEST entry has waited >= max_latency_s
        (the latency timer fires per slot, oldest-first semantics)."""
        with self._lock:
            return [k for k, v in self._slots.items()
                    if v and now - v[0][2] >= self.max_latency_s]

    def take(self, key):
        """Remove and return a slot's queued entries."""
        with obs_trace.span("serve.take", slot=key) as sp:
            with self._lock:
                entries = self._slots.pop(key, [])
                if sp is not obs_trace.NOOP_SPAN:  # attrs cost only when tracing
                    sp.set(n=len(entries),
                           queued=sum(len(v)
                                      for v in self._slots.values()))
                return entries

    def pending_keys(self):
        with self._lock:
            return [k for k, v in self._slots.items() if v]
