"""Structured tracing spans with a thread-safe ring buffer (the JAX
package's ``obs/trace.py``).

Design constraints, in priority order:

1. **Off-by-default, near-zero disabled cost.** ``span(...)`` when
   tracing is disabled is one attribute check plus returning a shared
   no-op singleton — no allocation, no lock, no clock read. The
   instrumented hot paths (serve flush, fleet dispatch) pay nanoseconds
   per call site until someone turns tracing on.
2. **Numerics-neutral.** Spans only read the host clock and append to
   a host-side deque; they never touch device arrays, never force a
   sync, and never change control flow — so a traced fit is bitwise
   identical to an untraced one (tests/test_torch_serve.py pins this
   for a served stream).
3. **Thread-safe.** The fleet pipeline, concurrent prewarm, and the
   bench's daemon stage threads all emit spans; the ring buffer is
   lock-guarded and the parent/child nesting state is thread-local.

Profiler ranges: ``enable(jax_annotations=True)`` (the JAX package's
keyword) also opens a ``torch.profiler.record_function`` range per
span, so ``serve.pack``, ``serve.compile`` and ``serve.run`` show up
by name in a torch profile of the card; the flag turns itself off when
the profiler cannot open one.

Cross-thread traces: a worker thread has an empty span stack, so call
sites that fan out hand the child the parent's ``trace_id`` explicitly
(``span("fleet.compile", trace_id=tid, bucket=i)``) — the same id
threading the retry/bisect and work-steal paths use so a quarantined
bucket's whole recovery shares one trace.
"""

from __future__ import annotations

import itertools
import threading

from . import clock as obs_clock
from . import recorder


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "t0", "t1", "thread", "status", "_annot")

    def __init__(self, tracer, name, attrs, trace_id=None):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = None
        self.parent_id = None
        self.t0 = self.t1 = None
        self.thread = None
        self.status = "ok"
        self._annot = None

    def set(self, **attrs):
        """Attach/overwrite attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        parent = stack[-1] if stack else None
        if self.trace_id is None:
            self.trace_id = (parent.trace_id if parent is not None
                             else tr.new_trace_id())
        self.parent_id = parent.span_id if parent is not None else None
        self.span_id = tr.new_span_id()
        self.thread = threading.current_thread().name
        stack.append(self)
        if tr.jax_annotations:
            self._annot = tr._enter_annotation(self.name)
        self.t0 = tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = self.tracer.clock()
        if self._annot is not None:
            self._annot.__exit__(exc_type, exc, tb)
            self._annot = None
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", exc_type.__name__)
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:            # unbalanced exit; stay sane
            stack.remove(self)
        self.tracer._finish(self)
        return False

    def to_dict(self):
        return {"name": self.name, "trace": self.trace_id,
                "span": self.span_id, "parent": self.parent_id,
                "t0": self.t0, "t1": self.t1,
                "dur_s": (None if self.t1 is None or self.t0 is None
                          else self.t1 - self.t0),
                "thread": self.thread, "status": self.status,
                "attrs": dict(self.attrs)}


class Tracer:
    """Process-wide span collector: id mint + bounded span ring.

    ``enabled`` is the single flag the disabled fast path checks; the
    default capacity (8192 spans) bounds memory at roughly a few MB
    even under a long traced serve stream — older spans fall off the
    ring, which is the flight-recorder semantic we want anyway.
    """

    def __init__(self, capacity=8192, clock=obs_clock.now):
        import collections

        self.enabled = False
        self.jax_annotations = False
        self.clock = clock
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=capacity)
        self._trace_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._local = threading.local()

    # -- id mint / nesting state ---------------------------------------

    def new_trace_id(self):
        with self._lock:
            return "t%06d" % next(self._trace_ids)

    def new_span_id(self):
        with self._lock:
            return next(self._span_ids)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- lifecycle -----------------------------------------------------

    def _finish(self, sp):
        rec = sp.to_dict()
        with self._lock:
            self._spans.append(rec)
        recorder.RECORDER.note_span(rec)

    def _enter_annotation(self, name):
        """Open a ``torch.profiler.record_function`` range named after
        the span (closed at the span's exit)."""
        try:
            import torch

            annot = torch.profiler.record_function(name)
            annot.__enter__()
            return annot
        except Exception:
            with self._lock:
                self.jax_annotations = False   # no profiler ranges here
            return None

    # -- inspection ----------------------------------------------------

    def snapshot(self):
        """List of finished-span dicts, oldest first."""
        with self._lock:
            return list(self._spans)

    def reset(self):
        with self._lock:
            self._spans.clear()


TRACER = Tracer()


def span(name, trace_id=None, **attrs):
    """Open a tracing span (context manager). Near-free when tracing
    is disabled; pass ``trace_id=`` to adopt a trace started on
    another thread (fleet workers, retry re-runs)."""
    tr = TRACER
    if not tr.enabled:
        return NOOP_SPAN
    return Span(tr, name, attrs, trace_id=trace_id)


def current_trace_id():
    """Trace id of the innermost open span on this thread, or None.
    Cheap enough to call unconditionally — call sites hand it to
    worker threads / retry loops to keep one logical operation on one
    trace."""
    stack = getattr(TRACER._local, "stack", None)
    return stack[-1].trace_id if stack else None


def enable(capacity=None, jax_annotations=False):
    """Turn span collection on (optionally resizing the ring);
    ``jax_annotations`` also opens a torch profiler range per span."""
    import collections

    tr = TRACER
    if capacity is not None:
        with tr._lock:
            tr._spans = collections.deque(tr._spans, maxlen=capacity)
    tr.jax_annotations = bool(jax_annotations)
    tr.enabled = True
    return tr


def disable():
    TRACER.enabled = False
    TRACER.jax_annotations = False
    return TRACER


def enabled():
    return TRACER.enabled


def spans():
    return TRACER.snapshot()


def reset():
    TRACER.reset()
