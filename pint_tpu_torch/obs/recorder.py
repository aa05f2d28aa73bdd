"""Flight recorder: a bounded ring of recent fault-point firings and
resilience events, dumpable to JSON on disaster (the JAX package's
``obs/recorder.py``).

The recorder answers the post-mortem question a live metrics snapshot
cannot: *what was happening right before the fit went wrong?* It is
always on (fault firings and resilience events are rare, so recording
them costs nothing on the happy path). When an anomaly fires — in the
port, a diverged pulsar that the fit-quality probes isolate
(``fitquality.record_fit_batch``) — the owning site calls
:meth:`FlightRecorder.dump` and the ring is written to
``<dump_dir>/flight_<seq>_<reason>.json`` (no-op when no dump dir is
configured, so tests and production opt in via :func:`configure` or
the ``PINT_TPU_FLIGHT_DIR`` env var, the JAX package's name). The dump
directory is rotated: at most ``max_dumps`` files are kept (oldest
deleted first; default 32, ``PINT_TPU_FLIGHT_MAX`` env override, <= 0
disables rotation).
"""

from __future__ import annotations

import itertools
import json
import os
import threading

from . import clock as obs_clock


class FlightRecorder:
    def __init__(self, capacity=512, dump_dir=None, max_dumps=None):
        import collections

        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=capacity)
        self._dump_seq = itertools.count(1)
        self.dump_dir = dump_dir
        if max_dumps is None:
            try:
                max_dumps = int(os.environ.get("PINT_TPU_FLIGHT_MAX",
                                               32))
            except ValueError:
                max_dumps = 32
        self.max_dumps = max_dumps
        self.dumps = []           # paths written this process

    # -- event intake --------------------------------------------------

    def note_span(self, rec):
        """Called by a tracer for every finished span (the JAX
        package's tracer; the port's spans are not ported yet)."""
        with self._lock:
            self._events.append({"kind": "span", **rec})

    def note_fault(self, name, payload):
        """faultinject observer: every fired injection point lands
        here with its merged payload, so a dump can name the fault
        that started the cascade."""
        with self._lock:
            self._events.append({"kind": "fault", "point": name,
                                 "ts": obs_clock.now(),
                                 "ctx": _jsonable(payload)})

    def note(self, what, **ctx):
        """Generic resilience event (an anomaly, a quarantine, an SLO
        alert...)."""
        with self._lock:
            self._events.append({"kind": "event", "what": what,
                                 "ts": obs_clock.now(),
                                 **_jsonable(ctx)})

    # -- inspection / dumping ------------------------------------------

    def events(self):
        with self._lock:
            return list(self._events)

    def dump(self, reason, **ctx):
        """Write the ring to a JSON file and return its path (None
        when no dump dir is configured — the triggering event is still
        recorded in the ring either way)."""
        self.note("dump", reason=reason, **ctx)
        ddir = self.dump_dir
        if not ddir:
            return None
        from . import metricsreg

        with self._lock:
            seq = next(self._dump_seq)
            events = list(self._events)
        doc = {
            "reason": reason,
            "context": _jsonable(ctx),
            "walltime": obs_clock.walltime(),
            "events": events,
            "metrics": metricsreg.REGISTRY.snapshot(),
        }
        from ..durable import atomic_write_text

        os.makedirs(ddir, exist_ok=True)
        path = os.path.join(ddir, "flight_%03d_%s.json" % (seq, reason))
        # atomic publish: a flight dump is written BECAUSE something
        # is going wrong — a half-written post-mortem is worthless
        atomic_write_text(path, json.dumps(doc, indent=1, default=str))
        with self._lock:
            self.dumps.append(path)
        self._rotate(ddir)
        return path

    def _rotate(self, ddir):
        """Cap on-disk dump count at ``max_dumps`` (oldest deleted;
        the zero-padded sequence makes lexical order dump order;
        max_dumps <= 0 disables rotation). A failing fleet can dump on
        every refit — without a cap that fills the artifact volume
        before the post-mortem starts."""
        limit = self.max_dumps
        if not limit or limit <= 0:
            return
        try:
            existing = sorted(
                f for f in os.listdir(ddir)
                if f.startswith("flight_") and f.endswith(".json"))
        except OSError:
            return
        for stale in existing[:-limit] if len(existing) > limit else []:
            path = os.path.join(ddir, stale)
            try:
                os.remove(path)
            except OSError:
                continue
            with self._lock:
                if path in self.dumps:
                    self.dumps.remove(path)

    def reset(self):
        with self._lock:
            self._events.clear()
            self.dumps = []


def _jsonable(obj):
    """Best-effort JSON-safe copy of a payload dict (fault payloads
    may carry numpy scalars or arbitrary site context)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    try:                       # numpy scalars and friends
        return obj.item()
    except Exception:
        return repr(obj)


RECORDER = FlightRecorder(dump_dir=os.environ.get("PINT_TPU_FLIGHT_DIR"))


def configure(dump_dir=None, capacity=None, max_dumps=None):
    """Point the process flight recorder at a dump directory (and
    optionally resize its ring / cap its on-disk dump count).
    Returns the recorder."""
    import collections

    rec = RECORDER
    if dump_dir is not None:
        rec.dump_dir = dump_dir
    if capacity is not None:
        with rec._lock:
            rec._events = collections.deque(rec._events,
                                            maxlen=capacity)
    if max_dumps is not None:
        rec.max_dumps = max_dumps
    return rec


def _install_fault_hook():
    """Subscribe the recorder to every fault-point firing. Import-time
    one-shot; faultinject never imports obs, so the dependency arrow
    stays obs -> resilience."""
    from ..resilience import faultinject

    faultinject.add_observer(RECORDER.note_fault)


_install_fault_hook()
