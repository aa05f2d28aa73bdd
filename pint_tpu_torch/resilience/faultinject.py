"""Deterministic fault injection (the JAX package's
``resilience/faultinject.py``).

The failure modes the serving and fitting paths handle (poisoned TOAs,
transient compile failures, slow dispatches, solver divergence, a
wedged flusher, an overflowing intake) cannot be produced
deterministically by normal inputs, so this registry gives each one a
NAMED injection point with seeded, countable trigger semantics:
production code calls :func:`fire` (or :func:`fire_kill`) at the site
where the real fault would surface, and tests arm points with
:func:`inject` (or the ``PINT_TPU_FAULTS`` env spec, the JAX package's
name, read once at import by :func:`arm_from_env`) to make the fault
happen on demand.

:data:`POINTS` names every point of the JAX package, so a spec written
for it parses here. The port's sites:

- ``toa_nan`` / ``toa_inf_error`` — a request arrives with a NaN TOA
  value / a non-finite uncertainty (``serve.engine.ServeEngine.submit``
  intake, on a deep copy of the request; payload ``index``).
- ``compile_fail`` — a failed capture of a cold slot's program
  (``serve.engine`` cold flush; payload ``retryable``, True unless
  given).
- ``dispatch_slow`` — a slow dispatch (``serve.engine`` flush, before
  the run; payload ``delay_s``).
- ``solver_diverge`` — an incremental lane solve is treated as
  non-finite (``serve.streaming.StreamingRefitter.append``): the lane
  quarantines the result and escalates to a full refit; in a batch fit
  (``parallel.pta.PTABatch``'s finalize) the payload's ``lanes`` get a
  NaN chi2 and are isolated as diverged.
- ``straggler_delay`` — one bucket's dispatch runs late without
  failing (the pipelined fleet executor's per-bucket dispatch loop,
  ``parallel.pta.PTAFleet._fit_pipelined``). Payload ``delay_s`` sets
  the injected stall, ``lane`` pins the slow bucket index.
- ``flusher_stall`` — the async front door's flusher wedges at its
  loop top, before any dequeue (``serve.frontdoor``; payload
  ``hang_s``): the watchdog must supersede and restart it.
- ``intake_overflow`` — the async front door refuses an accepted
  request as if the intake were full
  (``serve.frontdoor.AsyncServeEngine.submit``).
- ``process_kill`` — the serving process dies by SIGKILL at a named
  durability site (:func:`fire_kill` calls placed in ``serve.engine``
  — ``intake_append`` after a flush's pre-execution journal sync,
  ``pre_commit`` with results computed and none committed,
  ``post_commit`` after the commit sync —, ``serve.journal``
  (``mid_commit`` tears a commit frame), ``serve.excache``
  (``excache_store`` before a persisted entry's atomic publish),
  ``store.packstore`` (``store_write`` before the pack store's atomic
  publish), ``store.deltas`` (``append_delta_write`` before a delta
  segment's atomic publish) and ``serve.frontdoor`` (``flusher_take``
  right after the async flusher dequeues a request); payload ``at``
  pins one of :data:`KILL_SITES`, omitted means the first site
  reached). The process does not get to clean up — that is the
  point; recovery is proven by ``ServeEngine.recover`` afterwards.
- ``checkpoint_corrupt`` — a snapshot is damaged on disk after a save
  (``checkpoint.FitCheckpointer.save``).
- ``journal_torn_write`` — a journal append is torn mid-frame, as a
  power cut would leave it (``serve.journal`` frame writer; payload
  ``frac`` sets the fraction of the frame that lands). The reader must
  truncate-and-replay, never crash.
- ``executable_cache_corrupt`` — a persisted entry's bytes are damaged
  on disk after the store (``serve.excache`` persistent tier). The
  loader must warn and capture anew, never crash.

``device_loss`` and ``collective_timeout`` have no site in the port
yet: their modules wait with multi-device (ROADMAP §1 item 2).
Disarmed sites cost one falsy-dict check.
"""

from __future__ import annotations

import os
import signal
from contextlib import contextmanager

import numpy as np

POINTS = ("toa_nan", "toa_inf_error", "compile_fail", "dispatch_slow",
          "solver_diverge", "checkpoint_corrupt", "device_loss",
          "collective_timeout", "straggler_delay", "process_kill",
          "journal_torn_write", "executable_cache_corrupt",
          "flusher_stall", "intake_overflow")

# named durability sites where an armed ``process_kill`` can SIGKILL
# the serving process (see fire_kill). Each is a distinct point in the
# journal/commit/cache protocol with a distinct recovery obligation;
# the chaos harness kills at every one of them. ``flusher_take`` is
# the async front door's flusher-death leg: the worker dies with a
# request dequeued but nothing flushed or committed.
KILL_SITES = ("intake_append", "pre_commit", "mid_commit",
              "post_commit", "excache_store", "store_write",
              "append_delta_write", "flusher_take")

# the device-level failure domain: points that model a chip / lane
# dying, hanging, or straggling rather than a bad request
DEVICE_POINTS = ("device_loss", "collective_timeout", "straggler_delay")


class FaultInjected(RuntimeError):
    """Raised at sites whose fault effect is an exception (e.g.
    ``compile_fail``). ``retryable`` steers the serve retry policy:
    True models a transient failure, False a persistent one."""

    def __init__(self, point, retryable=True, detail=None):
        super().__init__(f"injected fault: {point}")
        self.point = point
        self.retryable = bool(retryable)
        self.detail = dict(detail or {})


class FaultPoint:
    """One armed injection point.

    rate: per-eligibility-check fire probability (seeded rng, so the
        fire pattern is a pure function of (seed, check sequence)).
    count: cap on total fires (None = unlimited) — ``count=1`` models
        a transient fault that a retry survives.
    after: skip the first ``after`` eligibility checks (lets a fault
        land mid-stream instead of on the first request).
    payload: site-interpreted detail merged into :func:`fire`'s return
        (e.g. ``{"lanes": [1]}`` for solver_diverge, ``{"delay_s":
        0.5}`` for dispatch_slow, ``{"retryable": False}`` for
        compile_fail).
    """

    def __init__(self, name, rate=1.0, count=None, after=0, seed=0,
                 payload=None):
        if name not in POINTS:
            raise ValueError(f"unknown fault point {name!r}; "
                             f"known points: {POINTS}")
        self.name = name
        self.rate = float(rate)
        self.count = None if count is None else int(count)
        self.after = int(after)
        self.seed = int(seed)
        self.payload = dict(payload or {})
        self.rng = np.random.default_rng(self.seed)
        self.checks = 0
        self.fires = 0

    def should_fire(self):
        """Advance the deterministic trigger state by one eligibility
        check. The rng draw happens on every eligible check (fired or
        not), so the fire PATTERN over a request stream depends only
        on the seed, not on unrelated control flow."""
        self.checks += 1
        if self.checks <= self.after:
            return False
        if self.count is not None and self.fires >= self.count:
            return False
        if self.rate < 1.0 and float(self.rng.random()) >= self.rate:
            return False
        self.fires += 1
        return True


# name -> FaultPoint; empty in production (fire() is then one falsy
# check)
_armed: dict = {}

# observers called with (name, payload) on every actual firing — the
# obs flight recorder subscribes here so chaos dumps can name the
# fault that started the cascade. Faults are rare, so the per-fire
# fan-out costs nothing on the happy path; this module never imports
# obs (the dependency arrow stays obs -> resilience).
_observers: list = []


def add_observer(fn):
    """Subscribe ``fn(name, payload_dict)`` to fault firings."""
    if fn not in _observers:
        _observers.append(fn)
    return fn


def fire(name, **ctx):
    """The hook production code calls at an injection site. Returns
    None when the point is disarmed or its trigger says "not this
    time"; otherwise a dict of the point's payload merged with the
    site's ``ctx`` (plus ``point`` and the 1-based ``fire`` ordinal).
    """
    if not _armed:
        return None
    pt = _armed.get(name)
    if pt is None or not pt.should_fire():
        return None
    payload = {**pt.payload, **ctx, "point": name, "fire": pt.fires}
    for ob in _observers:
        ob(name, payload)
    return payload


def kill_armed_at(site):
    """True when an armed ``process_kill`` point targets ``site`` —
    its ``at`` payload matches (or is omitted). A pure peek: trigger
    state (checks/count/rng) does not advance, so call sites can
    stage a torn write before dying without consuming a fire on
    mismatched sites."""
    pt = _armed.get("process_kill")
    if pt is None:
        return False
    at = pt.payload.get("at")
    return at is None or at == site


def fire_kill(site, **ctx):
    """SIGKILL this process at a named durability site when an armed
    ``process_kill`` point targets it. SIGKILL cannot be caught: no
    atexit hooks, no finally blocks, no flushes run — exactly the
    crash the journal's recovery contract must survive. Returns False
    (site disarmed / wrong site / trigger said not this time);
    on an actual fire the call never returns."""
    if not kill_armed_at(site):
        return False
    if fire("process_kill", site=site, **ctx) is None:
        return False
    os.kill(os.getpid(), signal.SIGKILL)
    return True  # not reached: SIGKILL terminates before returning


def armed():
    """Read-only view of the currently armed points."""
    return dict(_armed)


def arm(point: FaultPoint):
    """Arm one point (replacing any armed point of the same name)."""
    _armed[point.name] = point
    return point


def disarm(name=None):
    """Disarm one point, or everything when name is None."""
    if name is None:
        _armed.clear()
    else:
        _armed.pop(name, None)


@contextmanager
def inject(*points):
    """Arm FaultPoints (or bare point names, meaning fire-always) for
    the duration of the block, restoring the previous arming after::

        with inject(FaultPoint("toa_nan", rate=0.05, seed=7)):
            engine.run_stream(requests)
    """
    before = dict(_armed)
    try:
        for p in points:
            arm(p if isinstance(p, FaultPoint) else FaultPoint(p))
        yield _armed
    finally:
        _armed.clear()
        _armed.update(before)


def parse_spec(spec):
    """Parse a ``PINT_TPU_FAULTS`` spec string into FaultPoints.

    Grammar: ``point[:key=value[,key=value...]][;point...]`` with keys
    rate/count/after/seed/delay_s/retryable/lanes — unknown keys land
    in the payload. Example::

        PINT_TPU_FAULTS="toa_nan:rate=0.05,seed=7;compile_fail:count=1"
    """
    points = []
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition(":")
        kw = {"rate": 1.0, "count": None, "after": 0, "seed": 0}
        payload = {}
        for item in rest.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            k = k.strip()
            v = v.strip()
            if k in ("rate",):
                kw[k] = float(v)
            elif k in ("count", "after", "seed"):
                kw[k] = int(v)
            elif k == "lanes":
                payload[k] = [int(x) for x in v.split("+")]
            elif k == "lane":
                # device-level points address one DeviceLane by index
                payload[k] = int(v)
            elif k == "retryable":
                payload[k] = v.lower() in ("1", "true", "yes")
            else:
                try:
                    payload[k] = float(v)
                except ValueError:
                    payload[k] = v
        points.append(FaultPoint(name.strip(), payload=payload, **kw))
    return points


def arm_from_env(env="PINT_TPU_FAULTS"):
    """Arm every point named in the env var (no-op when unset).
    Called once at package import so ``PINT_TPU_FAULTS=... python
    -m pint_tpu_torch.scripts.pint_serve_bench`` injects without code
    changes; returns the armed points."""
    spec = os.environ.get(env)
    if not spec:
        return []
    return [arm(p) for p in parse_spec(spec)]
