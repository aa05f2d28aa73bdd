"""Deterministic fault injection (the JAX package's
``resilience/faultinject.py``, for the sites the streaming path and the
fleet executor have).

The failure modes these paths handle cannot be produced
deterministically by normal inputs, so this registry gives each one a
NAMED injection point with seeded, countable trigger semantics:
production code calls :func:`fire` (or :func:`fire_kill`) at the site
where the real fault would surface, and tests arm points with
:func:`inject` to make the fault happen on demand.

Injection points of the port:

- ``solver_diverge`` — an incremental lane solve is treated as
  non-finite (``serve.streaming.StreamingRefitter.append``): the lane
  quarantines the result and escalates to a full refit; in a batch fit
  (``parallel.pta.PTABatch``'s finalize) the payload's ``lanes`` get a
  NaN chi2 and are isolated as diverged.
- ``straggler_delay`` — one bucket's dispatch runs late without
  failing (the pipelined fleet executor's per-bucket dispatch loop,
  ``parallel.pta.PTAFleet._fit_pipelined``). Payload ``delay_s`` sets
  the injected stall, ``lane`` pins the slow bucket index.
- ``process_kill`` — the process dies by SIGKILL at a named durability
  site (:func:`fire_kill`); the port's one site is
  ``append_delta_write``, just before a delta segment's atomic publish
  (``store.deltas.DeltaStore.append``). Payload ``at`` pins the site.

Disarmed sites cost one falsy-dict check.
"""

from __future__ import annotations

import os
import signal
from contextlib import contextmanager

import numpy as np

POINTS = ("solver_diverge", "straggler_delay", "process_kill")


class FaultPoint:
    """One armed injection point.

    rate: per-eligibility-check fire probability (seeded rng, so the
        fire pattern is a pure function of (seed, check sequence)).
    count: cap on total fires (None = unlimited) — ``count=1`` models
        a transient fault that a retry survives.
    after: skip the first ``after`` eligibility checks (lets a fault
        land mid-stream instead of on the first request).
    payload: site-interpreted detail merged into :func:`fire`'s return
        (e.g. ``{"at": "append_delta_write"}`` for process_kill).
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

# observers called with (name, payload) on every actual firing: the obs
# flight recorder subscribes here so a dump can name the fault that
# started the cascade. This module never imports obs (the dependency
# arrow stays obs -> resilience).
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


def fire_kill(site, **ctx):
    """SIGKILL this process at a named durability site when an armed
    ``process_kill`` point targets it (its ``at`` payload matches or is
    omitted). SIGKILL cannot be caught: no atexit hooks, no finally
    blocks, no flushes run. Returns False when the site is disarmed,
    another site is targeted or the trigger says not this time; on an
    actual fire the call never returns."""
    pt = _armed.get("process_kill")
    if pt is None or pt.payload.get("at") not in (None, site):
        return False
    if fire("process_kill", site=site, **ctx) is None:
        return False
    os.kill(os.getpid(), signal.SIGKILL)
    return True  # not reached: SIGKILL terminates before returning


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

        with inject(FaultPoint("solver_diverge", count=1)):
            refitter.append(model, toas)
    """
    before = dict(_armed)
    try:
        for p in points:
            arm(p if isinstance(p, FaultPoint) else FaultPoint(p))
        yield _armed
    finally:
        _armed.clear()
        _armed.update(before)
