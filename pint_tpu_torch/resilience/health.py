"""Engine health state machine: healthy -> degraded -> draining (the
JAX package's ``resilience/health.py``).

A serving engine needs one word that load balancers / operators can
act on, computed from the failure signals the resilience layer
already tracks:

- breaker state (``retry.CircuitBreaker``): any open breaker means a
  slot's traffic is being rejected -> at least degraded; several open
  at once means the engine is structurally unable to serve ->
  draining.
- service-side shed/error rate over a sliding request window: above
  ``degraded_shed_rate`` -> degraded, above ``draining_shed_rate`` ->
  draining. Client-input rejections (nonfinite_input) deliberately do
  NOT count: a garbage request is the client's fault and must not
  mark a correctly-rejecting engine unhealthy.
- flush-latency watchdog: a flush exceeding ``flush_watchdog_s``
  (wedge-shaped latency) -> degraded.

Transitions are re-evaluated on every note_* call against the
injected clock, so tests drive the machine deterministically with a
fake clock. Recovery is hysteretic: leaving degraded requires the
signals clear AND ``recovery_s`` of quiet; draining additionally
requires every breaker closed. While draining, the engine sheds new
submits ("draining" rejections are excluded from the shed-rate window
so the state can actually recover).
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import deque

STATES = ("healthy", "degraded", "draining")

# version stamp for HealthMonitor.state_dict snapshots (see
# retry.STATE_VERSION for the convention)
STATE_VERSION = 1


class HealthMonitor:
    def __init__(self, clock=time.monotonic, window=64, min_events=8,
                 degraded_shed_rate=0.2, draining_shed_rate=0.6,
                 draining_open_breakers=2, flush_watchdog_s=5.0,
                 recovery_s=30.0):
        self.clock = clock
        self.window = int(window)
        self.min_events = int(min_events)
        self.degraded_shed_rate = float(degraded_shed_rate)
        self.draining_shed_rate = float(draining_shed_rate)
        self.draining_open_breakers = int(draining_open_breakers)
        self.flush_watchdog_s = float(flush_watchdog_s)
        self.recovery_s = float(recovery_s)
        self._lock = threading.RLock()
        self.state = "healthy"
        self.since = clock()
        self.reasons = []
        self._events = deque(maxlen=self.window)  # 1 = service-side bad
        self._open_breakers = 0
        self._breaker_trips = 0
        self._watchdog_breaches = 0
        self._last_breach_t = None
        self._last_reason_t = None

    # -- signal intake ----------------------------------------------

    def note_request(self, status, reason=None):
        """One finished request. "shed"/"error" count against the
        engine; "rejected" counts only for service-side reasons
        (circuit_open, quarantine) — nonfinite_input and draining are
        the client's/operator's doing."""
        bad = status in ("shed", "error") or (
            status == "rejected"
            and reason not in ("nonfinite_input", "draining"))
        with self._lock:
            self._events.append(1 if bad else 0)
            self._evaluate_locked()

    def note_flush(self, wall_s):
        """Flush wall time for the latency watchdog."""
        with self._lock:
            if wall_s > self.flush_watchdog_s:
                self._watchdog_breaches += 1
                self._last_breach_t = self.clock()
            self._evaluate_locked()

    def note_breakers(self, open_count, tripped=False):
        """Breaker census from the engine (after record_*)."""
        with self._lock:
            self._open_breakers = int(open_count)
            if tripped:
                self._breaker_trips += 1
            self._evaluate_locked()

    # -- evaluation --------------------------------------------------

    def shed_rate(self):
        with self._lock:
            if len(self._events) < self.min_events:
                return 0.0
            return sum(self._events) / len(self._events)

    def _current_reasons(self, now):
        reasons = []
        sr = self.shed_rate()
        if self._open_breakers >= self.draining_open_breakers:
            reasons.append("breakers_open")
        elif self._open_breakers:
            reasons.append("breaker_open")
        if sr >= self.draining_shed_rate:
            reasons.append("shed_rate_critical")
        elif sr >= self.degraded_shed_rate:
            reasons.append("shed_rate")
        if (self._last_breach_t is not None
                and now - self._last_breach_t < self.recovery_s):
            reasons.append("flush_watchdog")
        return reasons

    def _evaluate_locked(self):
        # caller holds self._lock (note_* / snapshot take it; the
        # serve engine's flush worker and submitter threads both land
        # here)
        now = self.clock()
        reasons = self._current_reasons(now)
        severe = ("breakers_open" in reasons
                  or "shed_rate_critical" in reasons)
        if reasons:
            self._last_reason_t = now
        target = self.state
        if severe:
            target = "draining"
        elif reasons:
            # draining is sticky until every breaker closes AND the
            # quiet period elapses; lesser signals keep it degraded
            # only if we weren't draining
            target = "draining" if self.state == "draining" else "degraded"
        else:
            # recovery hysteresis: require recovery_s of quiet
            quiet = (self._last_reason_t is None
                     or now - self._last_reason_t >= self.recovery_s)
            if self.state == "draining":
                target = "degraded" if quiet and not self._open_breakers \
                    else "draining"
            elif self.state == "degraded" and quiet:
                target = "healthy"
        if target != self.state:
            self.state = target
            self.since = now
        self.reasons = reasons

    # -- export ------------------------------------------------------

    def snapshot(self):
        """JSON-safe health block for ServeTelemetry.snapshot / bench
        JSON."""
        with self._lock:
            now = self.clock()
            self._evaluate_locked()
            return {
                "state": self.state,
                "since_s": round(now - self.since, 6),
                "reasons": list(self.reasons),
                "shed_rate": round(self.shed_rate(), 4),
                "open_breakers": self._open_breakers,
                "breaker_trips": self._breaker_trips,
                "watchdog_breaches": self._watchdog_breaches,
            }

    # -- checkpoint serialization -----------------------------------

    def state_dict(self):
        """JSON-safe full monitor state for checkpointing. Clock-based
        fields (since, last breach/reason times) serialize as
        seconds-AGO relative to the monitor's own clock; restore
        re-anchors them on the restoring clock, so hysteresis windows
        survive a process restart on a different monotonic epoch."""
        with self._lock:
            now = self.clock()

            def ago(t):
                return None if t is None else max(0.0, now - t)

            return {"version": STATE_VERSION, "kind": "health_monitor",
                    "state": self.state,
                    "since_ago_s": max(0.0, now - self.since),
                    "reasons": list(self.reasons),
                    "events": [int(e) for e in self._events],
                    "open_breakers": int(self._open_breakers),
                    "breaker_trips": int(self._breaker_trips),
                    "watchdog_breaches": int(self._watchdog_breaches),
                    "last_breach_ago_s": ago(self._last_breach_t),
                    "last_reason_ago_s": ago(self._last_reason_t)}

    def load_state_dict(self, state):
        """Restore a state_dict() snapshot (a restarted process keeps
        its degraded/draining standing and recovery hysteresis).
        Warns and leaves the monitor reset on a version/kind or state
        mismatch. Returns True when state was applied."""
        if (not isinstance(state, dict)
                or state.get("kind") != "health_monitor"
                or int(state.get("version", -1)) != STATE_VERSION
                or state.get("state") not in STATES):
            got = (state.get("version")
                   if isinstance(state, dict) else type(state).__name__)
            warnings.warn(
                "HealthMonitor.load_state_dict: snapshot version/kind "
                f"mismatch (got {got!r}, want {STATE_VERSION}); "
                "resetting health state")
            return False

        with self._lock:
            now = self.clock()

            def at(ago):
                return None if ago is None else now - float(ago)

            self.state = str(state["state"])
            self.since = now - float(state.get("since_ago_s", 0.0))
            self.reasons = [str(r) for r in state.get("reasons", [])]
            self._events = deque(
                (1 if int(e) else 0 for e in state.get("events", [])),
                maxlen=self.window)
            self._open_breakers = int(state.get("open_breakers", 0))
            self._breaker_trips = int(state.get("breaker_trips", 0))
            self._watchdog_breaches = int(
                state.get("watchdog_breaches", 0))
            self._last_breach_t = at(state.get("last_breach_ago_s"))
            self._last_reason_t = at(state.get("last_reason_ago_s"))
        return True
