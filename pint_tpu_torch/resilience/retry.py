"""Retry with jittered exponential backoff + per-key circuit breaker
(the JAX package's ``resilience/retry.py``).

Two failure-handling primitives the serve engine composes:

- :class:`BackoffPolicy` / :func:`with_retries` — a transient
  compile/dispatch failure gets a bounded number of retries with
  exponentially growing, seeded-jittered sleeps (deterministic under a
  fixed seed, so tests can assert the exact delay sequence).
- :class:`CircuitBreaker` — a slot that keeps failing (or keeps
  recompiling when it should be warm) trips OPEN after ``threshold``
  consecutive failures; traffic to that slot is rejected with a
  structured reason instead of hanging the engine on a doomed flush.
  After ``cooldown_s`` one half-open trial is admitted; success closes
  the breaker, failure re-opens it.

The sleep function is injectable everywhere (tests drive a fake
clock); nothing here touches a device.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np

from .faultinject import FaultInjected

# version stamp for CircuitBreaker.state_dict snapshots; bump on any
# layout change so a restored foreign snapshot warns-and-resets
# instead of silently mis-restoring breaker state
STATE_VERSION = 1

# substrings of exception text that mark a failure as transient: the
# JAX package's list (runtime and transport statuses inside
# RuntimeErrors), kept as it is so both packages retry the same
# failures
TRANSIENT_MARKS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
                   "transient", "temporarily")


def is_retryable(exc):
    """Retry policy gate: injected faults carry an explicit flag;
    real exceptions are retryable only when they look like transient
    runtime/transport failures — a ValueError (bad request) or a
    structural failure must fail fast, not burn retries."""
    if isinstance(exc, FaultInjected):
        return exc.retryable
    if isinstance(exc, (TimeoutError, ConnectionError, OSError)):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        return any(m in msg for m in TRANSIENT_MARKS)
    return False


class BackoffPolicy:
    """Jittered exponential backoff schedule.

    delay(attempt) = min(max_s, base_s * factor**attempt) * jitter
    with jitter drawn uniformly from [1 - jitter_frac, 1 + jitter_frac)
    off a seeded rng — the full-jitter-style decorrelation that stops
    retry convoys, made deterministic so the chaos suite can assert
    the exact sequence.
    """

    def __init__(self, max_attempts=3, base_s=0.05, factor=2.0,
                 max_s=2.0, jitter_frac=0.5, seed=0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter_frac = float(jitter_frac)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)

    def delay(self, attempt):
        """Sleep seconds before retry number ``attempt`` (0-based).
        Consumes one rng draw per call — call exactly once per retry
        to keep the sequence reproducible."""
        raw = min(self.max_s, self.base_s * self.factor ** attempt)
        if self.jitter_frac <= 0.0:
            return raw
        u = float(self.rng.random())  # [0, 1)
        return raw * (1.0 - self.jitter_frac + 2.0 * self.jitter_frac * u)

    def delays(self, n=None):
        """The next ``n`` (default: retries remaining after the first
        attempt) delays, materialized — advances the rng."""
        n = self.max_attempts - 1 if n is None else int(n)
        return [self.delay(i) for i in range(n)]


def with_retries(fn, policy=None, sleep=time.sleep,
                 retryable=is_retryable, on_retry=None, trace_id=None):
    """Call ``fn()`` with up to ``policy.max_attempts`` attempts.
    Non-retryable exceptions (per ``retryable``) and the final
    attempt's exception propagate; ``on_retry(attempt, exc, delay_s)``
    is invoked before each backoff sleep (telemetry hook).

    ``trace_id`` threads an obs trace through the whole retry ladder:
    every attempt's span joins the caller's trace (rather than each
    re-run starting a fresh one), so a flight-recorder dump after a
    failed slot shows the original attempt and its retries as one
    timeline."""
    from ..obs import trace as obs_trace

    policy = policy or BackoffPolicy()
    for attempt in range(policy.max_attempts):
        try:
            with obs_trace.span("retry.attempt", trace_id=trace_id,
                                attempt=attempt):
                return fn()
        except Exception as e:
            last_attempt = attempt >= policy.max_attempts - 1
            if last_attempt or not retryable(e):
                raise
            d = policy.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, e, d)
            if d > 0:
                sleep(d)


class CircuitBreaker:
    """Per-key breaker over consecutive failures.

    States per key: "closed" (normal), "open" (rejecting), and
    "half_open" (cooldown elapsed; exactly one trial request is
    admitted — success closes, failure re-opens). Keys are the serve
    engine's slot keys, so one pathological request shape cannot take
    down the other slots' traffic.
    """

    def __init__(self, threshold=3, cooldown_s=30.0, clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.RLock()
        self._keys = {}  # key -> {consecutive, opened_at, trial}
        self.trips = 0

    def _entry_locked(self, key):
        # caller holds self._lock: the returned dict is live shared
        # state, mutated in place by record_* / allow / trip
        return self._keys.setdefault(
            key, {"consecutive": 0, "opened_at": None, "trial": False})

    def state(self, key):
        with self._lock:
            e = self._keys.get(key)
            if e is None or e["opened_at"] is None:
                return "closed"
            if self.clock() - e["opened_at"] >= self.cooldown_s:
                return "half_open"
            return "open"

    def allow(self, key):
        """May a request for ``key`` proceed right now? In half-open,
        only the first caller gets through (the trial); the rest stay
        rejected until the trial reports. The trial claim is
        check-then-set, so it must be atomic under the lock — without
        it two racing submitters both get the half-open trial."""
        with self._lock:
            s = self.state(key)
            if s == "closed":
                return True
            if s == "half_open":
                e = self._entry_locked(key)
                if not e["trial"]:
                    e["trial"] = True
                    return True
            return False

    def record_success(self, key):
        with self._lock:
            e = self._entry_locked(key)
            e["consecutive"] = 0
            e["opened_at"] = None
            e["trial"] = False

    def record_failure(self, key):
        """Returns True when THIS failure trips the breaker open (the
        caller counts trips / notifies health)."""
        with self._lock:
            e = self._entry_locked(key)
            e["consecutive"] += 1
            if e["opened_at"] is not None:
                # failed half-open trial: re-open with a fresh cooldown
                e["opened_at"] = self.clock()
                e["trial"] = False
                return False
            if e["consecutive"] >= self.threshold:
                e["opened_at"] = self.clock()
                e["trial"] = False
                self.trips += 1
                self._flight_dump(key, "failure_streak")
                return True
            return False

    def trip(self, key):
        """Force the breaker open for ``key`` without a consecutive
        failure streak — used for contract violations like repeated
        unexpected recompiles. Returns True when this call newly
        opened the breaker."""
        with self._lock:
            e = self._entry_locked(key)
            already_open = e["opened_at"] is not None
            e["opened_at"] = self.clock()
            e["trial"] = False
            if not already_open:
                self.trips += 1
                self._flight_dump(key, "forced")
                return True
            return False

    def _flight_dump(self, key, why):
        """Breaker trips are one of the flight recorder's auto-dump
        triggers: snapshot the recent span/fault ring the moment a
        slot goes dark, while the evidence is still in the ring.
        Lazy import keeps the resilience -> obs edge out of module
        import time (obs.recorder imports this package's faultinject)."""
        from ..obs import trace as obs_trace
        from ..obs.recorder import RECORDER

        RECORDER.dump("breaker_trip", key=str(key), why=why,
                      trips=self.trips,
                      trace=obs_trace.current_trace_id())

    def open_count(self):
        with self._lock:
            return sum(1 for k in self._keys if self.state(k) != "closed")

    def retry_after_s(self, key):
        """Seconds until ``key``'s cooldown elapses (0 when not open)."""
        with self._lock:
            e = self._keys.get(key)
            if e is None or e["opened_at"] is None:
                return 0.0
            return max(0.0,
                       self.cooldown_s - (self.clock() - e["opened_at"]))

    def snapshot(self):
        """JSON-safe counters for telemetry snapshots."""
        with self._lock:
            return {"trips": self.trips, "open": self.open_count(),
                    "tracked_keys": len(self._keys)}

    # -- checkpoint serialization -----------------------------------

    def state_dict(self):
        """JSON-safe full breaker state for checkpointing. opened_at
        is a monotonic-clock reading with no meaning in another
        process, so open keys serialize their REMAINING cooldown
        instead; restore re-anchors it on the restoring clock. Keys
        (serve slot tuples, lane tuples) ride as repr strings."""
        with self._lock:
            now = self.clock()
            keys = []
            for key, e in self._keys.items():
                remaining = None
                if e["opened_at"] is not None:
                    remaining = max(0.0,
                                    self.cooldown_s - (now - e["opened_at"]))
                keys.append([repr(key), int(e["consecutive"]),
                             remaining, bool(e["trial"])])
            return {"version": STATE_VERSION, "kind": "circuit_breaker",
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s,
                    "trips": int(self.trips), "keys": keys}

    def load_state_dict(self, state):
        """Restore a state_dict() snapshot so a restarted process does
        not forget tripped breakers. A version/kind mismatch (foreign
        or future snapshot) warns and leaves the breaker reset —
        guessing at another layout could silently mis-open or
        mis-close keys. Returns True when state was applied."""
        import ast

        if (not isinstance(state, dict)
                or state.get("kind") != "circuit_breaker"
                or int(state.get("version", -1)) != STATE_VERSION):
            got = (state.get("version")
                   if isinstance(state, dict) else type(state).__name__)
            warnings.warn(
                "CircuitBreaker.load_state_dict: snapshot version/kind "
                f"mismatch (got {got!r}, want {STATE_VERSION}); "
                "resetting breaker state")
            return False
        with self._lock:
            self._keys.clear()
            self.trips = int(state.get("trips", 0))
            now = self.clock()
            for rkey, consecutive, remaining, trial in state.get("keys", []):
                try:
                    # slot keys are tuples of str/int: repr round-trips
                    key = ast.literal_eval(rkey)
                except (ValueError, SyntaxError):
                    key = rkey
                opened_at = None
                if remaining is not None:
                    opened_at = now - (self.cooldown_s - float(remaining))
                self._keys[key] = {"consecutive": int(consecutive),
                                   "opened_at": opened_at,
                                   "trial": bool(trial)}
        return True
