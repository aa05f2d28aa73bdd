"""Drift sentinels: EWMA/CUSUM change detection (the JAX package's
``obs/drift.py``: EWMA, CUSUM and DriftSentinel).

A series that should be *boring* — the standardized mean whitened
residual of each batch a streaming lane appends, or the fitted
parameters, uncertainties and reduced chi2 of a pulsar the serve engine
refits again and again — is watched by an :class:`EWMA`, which tracks
its running baseline (mean + variance), and a :class:`CUSUM`, which
accumulates standardized deviations, so that both sudden steps (one big
z) and slow simmer (many small same-signed z's) trip an alarm.

:class:`DriftBoard` keeps one sentinel per (pulsar, probe) series of
successive refits. Each alarm names the pulsar, the probe, the baseline
it drifted from, and the observed value; it increments the fit-quality
ledger's ``drift_alarms`` counter (the ``fitq_drift`` SLO numerator)
and dumps a ``reason="fit_anomaly"`` flight record.

Checkpoint semantics: a board survives serve ``state_dict`` /
``load_state_dict`` round-trips by serializing the EWMA baselines but
deliberately NOT the CUSUM accumulators — a restart re-anchors detection
at the learned baselines with zeroed accumulators, so a restore
mid-simmer never replays half-accumulated evidence into a spurious
alarm storm. A *real* persisting drift re-accumulates within ``~h/k``
rounds.
"""

from __future__ import annotations

import math
import threading

from . import recorder as obs_recorder


class EWMA:
    """Exponentially-weighted running mean/variance of one series.

    ``update(x)`` returns ``(z, ready)``: the standardized deviation
    of ``x`` against the *pre-update* baseline (None until ``min_n``
    warmup observations), then folds ``x`` in. The sigma carries a
    relative floor so a bitwise-constant series doesn't collapse to
    zero variance and alarm on the first ulp of float noise."""

    def __init__(self, alpha=0.2, min_n=8, rel_floor=1e-9):
        self.alpha = float(alpha)
        self.min_n = int(min_n)
        self.rel_floor = float(rel_floor)
        self.mean = None
        self.var = 0.0
        self.n = 0

    def sigma(self):
        if self.mean is None:
            return None
        return (math.sqrt(max(self.var, 0.0))
                + self.rel_floor * (abs(self.mean) + 1e-300))

    def update(self, x):
        x = float(x)
        z = None
        if self.n >= self.min_n:
            z = (x - self.mean) / self.sigma()
        if self.mean is None:
            self.mean = x
        else:
            delta = x - self.mean
            # West-style EW moments: variance first (it uses the old
            # mean's delta), then the mean
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * delta * delta)
            self.mean += self.alpha * delta
        self.n += 1
        return z, z is not None


class CUSUM:
    """Two-sided standardized CUSUM: ``S+ = max(0, S+ + z - k)``,
    ``S- = max(0, S- - z - k)``; fires when either exceeds ``h``.
    ``k`` is the per-step drift allowance (in sigmas), ``h`` the
    accumulated-evidence threshold."""

    def __init__(self, k=0.5, h=6.0):
        self.k = float(k)
        self.h = float(h)
        self.pos = 0.0
        self.neg = 0.0

    def update(self, z):
        self.pos = max(0.0, self.pos + z - self.k)
        self.neg = max(0.0, self.neg - z - self.k)
        return self.pos > self.h or self.neg > self.h

    def reset(self):
        self.pos = 0.0
        self.neg = 0.0


class DriftSentinel:
    """One watched series: EWMA baseline + CUSUM accumulator + an
    immediate trip on a single huge step (``|z| >= z_trip``). On
    alarm the CUSUM resets (one alarm per episode, not one per
    round) while the EWMA keeps adapting toward the new level."""

    KIND = "DriftSentinel"
    VERSION = 1

    def __init__(self, alpha=0.2, min_n=8, k=0.5, h=6.0, z_trip=8.0):
        self.ewma = EWMA(alpha=alpha, min_n=min_n)
        self.cusum = CUSUM(k=k, h=h)
        self.z_trip = float(z_trip)
        self.alarms = 0

    def observe(self, x):
        """Feed one observation; returns an alarm dict or None."""
        baseline = self.ewma.mean
        z, ready = self.ewma.update(x)
        if not ready:
            return None
        fired = self.cusum.update(z) or abs(z) >= self.z_trip
        if not fired:
            return None
        self.alarms += 1
        alarm = {"baseline": baseline, "observed": float(x),
                 "z": round(z, 3), "cusum_pos": round(self.cusum.pos, 3),
                 "cusum_neg": round(self.cusum.neg, 3),
                 "n": self.ewma.n}
        self.cusum.reset()
        return alarm

    def state_dict(self):
        """Versioned state. The CUSUM accumulators are deliberately
        absent: restore re-anchors at the learned baseline with zero
        accumulated evidence (no post-restart alarm storm)."""
        return {"kind": self.KIND, "version": self.VERSION,
                "alpha": self.ewma.alpha, "min_n": self.ewma.min_n,
                "rel_floor": self.ewma.rel_floor,
                "mean": self.ewma.mean, "var": self.ewma.var,
                "n": self.ewma.n, "k": self.cusum.k, "h": self.cusum.h,
                "z_trip": self.z_trip, "alarms": self.alarms}

    def load_state_dict(self, state):
        if (state.get("kind") != self.KIND
                or state.get("version") != self.VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.KIND, self.VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        self.ewma = EWMA(alpha=state["alpha"], min_n=state["min_n"],
                         rel_floor=state.get("rel_floor", 1e-9))
        self.ewma.mean = state["mean"]
        self.ewma.var = float(state["var"])
        self.ewma.n = int(state["n"])
        self.cusum = CUSUM(k=state["k"], h=state["h"])
        self.z_trip = float(state["z_trip"])
        self.alarms = int(state.get("alarms", 0))


class DriftBoard:
    """Per-(pulsar, probe) drift sentinels over successive refits.

    ``observe(pulsar, values)`` feeds a dict of probe -> value for
    one refit and returns the alarms it raised; every alarm lands in
    the fit-quality ledger (``drift_alarms``) and — when a flight
    dump dir is configured — a ``fit_anomaly`` dump naming pulsar,
    probe, baseline, and observed value. Thread-safe; series count is
    capped so an unbounded pulsar stream cannot grow host memory
    without bound."""

    KIND = "DriftBoard"
    VERSION = 1

    def __init__(self, alpha=0.2, min_n=8, k=0.5, h=6.0, z_trip=8.0,
                 max_series=8192, ledger=None, recorder=None):
        self._kw = {"alpha": alpha, "min_n": min_n, "k": k, "h": h,
                    "z_trip": z_trip}
        self.max_series = int(max_series)
        self.ledger = ledger
        self.recorder = recorder
        self._lock = threading.Lock()
        self._sentinels = {}
        self.dropped_series = 0
        self.alarms = 0

    def _ledger(self):
        if self.ledger is not None:
            return self.ledger
        from . import fitquality

        return fitquality.FITQ

    def _recorder(self):
        return (obs_recorder.RECORDER if self.recorder is None
                else self.recorder)

    def observe(self, pulsar, values, **context):
        """One refit's probe values for one pulsar; returns the list
        of alarm dicts raised (usually empty). Non-finite / missing
        values are skipped — a diverged lane is the divergence
        probe's business, not a drift observation."""
        pulsar = str(pulsar)
        alarms = []
        with self._lock:
            for probe in sorted(values):
                val = values[probe]
                if val is None:
                    continue
                val = float(val)
                if not math.isfinite(val):
                    continue
                key = (pulsar, probe)
                sent = self._sentinels.get(key)
                if sent is None:
                    if len(self._sentinels) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    sent = DriftSentinel(**self._kw)
                    self._sentinels[key] = sent
                alarm = sent.observe(val)
                if alarm is not None:
                    alarm.update(pulsar=pulsar, probe=probe)
                    alarms.append(alarm)
                    self.alarms += 1
        for alarm in alarms:
            self._ledger().note_drift_alarm(alarm["pulsar"],
                                            alarm["probe"])
            self._recorder().dump("fit_anomaly", source="drift",
                                  **alarm, **context)
        return alarms

    def snapshot(self):
        with self._lock:
            return {"series": len(self._sentinels),
                    "alarms": self.alarms,
                    "dropped_series": self.dropped_series}

    def state_dict(self):
        """Versioned, JSON-safe state: every sentinel's EWMA baseline
        (keys flattened to "pulsar\\x1fprobe") — CUSUM evidence is
        intentionally not carried (see module docstring)."""
        with self._lock:
            return {"kind": self.KIND, "version": self.VERSION,
                    "kw": dict(self._kw),
                    "max_series": self.max_series,
                    "alarms": self.alarms,
                    "dropped_series": self.dropped_series,
                    "sentinels": {
                        "\x1f".join(key): s.state_dict()
                        for key, s in self._sentinels.items()}}

    def load_state_dict(self, state):
        if (state.get("kind") != self.KIND
                or state.get("version") != self.VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.KIND, self.VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        with self._lock:
            self._kw = dict(state.get("kw", self._kw))
            self.max_series = int(state.get("max_series",
                                            self.max_series))
            self.alarms = int(state.get("alarms", 0))
            self.dropped_series = int(state.get("dropped_series", 0))
            self._sentinels = {}
            for flat, sd in (state.get("sentinels") or {}).items():
                pulsar, _, probe = flat.partition("\x1f")
                sent = DriftSentinel(**self._kw)
                sent.load_state_dict(sd)
                self._sentinels[(pulsar, probe)] = sent


def fit_drift_values(x, sigma, reduced_chi2, names=None,
                     max_params=16):
    """The standard probe dict a serve refit feeds the board: fitted
    parameter values, their uncertainties, and the reduced chi2 —
    keyed ``param.<name>`` / ``sigma.<name>`` (index-keyed when no
    names are given), capped at ``max_params`` so a huge timing
    model doesn't explode the series count."""
    values = {"reduced_chi2": reduced_chi2}
    if x is not None:
        for j, xv in enumerate(list(x)[:max_params]):
            tag = (names[j] if names is not None and j < len(names)
                   else str(j))
            values["param.%s" % tag] = xv
            if sigma is not None and j < len(sigma):
                values["sigma.%s" % tag] = sigma[j]
    return values
